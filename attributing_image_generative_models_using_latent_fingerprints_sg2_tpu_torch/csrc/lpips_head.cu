// The solver's LPIPS distance head, NHWC float32 and bfloat16, one launch each way:
//
//   forward   d[s, n] = mean_hw sum_c lin_c (normalize(f[s, n]) - t[s, n])^2
//   backward  df[s, n] = d d[s, n] / d f[s, n] * g[s, n]   (t and lin constants)
//
// Replaces no Pallas kernel: the JAX package leaves this head to XLA, which fuses
// losses/lpips.py:353 `_fused_slice_distance` (its value `_fsd_value` and its
// hand-written VJP `_fsd_bwd`) into one pass each way.  Written out in PyTorch
// the head is some 11 full passes over a feature map forward and 15 backward,
// most of them float32 temporaries; these two kernels are that fusion.
//
// What it computes, with the plain chain's rounding points
// (ops/lpips_head_cuda.py::lpips_head_plain_forward / _backward):
//   norm = sqrt(sum_c f^2) in float32; denom = norm + eps;
//   fn   = round_T(f / denom);  e = round_T(fn - t)   (a bf16 subtract rounds);
//   d    = (sum_{h,w} sum_c lin_c * e^2) / (h w), float32;
//   u    = (e * (lin_c * (2 / hw))) * g;  s_px = sum_c u * f;
//   df   = round_T(u / denom - f * (s_px / ((norm * denom) * denom))).
// Every product and difference is an explicit round-to-nearest intrinsic, so
// nvcc contracts none of them into an FMA the plain chain does not have, and
// every quotient is correctly rounded (`Divisor`); only the sums run in another
// order than PyTorch's.  A pixel whose features are all zero divides 0 by 0 in
// the backward, as the plain chain and JAX's `_fsd_bwd` do.
//
// What bounds it on the H100: device-memory bytes.  Per feature element the
// forward does ~6 flops and the backward ~12 against 2 (bf16) or 4 (float32)
// bytes read, far below the card's flop/byte balance.  The work that has to
// reach memory is: f read once forward, f read once and df written once
// backward, and t read once per pixel for all n chains of its sample (t is
// [S, 1, h, w, C] on the solver's path, broadcast over the n restarts):
// ~6.2 bytes an element in bf16 over both directions at n = 20.
//
// Design:
//   - NHWC with the channels contiguous: a pixel's C values are one run.  A
//     group of `lanes` lanes (a power of two up to 32) owns a pixel; each lane
//     holds K 16-byte vectors of it in registers (8 bf16 or 4 float32 a
//     vector; C % 8 or C % 4 != 0, or a pointer off the 16-byte grid, takes
//     the scalar instantiation, one element a "vector").  The channel sums
//     (the norm, s_px) are shuffle butterflies within the group, so every lane
//     of the group holds the same bits.
//   - A block takes a range of pixels of one sample s and walks it a tile
//     (8 warps x 32 / lanes pixels) at a time; for each tile it loads t into
//     registers ONCE and then walks up to 64 chains n (gridDim.z covers more),
//     two chains a step (their loads in flight together, their shuffles
//     interleaved; one where t is not broadcast over the chains).  So t leaves
//     memory once per pixel, not once per chain: at 1024^2 slice 1's target
//     alone is 134 MB in bf16, beyond the 50 MB L2.
//   - The forward's spatial mean is taken in a fixed order, with no float
//     atomics: each warp adds its tile sums into its own shared-memory row per
//     chain, the block writes one partial per (s, n) into a scratch array (the
//     wrapper's torch.empty), and the last block of sample s to finish (an
//     integer counter, reset by that block) sums the partials in block order.
//     The geometry depends on the shapes alone, so a run is bitwise repeatable.
//   - The backward has no reduction across pixels: the same walk, df stored
//     as 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHAINS = 64;  // chains a block walks for one tile of pixels

// One vector of VEC elements of T: kept packed in registers (Raw), unpacked to
// float for the arithmetic, rounded to T by `round`.
template <typename T, int VEC>
struct Pack;

template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Pack<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw zero() { return 0.f; }
  static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) { v[0] = r; }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Pack<bf16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ Raw load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      v[2 * i] = x.x;
      v[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Pack<bf16, 1> {
  using Raw = bf16;
  static __device__ __forceinline__ Raw zero() { return __float2bfloat16_rn(0.f); }
  static __device__ __forceinline__ Raw load(const bf16* p) { return p[0]; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) {
    v[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// Where a block works: sample s = blockIdx.y, chains [n0, n0 + nc), pixels
// [pbeg, pend) in tiles of WARPS * (32 / lanes); this thread's lane in its
// pixel's group (gl) and its group's pixel in a tile.
struct Walk {
  int s, n0, nc, pbeg, pend, lanes, gl, slot, per_tile;
  __device__ __forceinline__ Walk(int N, int P, int lanes_, int pix_per_block) {
    s = blockIdx.y;
    n0 = blockIdx.z * CHAINS;
    nc = min(CHAINS, N - n0);
    pbeg = blockIdx.x * pix_per_block;
    pend = min(P, pbeg + pix_per_block);
    lanes = lanes_;
    const int lane = threadIdx.x & 31, groups = 32 / lanes;
    gl = lane & (lanes - 1);
    slot = (threadIdx.x >> 5) * groups + lane / lanes;
    per_tile = WARPS * groups;
  }
};

// The K vectors of this lane at pixel `px` (elements from `base`), zero where
// the pixel or the vector lies outside.
template <typename T, int VEC, int K>
__device__ __forceinline__ void load_pixel(typename Pack<T, VEC>::Raw (&r)[K], const T* base, bool valid,
                                           int gl, int lanes, int nvec) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = gl + k * lanes;
    r[k] = (valid && v < nvec) ? Pack<T, VEC>::load(base + (int64_t)v * VEC) : Pack<T, VEC>::zero();
  }
}

// a / b rounded to nearest, as PyTorch's division gives it, by the reciprocal of b
// taken once a pixel and one FMA correction (Markstein): q = RN(a r) is within an ulp
// of a / b, the remainder a - q b is exact in an FMA, and RN(q + (a - q b) r) is the
// correctly rounded quotient for r = RN(1 / b), but where b's significand is all ones;
// there (2^-23 of the divisors) the IEEE division itself.  3 instructions against the
// ~10 of `div.rn.f32` and its range check, which made the head 2.5-3x slower at the
// same bytes (H100 SXM, 700 W: 3.8 against 1.4 ms for the forward at 1024^2 x 64 x 20
// chains in bf16, and bitwise the same results).  The theorem holds for quotients in
// float32's normal range, where the head's lie (f / denom and u / denom, far above 1e-38).
struct Divisor {
  float b, r;
  bool ieee;  // b's significand all ones
  __device__ __forceinline__ float operator()(float a) const {
    if (ieee) return __fdiv_rn(a, b);
    const float q = __fmul_rn(a, r);
    return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
  }
};

__device__ __forceinline__ Divisor divisor(float b) {
  return Divisor{b, __frcp_rn(b), (__float_as_uint(b) & 0x7fffffu) == 0x7fffffu};
}

// Sums over the `lanes` lanes of a pixel's group (a power of two) of U independent
// values, their shuffles interleaved: every lane ends with the same bits, since each
// step adds the same two numbers.
template <int U>
__device__ __forceinline__ void group_sums(float (&x)[U], int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
  }
}

// sum_c f^2 of this lane's share of the pixel held in `fr`.
template <typename T, int VEC, int K>
__device__ __forceinline__ float squares(const typename Pack<T, VEC>::Raw (&fr)[K]) {
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x[VEC];
    Pack<T, VEC>::unpack(fr[k], x);
#pragma unroll
    for (int i = 0; i < VEC; ++i) ss = __fadd_rn(ss, __fmul_rn(x[i], x[i]));
  }
  return ss;
}

// Forward: the block's tiles, U chains at a time against the tile's t in registers
// (U > 1 only where t is broadcast over the chains, t_n = 0).
template <typename T, int VEC, int K, int U>
__global__ void __launch_bounds__(THREADS)
lpips_head_fwd_kernel(const T* __restrict__ f, const T* __restrict__ t, const float* __restrict__ lin,
                      float* __restrict__ partial, unsigned int* __restrict__ counter, float* __restrict__ d,
                      int N, int P, int C, int64_t t_s, int64_t t_n, int lanes, int pix_per_block,
                      float eps) {
  using PK = Pack<T, VEC>;
  using Raw = typename PK::Raw;
  __shared__ float acc[WARPS][CHAINS];
  __shared__ bool last;
  const Walk w(N, P, lanes, pix_per_block);
  const int nvec = C / VEC, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t PC = (int64_t)P * C;
  for (int i = threadIdx.x; i < WARPS * CHAINS; i += THREADS) (&acc[0][0])[i] = 0.f;
  float wl[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = w.gl + k * lanes;
#pragma unroll
    for (int i = 0; i < VEC; ++i) wl[k][i] = v < nvec ? __ldg(lin + v * VEC + i) : 0.f;
  }
  __syncthreads();
  for (int p0 = w.pbeg; p0 < w.pend; p0 += w.per_tile) {
    const int p = p0 + w.slot;
    const bool valid = p < w.pend;
    const T* tp = t + w.s * t_s + (int64_t)p * C;
    const T* fp = f + ((int64_t)w.s * N + w.n0) * PC + (int64_t)p * C;
    Raw tr[K];
    load_pixel<T, VEC, K>(tr, tp + w.n0 * t_n, valid, w.gl, lanes, nvec);
    for (int j0 = 0; j0 < w.nc; j0 += U) {
      Raw fr[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_pixel<T, VEC, K>(fr[u], fp + (j0 + u) * PC, valid && j0 + u < w.nc, w.gl, lanes, nvec);
      if (U == 1 && t_n != 0 && j0 > 0) load_pixel<T, VEC, K>(tr, tp + (w.n0 + j0) * t_n, valid, w.gl, lanes, nvec);
      float ss[U], val[U];
#pragma unroll
      for (int u = 0; u < U; ++u) ss[u] = squares<T, VEC, K>(fr[u]);
      group_sums<U>(ss, lanes);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const Divisor denom = divisor(__fadd_rn(sqrtf(ss[u]), eps));
        val[u] = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float x[VEC], tv[VEC];
          PK::unpack(fr[u][k], x);
          PK::unpack(tr[k], tv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float e = PK::round(__fsub_rn(PK::round(denom(x[i])), tv[i]));
            val[u] = __fadd_rn(val[u], __fmul_rn(__fmul_rn(e, e), wl[k][i]));
          }
        }
      }
      group_sums<U>(val, 32);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (lane == 0 && j0 + u < w.nc) acc[warp][j0 + u] += val[u];
    }
  }
  __syncthreads();
  // this block's partial of every chain, its warps in order
  const int blocks = gridDim.x;
  for (int j = threadIdx.x; j < w.nc; j += THREADS) {
    float b = 0.f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) b += acc[v][j];
    partial[((int64_t)w.s * N + w.n0 + j) * blocks + blockIdx.x] = b;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter + w.s, 1u) == gridDim.x * gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block of sample s: d[s, n] = the partials summed in block order / (h w), a warp a chain
  for (int n = warp; n < N; n += WARPS) {
    const float* row = partial + ((int64_t)w.s * N + n) * blocks;
    float x[1] = {0.f};
    for (int b = lane; b < blocks; b += 32) x[0] += __ldcg(row + b);
    group_sums<1>(x, 32);
    if (lane == 0) d[(int64_t)w.s * N + n] = __fdiv_rn(x[0], (float)P);
  }
  if (threadIdx.x == 0) counter[w.s] = 0u;
}

// Backward: the same walk; df stored as the pixel's vectors.
template <typename T, int VEC, int K, int U>
__global__ void __launch_bounds__(THREADS)
lpips_head_bwd_kernel(const T* __restrict__ f, const T* __restrict__ t, const float* __restrict__ lin,
                      const float* __restrict__ g, T* __restrict__ df, int N, int P, int C, int64_t t_s,
                      int64_t t_n, int lanes, int pix_per_block, float eps, float two_over_hw) {
  using PK = Pack<T, VEC>;
  using Raw = typename PK::Raw;
  const Walk w(N, P, lanes, pix_per_block);
  const int nvec = C / VEC;
  const int64_t PC = (int64_t)P * C;
  float sc[K][VEC];  // lin_c * (2 / hw)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = w.gl + k * lanes;
#pragma unroll
    for (int i = 0; i < VEC; ++i) sc[k][i] = v < nvec ? __fmul_rn(__ldg(lin + v * VEC + i), two_over_hw) : 0.f;
  }
  for (int p0 = w.pbeg; p0 < w.pend; p0 += w.per_tile) {
    const int p = p0 + w.slot;
    const bool valid = p < w.pend;
    const T* tp = t + w.s * t_s + (int64_t)p * C;
    const int64_t off = ((int64_t)w.s * N + w.n0) * PC + (int64_t)p * C;
    Raw tr[K];
    load_pixel<T, VEC, K>(tr, tp + w.n0 * t_n, valid, w.gl, lanes, nvec);
    for (int j0 = 0; j0 < w.nc; j0 += U) {
      Raw fr[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_pixel<T, VEC, K>(fr[u], f + off + (j0 + u) * PC, valid && j0 + u < w.nc, w.gl, lanes, nvec);
      if (U == 1 && t_n != 0 && j0 > 0) load_pixel<T, VEC, K>(tr, tp + (w.n0 + j0) * t_n, valid, w.gl, lanes, nvec);
      float ss[U], sp[U], gn[U], norm[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ss[u] = squares<T, VEC, K>(fr[u]);
        gn[u] = j0 + u < w.nc ? __ldg(g + (int64_t)w.s * N + w.n0 + j0 + u) : 0.f;
      }
      group_sums<U>(ss, lanes);
      float uu[U][K][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        norm[u] = sqrtf(ss[u]);
        const Divisor denom = divisor(__fadd_rn(norm[u], eps));
        sp[u] = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float x[VEC], tv[VEC];
          PK::unpack(fr[u][k], x);
          PK::unpack(tr[k], tv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float e = PK::round(__fsub_rn(PK::round(denom(x[i])), tv[i]));
            uu[u][k][i] = __fmul_rn(__fmul_rn(e, sc[k][i]), gn[u]);
            sp[u] = __fadd_rn(sp[u], __fmul_rn(uu[u][k][i], x[i]));
          }
        }
      }
      group_sums<U>(sp, lanes);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const Divisor denom = divisor(__fadd_rn(norm[u], eps));
        const float q = __fdiv_rn(sp[u], __fmul_rn(__fmul_rn(norm[u], denom.b), denom.b));
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int v = w.gl + k * lanes;
          if (!valid || v >= nvec || j0 + u >= w.nc) continue;
          float x[VEC], out[VEC];
          PK::unpack(fr[u][k], x);
#pragma unroll
          for (int i = 0; i < VEC; ++i) out[i] = __fsub_rn(denom(uu[u][k][i]), __fmul_rn(x[i], q));
          PK::store(df + off + (j0 + u) * PC + (int64_t)v * VEC, out);
        }
      }
    }
  }
}

// The launch geometry comes from ops/lpips_head_cuda.py::head_geometry: `vec`
// elements a vector (1, or 4 in float32 / 8 in bf16), `lanes` a pixel, `kvec`
// vectors a lane, `blocks` x S x ceil(N / CHAINS) blocks of `pix_per_block` pixels.
struct Geometry {
  int vec, lanes, kvec, blocks, pix_per_block;
};

template <typename T>
bool geometry_ok(const Geometry& gm, const T* f, const T* t, int S, int N, int P, int C,
                 int64_t t_s, int64_t t_n, int wide) {
  if (S <= 0 || S > 65535 || N <= 0 || P <= 0 || C <= 0 || gm.blocks <= 0 || gm.pix_per_block <= 0) return false;
  if (gm.lanes <= 0 || gm.lanes > 32 || (gm.lanes & (gm.lanes - 1)) != 0) return false;
  if ((int64_t)gm.blocks * gm.pix_per_block < P || (N + CHAINS - 1) / CHAINS > 65535) return false;
  if (gm.vec != 1 && gm.vec != wide) return false;
  if (C % gm.vec != 0 || (int64_t)gm.lanes * gm.kvec < C / gm.vec) return false;
  if (gm.vec != 1 && (((reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(t)) & 15) != 0 ||
                      t_s % gm.vec != 0 || t_n % gm.vec != 0))
    return false;
  return true;
}

template <typename T, int VEC, int K, int U>
cudaError_t fwd_launch(const T* f, const T* t, const float* lin, float* partial, unsigned int* counter, float* d,
                       int S, int N, int P, int C, int64_t t_s, int64_t t_n, const Geometry& gm, float eps,
                       cudaStream_t stream) {
  const dim3 grid(gm.blocks, S, (N + CHAINS - 1) / CHAINS);
  lpips_head_fwd_kernel<T, VEC, K, U><<<grid, THREADS, 0, stream>>>(f, t, lin, partial, counter, d, N, P, C, t_s,
                                                                     t_n, gm.lanes, gm.pix_per_block, eps);
  return cudaGetLastError();
}

template <typename T, int VEC, int K, int U>
cudaError_t bwd_launch(const T* f, const T* t, const float* lin, const float* g, T* df, int S, int N, int P,
                       int C, int64_t t_s, int64_t t_n, const Geometry& gm, float eps, float two_over_hw,
                       cudaStream_t stream) {
  const dim3 grid(gm.blocks, S, (N + CHAINS - 1) / CHAINS);
  lpips_head_bwd_kernel<T, VEC, K, U><<<grid, THREADS, 0, stream>>>(f, t, lin, g, df, N, P, C, t_s, t_n, gm.lanes,
                                                                     gm.pix_per_block, eps, two_over_hw);
  return cudaGetLastError();
}

// The instantiation for the geometry: `launch` called with (vec, kvec, chains a step)
// as compile-time constants; kvec 1, 2, 4 or 8, and two chains a step on the vector
// route where t is broadcast over the chains (t_n = 0), else one.
template <int WIDE, typename Fn>
cudaError_t instantiate(const Geometry& gm, int64_t t_n, Fn&& launch) {
  using std::integral_constant;
  auto by_k = [&](auto vec, auto u) -> cudaError_t {
    switch (gm.kvec) {
      case 1: return launch(vec, integral_constant<int, 1>(), u);
      case 2: return launch(vec, integral_constant<int, 2>(), u);
      case 4: return launch(vec, integral_constant<int, 4>(), u);
      case 8: return launch(vec, integral_constant<int, 8>(), u);
      default: return cudaErrorInvalidValue;
    }
  };
  if (gm.vec == 1) return by_k(integral_constant<int, 1>(), integral_constant<int, 1>());
  const integral_constant<int, WIDE> wide;
  return t_n == 0 ? by_k(wide, integral_constant<int, 2>()) : by_k(wide, integral_constant<int, 1>());
}

template <typename T>
int head_fwd(const T* f, const T* t, const float* lin, float* partial, unsigned int* counter, float* d, int S,
             int N, int P, int C, int64_t t_s, int64_t t_n, const Geometry& gm, float eps, cudaStream_t stream) {
  constexpr int WIDE = 16 / sizeof(T);
  if (!geometry_ok(gm, f, t, S, N, P, C, t_s, t_n, WIDE)) return (int)cudaErrorInvalidValue;
  return (int)instantiate<WIDE>(gm, t_n, [&](auto vec, auto k, auto u) {
    return fwd_launch<T, decltype(vec)::value, decltype(k)::value, decltype(u)::value>(
        f, t, lin, partial, counter, d, S, N, P, C, t_s, t_n, gm, eps, stream);
  });
}

template <typename T>
int head_bwd(const T* f, const T* t, const float* lin, const float* g, T* df, int S, int N, int P, int C,
             int64_t t_s, int64_t t_n, const Geometry& gm, float eps, float two_over_hw, cudaStream_t stream) {
  constexpr int WIDE = 16 / sizeof(T);
  if (!geometry_ok(gm, f, t, S, N, P, C, t_s, t_n, WIDE) ||
      (gm.vec != 1 && (reinterpret_cast<uintptr_t>(df) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  return (int)instantiate<WIDE>(gm, t_n, [&](auto vec, auto k, auto u) {
    return bwd_launch<T, decltype(vec)::value, decltype(k)::value, decltype(u)::value>(
        f, t, lin, g, df, S, N, P, C, t_s, t_n, gm, eps, two_over_hw, stream);
  });
}

}  // namespace

extern "C" {

// f: [S, N, P, C] contiguous; t: element (s, n, p, c) at s * t_s + n * t_n + p * C + c
// (t_n = 0: broadcast over the chains); lin: [C] float32; d: [S, N] float32.
// partial: S * N * blocks floats of scratch; counter: S zeroed unsigned ints, left
// zeroed.  The geometry (vec, lanes, kvec, blocks, pix_per_block) as
// ops/lpips_head_cuda.py::head_geometry gives it.
int fp_lpips_head_fwd_f32(const float* f, const float* t, const float* lin, float* partial, unsigned int* counter,
                          float* d, int S, int N, int P, int C, int vec, int lanes, int kvec, int blocks,
                          int pix_per_block, int64_t t_s, int64_t t_n, float eps, void* stream) {
  return head_fwd<float>(f, t, lin, partial, counter, d, S, N, P, C, t_s, t_n,
                         Geometry{vec, lanes, kvec, blocks, pix_per_block}, eps, (cudaStream_t)stream);
}

int fp_lpips_head_fwd_bf16(const bf16* f, const bf16* t, const float* lin, float* partial, unsigned int* counter,
                           float* d, int S, int N, int P, int C, int vec, int lanes, int kvec, int blocks,
                           int pix_per_block, int64_t t_s, int64_t t_n, float eps, void* stream) {
  return head_fwd<bf16>(f, t, lin, partial, counter, d, S, N, P, C, t_s, t_n,
                        Geometry{vec, lanes, kvec, blocks, pix_per_block}, eps, (cudaStream_t)stream);
}

// g: [S, N] float32 (the cotangent of d); df: [S, N, P, C] like f.
int fp_lpips_head_bwd_f32(const float* f, const float* t, const float* lin, const float* g, float* df, int S, int N,
                          int P, int C, int vec, int lanes, int kvec, int blocks, int pix_per_block, int64_t t_s,
                          int64_t t_n, float eps, float two_over_hw, void* stream) {
  return head_bwd<float>(f, t, lin, g, df, S, N, P, C, t_s, t_n, Geometry{vec, lanes, kvec, blocks, pix_per_block},
                         eps, two_over_hw, (cudaStream_t)stream);
}

int fp_lpips_head_bwd_bf16(const bf16* f, const bf16* t, const float* lin, const float* g, bf16* df, int S, int N,
                           int P, int C, int vec, int lanes, int kvec, int blocks, int pix_per_block, int64_t t_s,
                           int64_t t_n, float eps, float two_over_hw, void* stream) {
  return head_bwd<bf16>(f, t, lin, g, df, S, N, P, C, t_s, t_n, Geometry{vec, lanes, kvec, blocks, pix_per_block},
                        eps, two_over_hw, (cudaStream_t)stream);
}

}  // extern "C"
