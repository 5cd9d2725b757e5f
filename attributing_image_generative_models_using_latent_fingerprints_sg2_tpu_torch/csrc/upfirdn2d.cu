// 4-tap separable FIR kernels of the StyleGAN2 synthesis network, NHWC float32 and bfloat16.
//
// blur4   replaces ops/upfirdn2d_pallas.py::blur4 (_blur4_kernel): up=down=1,
//         pads (p0, p1) per axis, out = in + p0 + p1 - 3.  On the main path it is
//         the post-transpose blur of every upsample styled conv.  Its backward is
//         the same kernel with flipped taps and pads (3 - p0, 3 - p1).
// upblur4 replaces ops/upfirdn2d_pallas.py::upblur4 (_upblur4_kernel): up=2,
//         pad (2, 1), out = 2 * in.  The zero-stuffed map never exists: each
//         output takes the 2 taps per axis that its parity selects.  On the main
//         path it is the ToRGB skip upsample (C = 3), fused with the add it
//         feeds: out = rgb + upblur4(skip).
// upblur4_adj is upblur4's adjoint (ops/upfirdn2d_pallas.py::_upblur4_bwd, which
//         the reference computes outside Pallas): down=2 correlation with the
//         unflipped taps, pad (1, 1), in = 2 * out.
//
// What bounds them on the H100: device-memory bytes (2 flops a tap against 8
// bytes an element, far below the card's flop/byte balance).
//
// blur4.  One thread per output element over a flat index would read 16
// scalar taps that only other blocks share: every tap an L2 read, so L2 speed,
// a seventh of the byte bound (measured: 4.3 ms against 0.59 ms at batch 16).
// The design's one job is that an input element leaves L2 about once, in
// 16-byte pieces, with many loads in flight:
//   - a block owns a tile of output columns x a group of channels x a strip
//     of output rows (all from blockIdx: no division per element).  A thread
//     owns 4 consecutive channels (one `float4`; NHWC with C % 4 == 0 makes
//     every pixel 16-byte aligned) of one output column, threads consecutive
//     along the channel axis, so a warp's load is one contiguous 512-byte run;
//   - separable in registers: per input row the 4-tap horizontal sum once (4
//     `float4` loads, of which the neighbours in the block share all but the
//     tile's 3-column halo through L1), then a 4-row sliding window for the
//     vertical sum, so a strip of R output rows reads R + 3 input rows
//     instead of 16 R scalars;
//   - the row loop is unrolled so that several rows' loads are in flight;
//   - pads are arguments and ragged edges are masked, so the adjoint (odd
//     sizes H + 1) is the same kernel with unflipped taps and pads (3 - p0,
//     3 - p1);
//   - C % 4 != 0, or a base pointer off the 16-byte grid, takes the scalar
//     instantiation (one channel a thread) of the same template.
// upblur4.  At C = 3 and 4^2..128^2 pixels the six launches a step are bound
// by launch latency and by the launches around them, so the design removes
// launches and repeated reads rather than tuning the arithmetic:
//   - a thread owns one input pixel, that is a 2 x 2 output quad, for the
//     channels three at a time: it reads the 3 x 3 input neighbourhood once
//     (neighbours share it through L1), sums the 2-tap polyphase vertically
//     then horizontally, adds the matching `rgb` values when that pointer is
//     given, and writes each of the two output rows as one contiguous run
//     (6 floats at C = 3).  The sum never goes to memory before the add;
//   - pixel coordinates come from blockIdx / threadIdx in 32 bits; only the
//     image's base offset is 64-bit;
//   - the adjoint is a kernel of the same shape: a thread per input pixel
//     gathers its 4 x 4 window of the cotangent.  The cotangent of `rgb` is the
//     incoming one itself, so the fused backward is this one launch.
//
// bfloat16 variants (blur4_bf16, upblur4_bf16, upblur4_adj_bf16), as the TPU
// kernels keep their scratch in x.dtype and read and write the activation
// dtype: taps and sums stay float; each output is rounded to bf16 once, on store
// (round to nearest even).  upblur4 and its adjoint are the templates above on
// __nv_bfloat16; so is blur4 where C % 8 != 0 or a pointer is off the 16-byte
// grid (one channel a thread).  Otherwise blur4_bf16 has a kernel of its own,
// blur4_ring_bf16_kernel: the float32 template on bf16 (8 channels a 16-byte
// load) had half the float32 launch's threads for half its bytes, so half the
// bytes in flight, and ran no faster than the float32 kernel (0.89 ms against a
// 0.30 ms byte bound at batch 16).  Its input rows come through a shared-memory
// ring of bulk async copies instead, so the bytes in flight follow the ring's
// depth, not the thread count:
//   - a block owns TW output columns x CC channels (NV 16-byte vectors; NV * TW
//     <= 256 consumer threads, a thread one vector of one column) x a strip of
//     output rows;
//   - its input rows, TW + 3 pixels x CC channels each, pass through BR_STAGES
//     shared stages, filled by a producer warp of its own: it issues a row's
//     copies (`cp.async.bulk`, completion counted on the stage's `full`
//     mbarrier) once every consumer warp has released the stage's previous row
//     (its `empty` mbarrier); one copy a row where CC == C (the segment is
//     contiguous in NHWC), else one a pixel.  Only in-image pixels are copied:
//     a thread reads pixels outside the image, and rows outside it, as zero,
//     so every pad takes the same path.  No tensor map is built on the host:
//     1-D copies need none;
//   - per row the thread reads its 4 taps from shared memory and sums them left
//     to right; the 4-row window of those sums stays in registers for the
//     vertical sum, top to bottom (the order of blur4_kernel, and of
//     ops/upfirdn2d_cuda.py::blur4_strips); 16-byte stores;
//   - strips of up to 64 rows (3 halo rows re-read per strip), shorter while
//     the launch has fewer than BR_BLOCKS_PER_SM blocks for each SM, and equal
//     in length (an output of 65 rows is two strips of 33 and 32, not 64 + 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Taps4 {
  float v[4];
};

constexpr int BLUR_THREADS = 256;

// one element as float, and back (bf16: exact widening, round-to-nearest-even narrowing)
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const bf16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// V consecutive channels held as floats: one 16-byte load / store (4 float or 8 bf16),
// or one element.
template <int V>
struct Vec {
  float v[V];
};
template <class T, int V>
struct VecIo;
template <>
struct VecIo<float, 4> {
  static __device__ __forceinline__ Vec<4> load(const float* p) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    return {{t.x, t.y, t.z, t.w}};
  }
  static __device__ __forceinline__ void store(float* p, const Vec<4>& a) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  }
};
template <class T>
struct VecIo<T, 1> {
  static __device__ __forceinline__ Vec<1> load(const T* p) { return {{ld1(p)}}; }
  static __device__ __forceinline__ void store(T* p, const Vec<1>& a) { st1(p, a.v[0]); }
};

// y[b, oy, ox, c] = sum_{i,j} fy[i] * fx[j] * x[b, oy + i - py0, ox + j - px0, c]
// (zero outside the input).  fy/fx are the FLIPPED taps: correlation with the
// flipped kernel is upfirdn2d's convolution.
//   blockDim.x  channel vectors (of V channels) per block, blockDim.y output columns
//   blockIdx.x  column tile * cgroups + channel group; blockIdx.y row strip of
//               `rows` output rows; blockIdx.z image
template <class T, int V>
__global__ void __launch_bounds__(BLUR_THREADS)
    blur4_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w, int c, int oh,
                 int ow, int py0, int px0, int rows, int cgroups, Taps4 fy, Taps4 fx) {
  const int cg = blockIdx.x % cgroups;
  const int tile = blockIdx.x / cgroups;
  const int ch = (cg * blockDim.x + threadIdx.x) * V;
  const int ox = tile * blockDim.y + threadIdx.y;
  if (ch >= c || ox >= ow) return;
  const int oy0 = blockIdx.y * rows;
  const int nrows = min(rows, oh - oy0);
  const T* xb = x + (int64_t)blockIdx.z * h * w * c + (int64_t)(ox - px0) * c + ch;
  T* yb = y + ((int64_t)blockIdx.z * oh * ow + ox) * c + ch;

  // which of the thread's 4 input columns exist
  bool col_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col_ok[j] = ox - px0 + j >= 0 && ox - px0 + j < w;

  // win[i]: horizontal sum of input row (current - 3 + i) at this output column
  Vec<V> win[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) win[i].v[e] = 0.f;

#pragma unroll 4
  for (int r = 0; r < nrows + 3; ++r) {
    const int iy = oy0 - py0 + r;
    const bool row_ok = iy >= 0 && iy < h;
    const T* xr = xb + (int64_t)iy * w * c;
    Vec<V> in[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (row_ok && col_ok[j]) {
        in[j] = VecIo<T, V>::load(xr + (int64_t)j * c);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) in[j].v[e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) win[i] = win[i + 1];
#pragma unroll
    for (int e = 0; e < V; ++e)
      win[3].v[e] = fx.v[0] * in[0].v[e] + fx.v[1] * in[1].v[e] + fx.v[2] * in[2].v[e] +
                    fx.v[3] * in[3].v[e];
    if (r >= 3) {
      Vec<V> o;
#pragma unroll
      for (int e = 0; e < V; ++e)
        o.v[e] = fy.v[0] * win[0].v[e] + fy.v[1] * win[1].v[e] + fy.v[2] * win[2].v[e] +
                 fy.v[3] * win[3].v[e];
      VecIo<T, V>::store(yb + (int64_t)(oy0 + r - 3) * ow * c, o);
    }
  }
}

template <class T, int V>
cudaError_t blur4_launch(const T* x, T* y, int n, int h, int w, int c, int oh, int ow,
                         int py0, int px0, Taps4 fy, Taps4 fx, cudaStream_t stream) {
  // block: bx channel vectors (a power of two, at most a warp) x by output columns
  const int nvec = c / V;
  int bx = 1;
  while (bx < nvec && bx < 32) bx *= 2;
  const int by = BLUR_THREADS / bx;
  const int cgroups = (nvec + bx - 1) / bx;
  const int tiles = (ow + by - 1) / by;
  // strips of up to 64 rows (3 halo rows re-read per strip), shorter while the
  // launch would leave most of the card's 132 SMs without a block
  int rows = 64;
  while (rows > 4 && (int64_t)tiles * cgroups * ((oh + rows - 1) / rows) * n < 2 * 132) rows /= 2;
  dim3 grid(tiles * cgroups, (oh + rows - 1) / rows, n);
  blur4_kernel<T, V><<<grid, dim3(bx, by), 0, stream>>>(x, y, h, w, c, oh, ow, py0, px0, rows, cgroups,
                                                         fy, fx);
  return cudaGetLastError();
}

constexpr int BR_THREADS = 256;        // consumer threads at most; a producer warp comes on top
constexpr int BR_STAGES = 8;           // input rows in the ring (12 and 16 stages were no faster)
constexpr int BR_BLOCKS_PER_SM = 3;    // the row strips are cut until the launch has this many blocks an SM
constexpr int BR_MAX_NV = 32;          // 16-byte vectors of a pixel a block takes at most
// a stage is (256 / nv + 3) x 16 nv bytes, at most 4096 + 48 nv: the ring fits the 48 KB a
// launch may take without raising its limit
static_assert(BR_STAGES * (16 * BR_THREADS + 48 * BR_MAX_NV) + 16 * BR_STAGES <= 48 * 1024, "shared memory");

// 8 bf16 (one 16-byte piece) as floats, exactly
__device__ __forceinline__ Vec<8> unpack_bf16x8(uint4 t) {
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
  Vec<8> a;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a.v[2 * i] = __uint_as_float(w[i] << 16);
    a.v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  return a;
}

// blur4_kernel's function for bf16 with C % 8 == 0 and 16-byte aligned pointers.
//   blockDim.x  consumer warps (thread i < nv * tw is vector i % nv of output column i / nv
//               of the tile), then the producer warp
//   blockIdx.x  column tile * chunks + channel chunk (of 8 nv channels); blockIdx.y row strip
//               of `rows` output rows; blockIdx.z image
// Shared memory: BR_STAGES stages of (tw + 3) pixels x 16 nv bytes, then full[] and empty[].
__global__ void __launch_bounds__(BR_THREADS + 32, 2)
    blur4_ring_bf16_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int h, int w, int c, int oh,
                           int ow, int py0, int px0, int rows, int nv, int tw, Taps4 fy, Taps4 fx) {
  extern __shared__ __align__(16) uint8_t smem_br[];
  const int cc = 8 * nv;                         // channels of the block
  const int chunks = c / cc;
  const int pix_bytes = 2 * cc;
  const int stage_bytes = (tw + 3) * pix_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_br + BR_STAGES * stage_bytes);
  uint64_t* empty = full + BR_STAGES;

  const int ncons = blockDim.x - 32;             // consumer threads, a multiple of 32
  const int c0 = (blockIdx.x % chunks) * cc;
  const int ix0 = (blockIdx.x / chunks) * tw - px0;  // input column of the stage's pixel 0
  const int oy0 = blockIdx.y * rows;
  const int nin = min(rows, oh - oy0) + 3;           // input rows of the strip
  const int iy0 = oy0 - py0;
  const int64_t img = (int64_t)blockIdx.z * h;

  if (threadIdx.x == 0) fp_ring_init(full, empty, BR_STAGES, ncons / 32);
  __syncthreads();

  if (threadIdx.x >= ncons) {
    // the producer warp: input row q of the strip into stage q % BR_STAGES once every consumer
    // warp has released the stage's last row; only the stage's in-image pixels [pa, pb)
    const int lane = threadIdx.x & 31;
    const int pa = max(0, -ix0), pb = min(tw + 3, w - ix0);
    for (int q = 0; q < nin; ++q) {
      const int s = q % BR_STAGES;
      const int iy = iy0 + q;
      const uint32_t bytes = iy >= 0 && iy < h && pb > pa ? (uint32_t)(pb - pa) * pix_bytes : 0u;
      if (lane == 0) {
        if (q >= BR_STAGES) fp_mbar_wait(empty + s, (q / BR_STAGES - 1) & 1);
        if (bytes != 0) fp_mbar_expect_tx(full + s, bytes);
        else fp_mbar_arrive(full + s);
      }
      __syncwarp();
      if (bytes == 0) continue;
      uint8_t* dst = smem_br + s * stage_bytes;
      const bf16* src = x + ((img + iy) * w + ix0 + pa) * c + c0;
      if (cc == c) {  // one copy: the row's pixels are contiguous
        if (lane == 0) fp_bulk_load(dst + pa * pix_bytes, src, bytes, full + s);
      } else {
        for (int p = lane; p < pb - pa; p += 32)
          fp_bulk_load(dst + (pa + p) * pix_bytes, src + (int64_t)p * c, pix_bytes, full + s);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int v = threadIdx.x % nv;
  const int col = threadIdx.x / nv;
  const int ox = ix0 + px0 + col;
  const bool active = threadIdx.x < nv * tw && ox < ow;
  // which of the thread's 4 input columns exist (none for an inactive thread)
  bool col_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col_ok[j] = active && ix0 + col + j >= 0 && ix0 + col + j < w;
  const int rd = (col * nv + v) * 16;  // the thread's first tap in a stage
  bf16* yb = y + ((int64_t)blockIdx.z * oh * ow + ox) * c + c0 + 8 * v;

  // win[i]: horizontal sum of input row (current - 3 + i) at this output column
  Vec<8> win[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) win[i].v[e] = 0.f;

#pragma unroll 4
  for (int r = 0; r < nin; ++r) {
    const int s = r % BR_STAGES;
    fp_mbar_wait(full + s, (r / BR_STAGES) & 1);
    const bool row_ok = iy0 + r >= 0 && iy0 + r < h;
    const uint8_t* st = smem_br + s * stage_bytes + rd;
    Vec<8> in[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (row_ok && col_ok[j]) {
        in[j] = unpack_bf16x8(*reinterpret_cast<const uint4*>(st + j * pix_bytes));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) in[j].v[e] = 0.f;
      }
    }
    __syncwarp();
    if (lane == 0) fp_mbar_arrive(empty + s);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < 3; ++i) win[i] = win[i + 1];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      win[3].v[e] = fx.v[0] * in[0].v[e] + fx.v[1] * in[1].v[e] + fx.v[2] * in[2].v[e] +
                    fx.v[3] * in[3].v[e];
    if (r >= 3 && active) {
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = fp_pack_bf16x2(
            fy.v[0] * win[0].v[2 * e] + fy.v[1] * win[1].v[2 * e] + fy.v[2] * win[2].v[2 * e] +
                fy.v[3] * win[3].v[2 * e],
            fy.v[0] * win[0].v[2 * e + 1] + fy.v[1] * win[1].v[2 * e + 1] + fy.v[2] * win[2].v[2 * e + 1] +
                fy.v[3] * win[3].v[2 * e + 1]);
      *reinterpret_cast<uint4*>(yb + (int64_t)(oy0 + r - 3) * ow * c) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

cudaError_t blur4_ring_launch(const bf16* x, bf16* y, int n, int h, int w, int c, int oh, int ow, int py0,
                              int px0, Taps4 fy, Taps4 fx, cudaStream_t stream) {
  // nv: the largest divisor of C / 8 up to BR_MAX_NV vectors
  const int nvec = c / 8;
  int nv = min(nvec, BR_MAX_NV);
  while (nvec % nv != 0) --nv;
  const int tw = BR_THREADS / nv;
  const int64_t tiles = (int64_t)((ow + tw - 1) / tw) * (nvec / nv);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  // strips of up to 64 rows, more of them while the launch is short of blocks, equal in length
  int target = 64;
  while (target > 2 && tiles * ((oh + target - 1) / target) * n < (int64_t)BR_BLOCKS_PER_SM * sms) target /= 2;
  const int strips = (oh + target - 1) / target;
  const int rows = (oh + strips - 1) / strips;
  if (tiles > 0x7fffffff || strips > 65535) return cudaErrorInvalidValue;
  const size_t smem = (size_t)BR_STAGES * (tw + 3) * 16 * nv + 2 * BR_STAGES * sizeof(uint64_t);
  const int threads = (nv * tw + 31) / 32 * 32 + 32;
  blur4_ring_bf16_kernel<<<dim3((unsigned)tiles, strips, n), threads, smem, stream>>>(
      x, y, h, w, c, oh, ow, py0, px0, rows, nv, tw, fy, fx);
  return cudaGetLastError();
}

// upfirdn2d(x, outer(k, k), up=2, pad=(2, 1)) with f = flipped k, as a 2-tap
// polyphase per axis:  y[2i] = f0 * x[i - 1] + f2 * x[i],  y[2i + 1] = f1 * x[i] +
// f3 * x[i + 1]  (x is 0 outside).  CH consecutive channels of the quad of input
// pixel (i, j); xb / rb / yb point at the image's first of those channels.
template <int CH, class T>
__device__ __forceinline__ void upblur4_quad(const T* __restrict__ xb, const T* __restrict__ rb,
                                             T* __restrict__ yb, int i, int j, int h, int w, int c,
                                             const Taps4& f) {
  float ve[3][CH], vo[3][CH];  // vertical sums of the even / odd output row at columns j - 1 .. j + 1
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    const int jj = j + dj - 1;
    const bool col_ok = jj >= 0 && jj < w;
    const T* xc = xb + (i * w + jj) * c;
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      const float up = (col_ok && i > 0) ? ld1(xc - w * c + e) : 0.f;
      const float mid = col_ok ? ld1(xc + e) : 0.f;
      const float down = (col_ok && i + 1 < h) ? ld1(xc + w * c + e) : 0.f;
      ve[dj][e] = f.v[0] * up + f.v[2] * mid;
      vo[dj][e] = f.v[1] * mid + f.v[3] * down;
    }
  }
  const int row = 2 * w * c;  // floats in an output row
  const int o0 = 2 * i * row + 2 * j * c, o1 = o0 + row;
  float out[4][CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    out[0][e] = f.v[0] * ve[0][e] + f.v[2] * ve[1][e];
    out[1][e] = f.v[1] * ve[1][e] + f.v[3] * ve[2][e];
    out[2][e] = f.v[0] * vo[0][e] + f.v[2] * vo[1][e];
    out[3][e] = f.v[1] * vo[1][e] + f.v[3] * vo[2][e];
  }
  if (rb != nullptr) {
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      out[0][e] += ld1(rb + o0 + e);
      out[1][e] += ld1(rb + o0 + c + e);
      out[2][e] += ld1(rb + o1 + e);
      out[3][e] += ld1(rb + o1 + c + e);
    }
  }
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    st1(yb + o0 + e, out[0][e]);
    st1(yb + o0 + c + e, out[1][e]);
    st1(yb + o1 + e, out[2][e]);
    st1(yb + o1 + c + e, out[3][e]);
  }
}

// y = upblur4(x) (+ rgb when given).  x [n, h, w, c]; rgb, y [n, 2h, 2w, c].
//   threadIdx.x / blockIdx.x input column, threadIdx.y / blockIdx.y input row, blockIdx.z image
template <class T>
__global__ void upblur4_kernel(const T* __restrict__ x, const T* __restrict__ rgb, T* __restrict__ y,
                               int h, int w, int c, Taps4 f) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const int64_t in_base = (int64_t)blockIdx.z * h * w * c;
  const T* xb = x + in_base;
  const T* rb = rgb != nullptr ? rgb + 4 * in_base : nullptr;
  T* yb = y + 4 * in_base;
  int c0 = 0;
  for (; c0 + 3 <= c; c0 += 3)
    upblur4_quad<3>(xb + c0, rb != nullptr ? rb + c0 : nullptr, yb + c0, i, j, h, w, c, f);
  for (; c0 < c; ++c0)
    upblur4_quad<1>(xb + c0, rb != nullptr ? rb + c0 : nullptr, yb + c0, i, j, h, w, c, f);
}

// dx[i, j] = sum_{r,s} k[r] * k[s] * g[2i - 1 + r, 2j - 1 + s]  (g is 0 outside), k the
// UNFLIPPED taps: CH consecutive channels of input pixel (i, j).
template <int CH, class T>
__device__ __forceinline__ void upblur4_adj_pixel(const T* __restrict__ gb, T* __restrict__ db,
                                                  int i, int j, int h, int w, int c,
                                                  const Taps4& k) {
  const int oh = 2 * h, ow = 2 * w;
  float acc[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) acc[e] = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gy = 2 * i - 1 + r;
    if (gy < 0 || gy >= oh) continue;
    float rowsum[CH];
#pragma unroll
    for (int e = 0; e < CH; ++e) rowsum[e] = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gx = 2 * j - 1 + s;
      if (gx < 0 || gx >= ow) continue;
      const T* gp = gb + (gy * ow + gx) * c;
#pragma unroll
      for (int e = 0; e < CH; ++e) rowsum[e] += k.v[s] * ld1(gp + e);
    }
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[e] += k.v[r] * rowsum[e];
  }
#pragma unroll
  for (int e = 0; e < CH; ++e) st1(db + (i * w + j) * c + e, acc[e]);
}

// dx = adjoint of upblur4 applied to g.  g [n, 2h, 2w, c]; dx [n, h, w, c].  Grid as upblur4_kernel.
template <class T>
__global__ void upblur4_adj_kernel(const T* __restrict__ g, T* __restrict__ dx, int h, int w,
                                   int c, Taps4 k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const int64_t in_base = (int64_t)blockIdx.z * h * w * c;
  const T* gb = g + 4 * in_base;
  T* db = dx + in_base;
  int c0 = 0;
  for (; c0 + 3 <= c; c0 += 3) upblur4_adj_pixel<3>(gb + c0, db + c0, i, j, h, w, c, k);
  for (; c0 < c; ++c0) upblur4_adj_pixel<1>(gb + c0, db + c0, i, j, h, w, c, k);
}

// One thread per input pixel: up to 32 columns x enough rows for 256 threads.
struct PixelGrid {
  dim3 grid, block;
};
inline PixelGrid pixel_grid(int n, int h, int w) {
  int bx = 1, by = 1;
  while (bx < w && bx < 32) bx *= 2;
  while (by < h && bx * by < 256) by *= 2;
  return {dim3((w + bx - 1) / bx, (h + by - 1) / by, n), dim3(bx, by)};
}

// sizes a launch of the two kernels above takes: 32-bit offsets within one image
inline bool upblur4_sizes_ok(int n, int h, int w, int c) {
  return n > 0 && h > 0 && w > 0 && c > 0 && n <= 65535 && h <= 65535 &&
         (int64_t)4 * h * w * c < ((int64_t)1 << 31);
}

// one launch of each kernel in element type T (the typed bodies of the C entry points below)
template <class T>
int blur4_entry(const T* x, T* y, int n, int h, int w, int c, int oh, int ow, int py0, int px0,
                const float* f, cudaStream_t stream) {
  if (n <= 0 || c <= 0 || oh <= 0 || ow <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  Taps4 fy = {{f[0], f[1], f[2], f[3]}};
  Taps4 fx = {{f[4], f[5], f[6], f[7]}};
  constexpr int V = 16 / sizeof(T);  // channels in 16 bytes
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (c % V == 0 && aligned) {
    if constexpr (sizeof(T) == 2) return (int)blur4_ring_launch(x, y, n, h, w, c, oh, ow, py0, px0, fy, fx, stream);
    else return (int)blur4_launch<T, V>(x, y, n, h, w, c, oh, ow, py0, px0, fy, fx, stream);
  }
  return (int)blur4_launch<T, 1>(x, y, n, h, w, c, oh, ow, py0, px0, fy, fx, stream);
}

template <class T>
int upblur4_entry(const T* x, const T* rgb, T* y, int n, int h, int w, int c, Taps4 f,
                  cudaStream_t stream) {
  if (!upblur4_sizes_ok(n, h, w, c)) return (int)cudaErrorInvalidValue;
  const PixelGrid pg = pixel_grid(n, h, w);
  upblur4_kernel<T><<<pg.grid, pg.block, 0, stream>>>(x, rgb, y, h, w, c, f);
  return (int)cudaGetLastError();
}

template <class T>
int upblur4_adj_entry(const T* g, T* dx, int n, int h, int w, int c, Taps4 k, cudaStream_t stream) {
  if (!upblur4_sizes_ok(n, h, w, c)) return (int)cudaErrorInvalidValue;
  const PixelGrid pg = pixel_grid(n, h, w);
  upblur4_adj_kernel<T><<<pg.grid, pg.block, 0, stream>>>(g, dx, h, w, c, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int fp_blur4_f32(const float* x, float* y, int n, int h, int w, int c, int oh, int ow, int py0,
                 int px0, float fy0, float fy1, float fy2, float fy3, float fx0, float fx1,
                 float fx2, float fx3, void* stream) {
  const float f[8] = {fy0, fy1, fy2, fy3, fx0, fx1, fx2, fx3};
  return blur4_entry<float>(x, y, n, h, w, c, oh, ow, py0, px0, f, (cudaStream_t)stream);
}

int fp_blur4_bf16(const bf16* x, bf16* y, int n, int h, int w, int c, int oh, int ow, int py0,
                  int px0, float fy0, float fy1, float fy2, float fy3, float fx0, float fx1,
                  float fx2, float fx3, void* stream) {
  const float f[8] = {fy0, fy1, fy2, fy3, fx0, fx1, fx2, fx3};
  return blur4_entry<bf16>(x, y, n, h, w, c, oh, ow, py0, px0, f, (cudaStream_t)stream);
}

// y = upblur4(x) + rgb; a null `rgb` leaves the add out.
int fp_upblur4_f32(const float* x, const float* rgb, float* y, int n, int h, int w, int c,
                   float f0, float f1, float f2, float f3, void* stream) {
  return upblur4_entry<float>(x, rgb, y, n, h, w, c, Taps4{{f0, f1, f2, f3}}, (cudaStream_t)stream);
}

int fp_upblur4_bf16(const bf16* x, const bf16* rgb, bf16* y, int n, int h, int w, int c, float f0,
                    float f1, float f2, float f3, void* stream) {
  return upblur4_entry<bf16>(x, rgb, y, n, h, w, c, Taps4{{f0, f1, f2, f3}}, (cudaStream_t)stream);
}

int fp_upblur4_adj_f32(const float* g, float* dx, int n, int h, int w, int c, float k0, float k1,
                       float k2, float k3, void* stream) {
  return upblur4_adj_entry<float>(g, dx, n, h, w, c, Taps4{{k0, k1, k2, k3}}, (cudaStream_t)stream);
}

int fp_upblur4_adj_bf16(const bf16* g, bf16* dx, int n, int h, int w, int c, float k0, float k1,
                        float k2, float k3, void* stream) {
  return upblur4_adj_entry<bf16>(g, dx, n, h, w, c, Taps4{{k0, k1, k2, k3}}, (cudaStream_t)stream);
}

}  // extern "C"
