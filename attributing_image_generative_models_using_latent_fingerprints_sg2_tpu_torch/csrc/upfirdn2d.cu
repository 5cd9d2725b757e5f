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
// (round to nearest even).  upblur4_bf16 and upblur4_adj_bf16 are kernels of
// their own, for the whole ToRGB skip chain (see "The bf16 skip chain" below).
// blur4_bf16 is the template above on __nv_bfloat16 where C % 8 != 0 or a
// pointer is off the 16-byte grid (one channel a thread).  Otherwise it has a kernel of its own,
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
//
// The bf16 skip chain.  Synthesis sums its ToRGB outputs t_0 .. t_L (t_k at
// (h0 2^k) x (w0 2^k)) as rgb_0 = t_0, rgb_k = t_k + upblur4(rgb_{k-1}), and
// nothing else reads an intermediate rgb_k; the cotangents are g_L = g and
// g_{k-1} = adj(g_k), a pyramid of g alone.  At C = 3 each of those 2L steps is
// a few microseconds of bytes and ~30 us of host work a launch, so the design
// takes the whole chain in ONE launch each way:
//   - upblur4_chain_bf16_kernel: a block owns a tile of rgb_L (CHAIN_TILE_H x
//     CHAIN_TILE_W pixels x C) and walks up from level 0 through the regions
//     the tile needs (half the region above plus a 1-pixel halo a side: 18 x
//     34, 11 x 19, ... for a 32 x 64 tile), recomputing halos instead of
//     exchanging them.  It stages every level's region of t_k in shared memory
//     up front (`cp.async`), computes each level in place over t_k, rounded to
//     bf16 where the chained launches store rgb_k, the top level into an output
//     stage laid out as y's rows, and stores that in 16-byte vectors;
//   - upblur4_adj_chain_bf16_kernel: a thread-block cluster of up to
//     ADJ_MAX_CLUSTER blocks owns one image.  Each block bulk-copies (onto an
//     mbarrier) the rows of g its strip of level L-1 reads and computes the
//     strip; after a cluster barrier, the half as tall strip of level L-2 below
//     it, its neighbours' edge rows read through distributed shared memory
//     (`map_shared_rank`); after another, rank 0 gathers level L-2 whole and
//     computes the smaller levels alone (a cluster barrier and an exchange a
//     level cost more than one block takes for them).  Where the cascade does
//     not fit CHAIN_SMEM_MAX bytes of shared memory (512 px and up at C = 3),
//     the wrapper launches those leading levels with levels = 1 first
//     (ops/upfirdn2d_cuda.py::adj_chain_split);
//   - levels = 1 is the single upblur4 / rgb + upblur4 (any C) and the single
//     adjoint (tiled, no cluster): the per-level ops are the same kernels;
//   - a row is contiguous in NHWC, so rows are copied in and out as flat runs of
//     16-byte vectors whatever C is, each from the 16-byte boundary at or below
//     its first element (a stage row keeps the run's offset from that grid);
//   - a thread computes one input pixel's 2 x 2 output quad (forward, from its
//     3 x 3 neighbourhood, the vertical sums shared by the quad) or a vertical
//     pair of output pixels (adjoint, two of their row sums shared), all C
//     channels, C = 3 at compile time: index arithmetic and edge tests once a
//     pixel, the taps loaded together from addresses clamped into the stage
//     (an element a thread ran 2-4x slower, taps loaded behind their edge tests
//     3x slower again); consecutive threads take consecutive pixels, so for odd
//     C a warp's 2-byte shared-memory reads fall in distinct banks;
//   - the arithmetic is one device function for every level and launch shape,
//     its float order fixed by intrinsics, so the L-level launch is bit-equal to
//     L chained levels = 1 launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "tc_tile.cuh"

namespace cg = cooperative_groups;

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

// ---- the bf16 skip chain ----

constexpr int CHAIN_MAX = 12;          // t_0 .. t_11 at most: levels <= 11
constexpr int CHAIN_THREADS = 256;     // the forward's block
constexpr int ADJ_THREADS = 256;       // the adjoint's block
constexpr int CHAIN_TILE_H = 32;       // a forward block's tile of the top level
constexpr int CHAIN_TILE_W = 64;
constexpr int ADJ_MIN_ROWS = 8;        // the cascade's strips of level L - 1 have at least this many rows,
constexpr int ADJ_MAX_CLUSTER = 8;     // over at most this many blocks an image (the portable cluster size)
constexpr int ADJ_TILE_ROWS = 8;       // levels = 1: output rows of a block's tile
constexpr size_t CHAIN_SMEM_SOFT = 48 * 1024;   // levels = 1 tiles shrink until they fit this
constexpr size_t CHAIN_SMEM_MAX = 200 * 1024;   // no launch takes more (mirrored in ops/upfirdn2d_cuda.py)

__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) { return __uint_as_float((uint32_t)b << 16); }
__device__ __forceinline__ unsigned short float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The element offset of `run` past the 16-byte boundary at or below it.
__device__ __forceinline__ int run_shift(const void* run) {
  return (int)((reinterpret_cast<uintptr_t>(run) & 15) >> 1);
}

// The outputs of upblur4 in rows [ra, rb) x columns [ca, cb) that input pixel (i, j) of
// the h x w level below feeds (its 2 x 2 quad), all c channels: NC at a time (CT = c when
// it is a compile-time C, so that the loops unroll; else one), every load of a group before
// its stores.  s16 is shared memory; row[d] is the element of (i - 1 + d, column 0) of the
// level below, out[d] / add[d] that of (2i + d, column ca) of the output and of t (has_add:
// there is a t), each row clamped into what is staged.  Taps are loaded unconditionally,
// from columns clamped into the staged ones [pc, pd), and those outside the image then
// taken as 0, so that a thread's loads issue together.  Per axis (f FLIPPED): y[2i] = f0
// x[i - 1] + f2 x[i], y[2i + 1] = f1 x[i] + f3 x[i + 1], the vertical sums first, then + t,
// rounded once; one order of operations for every level and launch shape.
template <int CT>
__device__ __forceinline__ void upblur4_quad_bf16(unsigned short* s16, const int (&row)[3], const int (&out)[2],
                                                  const int (&add)[2], bool has_add, int i, int j, int h, int w,
                                                  int c, int ra, int rb, int ca, int cb, int pc, int pd,
                                                  const Taps4& f) {
  constexpr int NC = CT > 0 ? CT : 1;
  const bool rows_ok[2] = {2 * i >= ra, 2 * i + 1 < rb}, cols_ok[2] = {2 * j >= ca, 2 * j + 1 < cb};
  const bool up = rows_ok[0] && i >= 1, dn = rows_ok[1] && i + 1 < h;
  const bool col[3] = {cols_ok[0] && j >= 1, true, cols_ok[1] && j + 1 < w};
  int xc[3], oc[2];  // element offsets of the columns read and written
#pragma unroll
  for (int d = 0; d < 3; ++d) xc[d] = min(max(j - 1 + d, pc), pd - 1) * c;
#pragma unroll
  for (int d = 0; d < 2; ++d) oc[d] = (min(2 * j + d, cb - 1) - ca) * c;
  for (int c0 = 0; c0 < c; c0 += NC) {
    float y[NC][2][2];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      float x[3][3], t[2][2];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int d = 0; d < 3; ++d) x[r][d] = bf16_bits_to_float(s16[row[r] + xc[d] + c0 + q]);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) t[dy][dx] = has_add ? bf16_bits_to_float(s16[add[dy] + oc[dx] + c0 + q]) : 0.f;
      float v[2][3];  // the vertical sums of the even and the odd output row at columns j - 1 .. j + 1
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float xu = col[d] && up ? x[0][d] : 0.f, xm = col[d] ? x[1][d] : 0.f;
        const float xd = col[d] && dn ? x[2][d] : 0.f;
        v[0][d] = __fmaf_rn(f.v[0], xu, __fmul_rn(f.v[2], xm));
        v[1][d] = __fmaf_rn(f.v[1], xm, __fmul_rn(f.v[3], xd));
      }
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        y[q][dy][0] = __fmaf_rn(f.v[0], v[dy][0], __fmul_rn(f.v[2], v[dy][1]));
        y[q][dy][1] = __fmaf_rn(f.v[1], v[dy][1], __fmul_rn(f.v[3], v[dy][2]));
        if (has_add)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) y[q][dy][dx] = __fadd_rn(y[q][dy][dx], t[dy][dx]);
      }
    }
#pragma unroll
    for (int q = 0; q < NC; ++q)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
          if (rows_ok[dy] && cols_ok[dx]) s16[out[dy] + oc[dx] + c0 + q] = float_to_bf16_bits(y[q][dy][dx]);
  }
}

// upblur4's adjoint at output pixels (i, j) and, where `two`, (i + 1, j), all c channels (NC
// at a time, as upblur4_quad_bf16): sum over r, s of k[r] k[s] g[2i - 1 + r, 2j - 1 + s] (k
// UNFLIPPED, g = 0 outside gh x gw), the row sums first; the pair shares the row sums of
// rows 2i + 1 and 2i + 2.  s16 is shared memory; row[r] is the element of (2i - 1 + r,
// column 0) of g there, clamped into what is staged; taps are loaded unconditionally from
// columns clamped into the staged ones [pc, pd), and those outside g then left out.
// store(di, ch, bits) takes an output.
template <int CT, class Store>
__device__ __forceinline__ void upblur4_adj_pair_bf16(const unsigned short* s16, const int (&row)[6], bool two, int i,
                                                      int j, int gh, int gw, int pc, int pd, int c, const Taps4& k,
                                                      const Store& store) {
  constexpr int NC = CT > 0 ? CT : 1;
  bool row_ok[6], col_ok[4];
  int gc[4];
#pragma unroll
  for (int r = 0; r < 6; ++r) row_ok[r] = 2 * i - 1 + r >= 0 && 2 * i - 1 + r < gh && (r < 4 || two);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    col_ok[s] = 2 * j - 1 + s >= 0 && 2 * j - 1 + s < gw;
    gc[s] = min(max(2 * j - 1 + s, pc), pd - 1) * c;
  }
  for (int c0 = 0; c0 < c; c0 += NC) {
    float acc[NC][2];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      float g[6][4], rs[6];
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) g[r][s] = bf16_bits_to_float(s16[row[r] + gc[s] + c0 + q]);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        rs[r] = 0.f;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (col_ok[s]) rs[r] = __fmaf_rn(k.v[s], g[r][s], rs[r]);
      }
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        acc[q][di] = 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (row_ok[2 * di + r]) acc[q][di] = __fmaf_rn(k.v[r], rs[2 * di + r], acc[q][di]);
      }
    }
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      store(0, c0 + q, float_to_bf16_bits(acc[q][0]));
      if (two) store(1, c0 + q, float_to_bf16_bits(acc[q][1]));
    }
  }
}

struct ChainFwdArgs {
  const bf16* t[CHAIN_MAX];  // t_0 .. t_L; t_L may be null (no add at the top level)
  bf16* y;                   // rgb_L
  int h0, w0, c, levels;     // level k is (h0 << k) x (w0 << k) x c
  int th, tw;                // a block's tile of level L
  int vecs[CHAIN_MAX + 1];   // 16-byte vectors of a staged row of level k; [levels + 1]: the output's
  int stage[CHAIN_MAX + 1];  // byte offset of those stages in shared memory
  int tabk[CHAIN_MAX + 1];   // their first entry in the row table
  int tab;                   // byte offset of the row table: an int a staged row, the element
                             // offset of the row's first element of the region
  Taps4 f;                   // FLIPPED taps
};

// rgb_L of the skip chain, or (levels = 1) upblur4(t_0) (+ t_1).
//   blockIdx.x / blockIdx.y  tile column / row of level L; blockIdx.z  image
// Every stage holds a row as the 16-byte vectors of its run in global memory (the run of
// t_k, or for the output stage the run of y), so that rows are copied in and out whole
// vectors; the levels are computed a 2 x 2 output quad a thread.
template <int CT>
__global__ void __launch_bounds__(CHAIN_THREADS) upblur4_chain_bf16_kernel(const ChainFwdArgs a) {
  extern __shared__ __align__(16) uint8_t smem_cf[];
  __shared__ int reg[CHAIN_MAX][4];  // level k's region: rows [reg[k][0], reg[k][1]), columns [2], [3])
  const int L = a.levels, C = CT > 0 ? CT : a.c, img = blockIdx.z;
  unsigned short* s16 = reinterpret_cast<unsigned short*>(smem_cf);
  int* tab = reinterpret_cast<int*>(smem_cf + a.tab);
  if (threadIdx.x == 0) {
    int r0 = blockIdx.y * a.th, c0 = blockIdx.x * a.tw;
    int r1 = min(r0 + a.th, a.h0 << L), c1 = min(c0 + a.tw, a.w0 << L);
    for (int k = L; k >= 0; --k) {
      reg[k][0] = r0, reg[k][1] = r1, reg[k][2] = c0, reg[k][3] = c1;
      if (k == 0) break;
      // what upblur4 reads for them: (i - 1, i) for an even output 2i, (i, i + 1) for an odd one
      r0 = max(0, (r0 - 1) >> 1), r1 = min(a.h0 << (k - 1), (r1 >> 1) + 1);
      c0 = max(0, (c0 - 1) >> 1), c1 = min(a.w0 << (k - 1), (c1 >> 1) + 1);
    }
  }
  __syncthreads();

  // stage every level's region of t_k, each row from the 16-byte boundary at or below its
  // first element (a vector with one element of the run lies in the run's page, so nothing
  // outside it is touched); table entries of the output stage's rows, whose runs are y's
  const int64_t hL = a.h0 << L, wL = a.w0 << L;
  for (int k = 0; k <= L + 1; ++k) {
    const int lv = min(k, L);  // the level whose region the stage holds
    const bf16* src = k <= L ? a.t[k] : a.y;
    if (src == nullptr) continue;
    const int ra = reg[lv][0], nr = reg[lv][1] - ra, ca = reg[lv][2], m = (reg[lv][3] - ca) * C;
    const int64_t hk = a.h0 << lv, wk = a.w0 << lv;
    const int nv = a.vecs[k];
    for (int u = threadIdx.x; u < nr * nv; u += blockDim.x) {
      const int lr = u / nv, v = u - lr * nv;
      const bf16* run = src + ((img * hk + ra + lr) * wk + ca) * C;
      const int shift = run_shift(run);
      if (v == 0) tab[a.tabk[k] + lr] = (a.stage[k] >> 1) + lr * nv * 8 + shift;
      if (k <= L && 8 * v < shift + m)
        fp_cp_async16(smem_cf + a.stage[k] + (lr * nv + v) * 16, run - shift + 8 * v, true);
    }
  }
  fp_cp_async_wait_all();
  __syncthreads();

  // level by level, a 2 x 2 output quad a thread: rgb_k in place over t_k's stage, rounded
  // to bf16 as a chained launch stores it; the top level into the output stage
  for (int k = 1; k <= L; ++k) {
    const int ra = reg[k][0], rb = reg[k][1], ca = reg[k][2], cb = reg[k][3];
    const int pa = reg[k - 1][0], pb = reg[k - 1][1], pc = reg[k - 1][2];
    const int hb = a.h0 << (k - 1), wb = a.w0 << (k - 1);
    const int* below = tab + a.tabk[k - 1];
    const int* add = tab + a.tabk[k];
    const int* dst = tab + a.tabk[k < L ? k : L + 1];
    const bool has_add = a.t[k] != nullptr;
    const int i0 = ra >> 1, j0 = ca >> 1, nqj = ((cb - 1) >> 1) - j0 + 1;
    const int nq = (((rb - 1) >> 1) - i0 + 1) * nqj;
    for (int u = threadIdx.x; u < nq; u += blockDim.x) {
      const int di = u / nqj;
      const int i = i0 + di, j = j0 + u - di * nqj;
      int row[3], out[2], tr[2];
#pragma unroll
      for (int d = 0; d < 3; ++d)  // rows outside the staged region are never read
        row[d] = below[min(max(i - 1 + d, pa), pb - 1) - pa] - pc * C;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int oy = min(max(2 * i + d, ra), rb - 1) - ra;
        out[d] = dst[oy];
        tr[d] = has_add ? add[oy] : 0;
      }
      upblur4_quad_bf16<CT>(s16, row, out, tr, has_add, i, j, hb, wb, C, ra, rb, ca, cb, pc, reg[k - 1][3], a.f);
    }
    __syncthreads();
  }

  // the output stage's rows to y, 16-byte vectors (element by element at a run's ends)
  const int ra = reg[L][0], nr = reg[L][1] - ra, ca = reg[L][2], m = (reg[L][3] - ca) * C;
  const int nv = a.vecs[L + 1];
  for (int u = threadIdx.x; u < nr * nv; u += blockDim.x) {
    const int lr = u / nv, v = u - lr * nv;
    bf16* run = a.y + ((img * hL + ra + lr) * wL + ca) * C;
    const int e0 = 8 * v - run_shift(run);
    const int sv = (a.stage[L + 1] >> 4) + lr * nv + v;  // the same vector in the stage
    if (e0 >= 0 && e0 + 8 <= m) {
      *reinterpret_cast<uint4*>(run + e0) = reinterpret_cast<const uint4*>(smem_cf)[sv];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (e0 + i >= 0 && e0 + i < m) reinterpret_cast<unsigned short*>(run)[e0 + i] = s16[8 * sv + i];
    }
  }
}

// Fills a's shared-memory layout for its tile; returns the bytes.
size_t chain_fwd_layout(ChainFwdArgs& a) {
  const int L = a.levels;
  int rows[CHAIN_MAX + 1], cols[CHAIN_MAX + 1];
  rows[L] = min(a.th, a.h0 << L);
  cols[L] = min(a.tw, a.w0 << L);
  for (int k = L; k > 0; --k) {  // a span of n needs at most n / 2 + 2 below it
    rows[k - 1] = min(a.h0 << (k - 1), rows[k] / 2 + 2);
    cols[k - 1] = min(a.w0 << (k - 1), cols[k] / 2 + 2);
  }
  rows[L + 1] = rows[L], cols[L + 1] = cols[L];  // the output stage
  size_t off = 0;
  int entries = 0;
  for (int k = 0; k <= L + 1; ++k) {
    a.vecs[k] = (2 * cols[k] * a.c + 29) / 16;  // a run starts up to 7 elements past a boundary
    a.stage[k] = (int)off;
    a.tabk[k] = entries;
    if (k > L || a.t[k] != nullptr) {
      off += (size_t)rows[k] * a.vecs[k] * 16;
      entries += rows[k];
    }
  }
  a.tab = (int)off;
  return off + 4 * (size_t)entries;
}

// A launch shape of the chain kernels is limited to sizes whose offsets stay in range.
inline bool chain_sizes_ok(int n, int h0, int w0, int c, int levels) {
  if (levels < 1 || levels >= CHAIN_MAX || n <= 0 || n > 65535 || h0 <= 0 || w0 <= 0 || c <= 0) return false;
  const int64_t h = (int64_t)h0 << levels, w = (int64_t)w0 << levels;
  return h <= (1 << 24) && w * c < ((int64_t)1 << 30);
}

int upblur4_chain_entry(const bf16* const* ts, bf16* y, int n, int h0, int w0, int c, int levels,
                        Taps4 f, cudaStream_t stream) {
  if (!chain_sizes_ok(n, h0, w0, c, levels)) return (int)cudaErrorInvalidValue;
  ChainFwdArgs a = {};
  for (int k = 0; k <= levels; ++k) {
    a.t[k] = ts[k];
    if (ts[k] == nullptr && k < levels) return (int)cudaErrorInvalidValue;  // only t_L may be left out
  }
  a.y = y, a.h0 = h0, a.w0 = w0, a.c = c, a.levels = levels, a.f = f;
  a.th = CHAIN_TILE_H, a.tw = CHAIN_TILE_W;
  size_t smem = chain_fwd_layout(a);
  while (smem > CHAIN_SMEM_SOFT && (a.th > 1 || a.tw > 1)) {
    if (a.tw >= a.th) a.tw = (a.tw + 1) / 2;
    else a.th = (a.th + 1) / 2;
    smem = chain_fwd_layout(a);
  }
  if (smem > CHAIN_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int64_t tiles_y = (((int64_t)h0 << levels) + a.th - 1) / a.th;
  const int64_t tiles_x = (((int64_t)w0 << levels) + a.tw - 1) / a.tw;
  if (tiles_y > 65535 || tiles_x > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // C = 3 (every ToRGB output) at compile time; any other C at run time
  const auto kernel = c == 3 ? upblur4_chain_bf16_kernel<3> : upblur4_chain_bf16_kernel<0>;
  static bool attr_set = false;
  if (!attr_set) {
    for (const auto fn : {upblur4_chain_bf16_kernel<3>, upblur4_chain_bf16_kernel<0>}) {
      cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CHAIN_SMEM_MAX);
      // all of the SM's shared memory, so that every block of a 256px chain is resident at once
      if (e == cudaSuccess) e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
      if (e != cudaSuccess) return (int)e;
    }
    attr_set = true;
  }
  kernel<<<dim3((unsigned)tiles_x, (unsigned)tiles_y, n), CHAIN_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

struct ChainAdjArgs {
  const bf16* g;             // g_L
  bf16* out[CHAIN_MAX];      // g_0 .. g_{L-1}
  int h0, w0, c, levels;     // level k is (h0 << k) x (w0 << k) x c
  int tr, tc;                // a block's part of level L - 1: rows x columns (levels > 1: a strip of
                             // whole rows, its cluster rank in order)
  int gvecs;                 // 16-byte vectors of a staged row of g
  int strip[2];              // levels > 1: byte offsets of the block's strips of levels L - 1, L - 2
  int third;                 // levels > 2: byte offset of level L - 3 whole (rank 0)
  int tab;                   // byte offset of the row table (an int a staged row of g)
  int bar;                   // byte offset of the mbarrier
  Taps4 k;                   // UNFLIPPED taps
};

// Level lev (h x w) of the adjoint, rows [ra, rb) x columns [ca, cb), a vertical pair of
// output pixels a thread, from the level above staged in s16 (row(q) the element of (q,
// column 0) of it), to global memory and, where `keep` is given, to shared memory as whole
// rows from ra.
template <int CT, class Row>
__device__ __forceinline__ void adj_level_bf16(const unsigned short* s16, const Row& row, int pc, int pd, bf16* gout,
                                               unsigned short* keep, int img, int h, int w, int c, int ra, int rb,
                                               int ca, int cb, const Taps4& k) {
  const int width = cb - ca;
  unsigned short* out = reinterpret_cast<unsigned short*>(gout);
  for (int u = threadIdx.x; u < ((rb - ra + 1) >> 1) * width; u += blockDim.x) {
    const int lp = u / width, i = ra + 2 * lp, j = ca + u - lp * width;
    int rows[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) rows[r] = row(min(max(2 * i - 1 + r, 0), 2 * h - 1));
    unsigned short* o = out + (((int64_t)img * h + i) * w + j) * c;
    unsigned short* kp = keep != nullptr ? keep + ((i - ra) * width + j - ca) * c : nullptr;
    const auto store = [&](int di, int ch, unsigned short b) {
      o[di * w * c + ch] = b;
      if (kp != nullptr) kp[di * width * c + ch] = b;
    };
    upblur4_adj_pair_bf16<CT>(s16, rows, i + 1 < rb, i, j, 2 * h, 2 * w, pc, pd, c, k, store);
  }
}

// g_{L-1} .. g_0 from g_L.
//   levels = 1: blockIdx.x / .y tile column / row of level 0, blockIdx.z image (no cluster);
//   levels > 1: blockIdx.x the block's rank in its image's cluster, blockIdx.y image.
// Each block stages the rows of g its part of level L - 1 reads (bulk copies) and computes
// that part.  For levels > 1 it keeps its strip (an even number of rows) in shared memory;
// after a cluster barrier it computes the half as tall strip of level L - 2 below it, from
// its own strip and a row of each neighbour's (distributed shared memory), and keeps that
// too.  After a second barrier rank 0 gathers the whole of level L - 2 and computes the
// smaller levels alone, a block barrier between levels: they are a sixteenth of level
// L - 1's work, and one block takes them faster than a cluster barrier and an exchange a
// level would.  Region 0 of shared memory holds, in turn, the rows of g, the neighbours'
// rows, and (rank 0) level L - 2 whole.
template <int CT>
__global__ void __launch_bounds__(ADJ_THREADS) upblur4_adj_chain_bf16_kernel(const ChainAdjArgs a) {
  extern __shared__ __align__(16) uint8_t smem_ca[];
  const int L = a.levels, C = CT > 0 ? CT : a.c;
  const bool cascade = L > 1;
  const int img = cascade ? blockIdx.y : blockIdx.z, rank = blockIdx.x;
  unsigned short* s16 = reinterpret_cast<unsigned short*>(smem_ca);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_ca + a.bar);
  int* gtab = reinterpret_cast<int*>(smem_ca + a.tab);

  // the block's part of level L - 1, and the rows and columns of g it reads
  const int hT = a.h0 << (L - 1), wT = a.w0 << (L - 1);
  const int ra = min(hT, (cascade ? rank : (int)blockIdx.y) * a.tr), rb = min(hT, ra + a.tr);
  const int ca = cascade ? 0 : blockIdx.x * a.tc, cb = min(wT, ca + a.tc);
  const int64_t hL = a.h0 << L, wL = a.w0 << L;
  const int qa = max(0, 2 * ra - 1), qb = min((int)hL, 2 * rb + 1);
  const int pa = max(0, 2 * ca - 1), pb = min((int)wL, 2 * cb + 1);
  const int gm = (pb - pa) * C;
  const bool active = rb > ra;
  if (threadIdx.x == 0) {
    fp_mbar_init(bar, 1);
    fp_mbar_init_fence();
  }
  __syncthreads();
  if (active && threadIdx.x < 32) {
    // warp 0: one bulk copy a row of g, from the 16-byte boundary at or below its run to the one
    // at or above its end; the bytes are announced before any copy is issued
    const int lane = threadIdx.x;
    uint32_t bytes = 0;
    for (int q = qa + lane; q < qb; q += 32) {
      const bf16* run = a.g + ((img * hL + q) * wL + pa) * C;
      bytes += (uint32_t)((2 * (run_shift(run) + gm) + 15) & ~15);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
    if (lane == 0) fp_mbar_expect_tx(bar, bytes);
    __syncwarp();
    for (int q = qa + lane; q < qb; q += 32) {
      const bf16* run = a.g + ((img * hL + q) * wL + pa) * C;
      const int shift = run_shift(run);
      gtab[q - qa] = (q - qa) * a.gvecs * 8 + shift;
      fp_bulk_load(smem_ca + (size_t)(q - qa) * a.gvecs * 16, run - shift, (uint32_t)((2 * (shift + gm) + 15) & ~15),
                   bar);
    }
  }
  __syncthreads();
  unsigned short* strip1 = reinterpret_cast<unsigned short*>(smem_ca + a.strip[0]);
  if (active) {
    fp_mbar_wait(bar, 0);
    adj_level_bf16<CT>(s16, [&](int q) { return gtab[min(max(q, qa), qb - 1) - qa] - pa * C; }, pa, pb, a.out[L - 1],
                       cascade ? strip1 : nullptr, img, hT, wT, C, ra, rb, ca, cb, a.k);
  }
  if (!cascade) return;

  // level L - 2 by the cluster: this block's rows [ra2, rb2) = [ra, rb) / 2 read rows
  // [ra - 1, rb] of level L - 1: its own strip, and the row of each neighbour's next to it,
  // copied to rows 0 and 1 of region 0
  cg::cluster_group cluster = cg::this_cluster();
  const int h2 = hT >> 1, w2 = wT >> 1, m1 = wT * C, t2 = a.tr >> 1;
  const int ra2 = ra >> 1, rb2 = min(h2, rb >> 1);
  unsigned short* strip2 = reinterpret_cast<unsigned short*>(smem_ca + a.strip[1]);
  cluster.sync();  // every strip of level L - 1 is in its block's shared memory
  if (rb2 > ra2)
    for (int u = threadIdx.x; u < 2 * m1; u += blockDim.x) {
      const int side = u >= m1, q = side ? rb : ra - 1;  // the row above the strip, the row below
      if (q >= 0 && q < hT)
        s16[u] = cluster.map_shared_rank(strip1, rank + (side ? 1 : -1))[(side ? 0 : a.tr - 1) * m1 + u - side * m1];
    }
  __syncthreads();
  if (rb2 > ra2) {
    const int own = a.strip[0] >> 1;  // element offset of the block's strip of level L - 1
    adj_level_bf16<CT>(s16, [&](int q) { return q < ra ? 0 : q >= rb ? m1 : own + (q - ra) * m1; }, 0, wT,
                       a.out[L - 2], L > 2 ? strip2 : nullptr, img, h2, w2, C, ra2, rb2, 0, w2, a.k);
  }
  cluster.sync();  // the strips of level L - 2 are complete, and nothing reads level L - 1's any more
  if (L == 2) return;
  if (rank == 0) {
    // the whole of level L - 2 from the strips, in rank order, into region 0; 16-byte pieces
    // where a strip is a whole number of them
    const int sb = t2 * w2 * C * 2, total = h2 * w2 * C * 2;
    for (int r = 0; r * t2 < h2; ++r) {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(cluster.map_shared_rank(strip2, r));
      const int bytes = min(sb, total - r * sb);
      if (sb % 16 == 0 && bytes % 16 == 0)
        for (int o = 16 * threadIdx.x; o < bytes; o += 16 * blockDim.x)
          *reinterpret_cast<uint4*>(smem_ca + r * sb + o) = *reinterpret_cast<const uint4*>(src + o);
      else
        for (int o = 2 * threadIdx.x; o < bytes; o += 2 * blockDim.x)
          *reinterpret_cast<unsigned short*>(smem_ca + r * sb + o) = *reinterpret_cast<const unsigned short*>(src + o);
    }
  }
  cluster.sync();  // the other blocks' strips are read: they may leave
  if (rank != 0) return;
  for (int lev = L - 3; lev >= 0; --lev) {
    __syncthreads();
    const int h = a.h0 << lev, w = a.w0 << lev;
    // levels alternate between region 0 (L - 2, L - 4, ...) and the third region (L - 3, ...)
    const uint8_t* above = (L - 3 - lev) % 2 == 0 ? smem_ca : smem_ca + a.third;
    unsigned short* next = lev == 0 ? nullptr
                                    : reinterpret_cast<unsigned short*>((L - 3 - lev) % 2 == 0 ? smem_ca + a.third
                                                                                              : smem_ca);
    const int ms = 2 * w * C;  // elements of a row of level lev + 1
    adj_level_bf16<CT>(reinterpret_cast<const unsigned short*>(above), [&](int q) { return q * ms; }, 0, 2 * w,
                       a.out[lev], next, img, h, w, C, 0, h, 0, w, a.k);
  }
}

// Fills a's layout for a cascade of a.levels > 1 over `cluster` blocks an image; returns the
// shared-memory bytes (ops/upfirdn2d_cuda.py::adj_cascade_smem computes the same): region 0
// (the rows of g a strip of level L - 1 reads; the two rows of level L - 1 next to a strip;
// level L - 2 whole), the block's strips of levels L - 1 and L - 2, level L - 3 whole, the
// row table and the mbarrier.
size_t adj_cascade_layout(ChainAdjArgs& a, int cluster) {
  const int L = a.levels, hT = a.h0 << (L - 1), wT = a.w0 << (L - 1);
  a.tr = 2 * ((hT + 2 * cluster - 1) / (2 * cluster)), a.tc = wT;  // strips of an even number of rows
  const int grows = min(a.h0 << L, 2 * a.tr + 2);
  a.gvecs = (2 * (a.w0 << L) * a.c + 29) / 16;
  const auto align16 = [](size_t b) { return (b + 15) & ~(size_t)15; };
  const size_t row1 = (size_t)wT * a.c * 2;  // bytes of a row of level L - 1
  size_t region0 = (size_t)grows * a.gvecs * 16;
  region0 = std::max(region0, align16(2 * row1));
  region0 = std::max(region0, align16((size_t)hT * row1 / 4));
  a.strip[0] = (int)region0;
  a.strip[1] = a.strip[0] + (int)align16(a.tr * row1);
  a.third = a.strip[1] + (int)align16(a.tr * row1 / 4);
  a.tab = a.third + (int)align16((size_t)hT * row1 / 16);
  a.bar = (a.tab + 4 * grows + 7) & ~7;
  return (size_t)a.bar + 8;
}

int upblur4_adj_chain_entry(const bf16* g, bf16* const* outs, int n, int h0, int w0, int c, int levels, Taps4 k,
                            cudaStream_t stream) {
  if (!chain_sizes_ok(n, h0, w0, c, levels)) return (int)cudaErrorInvalidValue;
  ChainAdjArgs a = {};
  a.g = g, a.h0 = h0, a.w0 = w0, a.c = c, a.levels = levels, a.k = k;
  for (int lev = 0; lev < levels; ++lev) a.out[lev] = outs[lev];
  const auto kernel = c == 3 ? upblur4_adj_chain_bf16_kernel<3> : upblur4_adj_chain_bf16_kernel<0>;
  static bool attr_set = false;
  if (!attr_set) {
    for (const auto fn : {upblur4_adj_chain_bf16_kernel<3>, upblur4_adj_chain_bf16_kernel<0>}) {
      cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CHAIN_SMEM_MAX);
      if (e == cudaSuccess) e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
      if (e != cudaSuccess) return (int)e;
    }
    attr_set = true;
  }
  if (levels == 1) {
    // tiles of ADJ_TILE_ROWS x w0 output pixels, narrowed, then shortened, until they fit
    a.tr = min(ADJ_TILE_ROWS, h0), a.tc = w0;
    const auto layout = [&] {
      const int grows = min(2 * h0, 2 * a.tr + 2);
      a.gvecs = (2 * min(2 * w0, 2 * a.tc + 2) * c + 29) / 16;
      a.tab = grows * a.gvecs * 16;
      a.bar = (a.tab + 4 * grows + 7) & ~7;
      return (size_t)a.bar + 8;
    };
    size_t smem = layout();
    while (smem > CHAIN_SMEM_SOFT && (a.tc > 1 || a.tr > 1)) {
      if (a.tc > 1) a.tc = (a.tc + 1) / 2;
      else a.tr = (a.tr + 1) / 2;
      smem = layout();
    }
    if (smem > CHAIN_SMEM_MAX) return (int)cudaErrorInvalidValue;
    const int tiles_y = (h0 + a.tr - 1) / a.tr, tiles_x = (w0 + a.tc - 1) / a.tc;
    if (tiles_y > 65535) return (int)cudaErrorInvalidValue;
    kernel<<<dim3(tiles_x, tiles_y, n), ADJ_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int cluster = min(ADJ_MAX_CLUSTER, max(1, (h0 << (levels - 1)) / ADJ_MIN_ROWS));
  const size_t smem = adj_cascade_layout(a, cluster);
  if (smem > CHAIN_SMEM_MAX) return (int)cudaErrorInvalidValue;  // the wrapper splits such chains
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n, 1);
  cfg.blockDim = dim3(ADJ_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
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

// The skip chain: y = rgb_L of rgb_0 = ts[0], rgb_k = ts[k] + upblur4(rgb_{k-1}), ts[k] of
// n x (h0 << k) x (w0 << k) x c, ts a host array of levels + 1 pointers (ts[levels] may be
// null: no add at the top).  levels = 1 is upblur4(ts[0]) (+ ts[1]).  f: FLIPPED taps.
int fp_upblur4_bf16(const bf16* const* ts, bf16* y, int n, int h0, int w0, int c, int levels, float f0,
                    float f1, float f2, float f3, void* stream) {
  return upblur4_chain_entry(ts, y, n, h0, w0, c, levels, Taps4{{f0, f1, f2, f3}}, (cudaStream_t)stream);
}

int fp_upblur4_adj_f32(const float* g, float* dx, int n, int h, int w, int c, float k0, float k1,
                       float k2, float k3, void* stream) {
  return upblur4_adj_entry<float>(g, dx, n, h, w, c, Taps4{{k0, k1, k2, k3}}, (cudaStream_t)stream);
}

// The cotangent cascade: outs[k] = g_k for k = levels - 1 .. 0, g_levels = g of
// n x (h0 << levels) x (w0 << levels) x c, g_{k-1} = adj(g_k); outs a host array of
// `levels` pointers.  k: UNFLIPPED taps.
int fp_upblur4_adj_bf16(const bf16* g, bf16* const* outs, int n, int h0, int w0, int c, int levels, float k0,
                        float k1, float k2, float k3, void* stream) {
  return upblur4_adj_chain_entry(g, outs, n, h0, w0, c, levels, Taps4{{k0, k1, k2, k3}}, (cudaStream_t)stream);
}

}  // extern "C"
