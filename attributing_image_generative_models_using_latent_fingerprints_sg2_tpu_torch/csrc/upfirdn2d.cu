// 4-tap separable FIR kernels of the StyleGAN2 synthesis network, NHWC float32.
//
// blur4   replaces ops/upfirdn2d_pallas.py::blur4 (_blur4_kernel): up=down=1,
//         pads (p0, p1) per axis, out = in + p0 + p1 - 3.  On the main path it is
//         the post-transpose blur of every upsample styled conv.  Its backward is
//         the same kernel with flipped taps and pads (3 - p0, 3 - p1).
// upblur4 replaces ops/upfirdn2d_pallas.py::upblur4 (_upblur4_kernel): up=2,
//         pad (2, 1), out = 2 * in.  The zero-stuffed map never exists: each
//         output takes the 2 taps per axis that its parity selects.  On the main
//         path it is the ToRGB skip upsample (C = 3).
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
// upblur4.  One thread per output element, threads consecutive in the channel
// axis; at C = 3 its six launches a step are bound by launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps4 {
  float v[4];
};

constexpr int BLUR_THREADS = 256;

// V floats of consecutive channels: one 16-byte or one 4-byte load / store.
template <int V>
struct Vec {
  float v[V];
};
template <int V>
__device__ __forceinline__ Vec<V> vec_load(const float* p);
template <>
__device__ __forceinline__ Vec<4> vec_load<4>(const float* p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  return {{t.x, t.y, t.z, t.w}};
}
template <>
__device__ __forceinline__ Vec<1> vec_load<1>(const float* p) {
  return {{__ldg(p)}};
}
__device__ __forceinline__ void vec_store(float* p, const Vec<4>& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}
__device__ __forceinline__ void vec_store(float* p, const Vec<1>& a) { *p = a.v[0]; }

// y[b, oy, ox, c] = sum_{i,j} fy[i] * fx[j] * x[b, oy + i - py0, ox + j - px0, c]
// (zero outside the input).  fy/fx are the FLIPPED taps: correlation with the
// flipped kernel is upfirdn2d's convolution.
//   blockDim.x  channel vectors (of V channels) per block, blockDim.y output columns
//   blockIdx.x  column tile * cgroups + channel group; blockIdx.y row strip of
//               `rows` output rows; blockIdx.z image
template <int V>
__global__ void __launch_bounds__(BLUR_THREADS)
    blur4_kernel(const float* __restrict__ x, float* __restrict__ y, int h, int w, int c, int oh,
                 int ow, int py0, int px0, int rows, int cgroups, Taps4 fy, Taps4 fx) {
  const int cg = blockIdx.x % cgroups;
  const int tile = blockIdx.x / cgroups;
  const int ch = (cg * blockDim.x + threadIdx.x) * V;
  const int ox = tile * blockDim.y + threadIdx.y;
  if (ch >= c || ox >= ow) return;
  const int oy0 = blockIdx.y * rows;
  const int nrows = min(rows, oh - oy0);
  const float* xb = x + (int64_t)blockIdx.z * h * w * c + (int64_t)(ox - px0) * c + ch;
  float* yb = y + ((int64_t)blockIdx.z * oh * ow + ox) * c + ch;

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
    const float* xr = xb + (int64_t)iy * w * c;
    Vec<V> in[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (row_ok && col_ok[j]) {
        in[j] = vec_load<V>(xr + (int64_t)j * c);
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
      vec_store(yb + (int64_t)(oy0 + r - 3) * ow * c, o);
    }
  }
}

template <int V>
cudaError_t blur4_launch(const float* x, float* y, int n, int h, int w, int c, int oh, int ow,
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
  blur4_kernel<V><<<grid, dim3(bx, by), 0, stream>>>(x, y, h, w, c, oh, ow, py0, px0, rows, cgroups,
                                                      fy, fx);
  return cudaGetLastError();
}

// upfirdn2d(x, outer(k, k), up=2, pad=(2, 1)) with f = flipped k:
// y[t] = sum_j f[j] * u[t + j - 2], where u[2i] = x[i] and u is 0 at odd index.
__global__ void upblur4_kernel(const float* __restrict__ x, float* __restrict__ y, int n, int h,
                               int w, int c, Taps4 f) {
  const int oh = 2 * h, ow = 2 * w;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)n * oh * ow * c;
  if (idx >= total) return;
  const int ci = (int)(idx % c);
  int64_t t = idx / c;
  const int ox = (int)(t % ow);
  t /= ow;
  const int oy = (int)(t % oh);
  const int b = (int)(t / oh);
  const float* xb = x + (int64_t)b * h * w * c + ci;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int my = oy + i - 2;
    if (my < 0 || (my & 1)) continue;
    const int iy = my >> 1;
    if (iy >= h) continue;
    float row = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int mx = ox + j - 2;
      if (mx < 0 || (mx & 1)) continue;
      const int ix = mx >> 1;
      if (ix >= w) continue;
      row += f.v[j] * xb[((int64_t)iy * w + ix) * c];
    }
    acc += f.v[i] * row;
  }
  y[idx] = acc;
}

inline unsigned blocks_for(int64_t total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* fp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int fp_blur4_f32(const float* x, float* y, int n, int h, int w, int c, int oh, int ow, int py0,
                 int px0, float fy0, float fy1, float fy2, float fy3, float fx0, float fx1,
                 float fx2, float fx3, void* stream) {
  if (n <= 0 || c <= 0 || oh <= 0 || ow <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  Taps4 fy = {{fy0, fy1, fy2, fy3}};
  Taps4 fx = {{fx0, fx1, fx2, fx3}};
  const bool vec4 = c % 4 == 0 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (vec4)
    return (int)blur4_launch<4>(x, y, n, h, w, c, oh, ow, py0, px0, fy, fx, (cudaStream_t)stream);
  return (int)blur4_launch<1>(x, y, n, h, w, c, oh, ow, py0, px0, fy, fx, (cudaStream_t)stream);
}

int fp_upblur4_f32(const float* x, float* y, int n, int h, int w, int c, float f0, float f1,
                   float f2, float f3, void* stream) {
  const int64_t total = (int64_t)n * 4 * h * w * c;
  if (total <= 0) return (int)cudaErrorInvalidValue;
  Taps4 f = {{f0, f1, f2, f3}};
  upblur4_kernel<<<blocks_for(total, 256), 256, 0, (cudaStream_t)stream>>>(x, y, n, h, w, c, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
