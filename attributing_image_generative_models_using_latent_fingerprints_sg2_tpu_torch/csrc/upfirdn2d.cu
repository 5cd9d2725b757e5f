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
// What bounds them on the H100: device-memory bytes.  Each output reads 16
// (blur4) or 4 (upblur4) inputs that neighbouring threads share through L1/L2,
// and does 2 flops per tap, far below the card's flop/byte balance.  Design:
// one thread per output element, threads consecutive in the channel axis, so
// every warp reads and writes contiguous NHWC runs (coalesced) and the halo
// re-reads hit the cache.  No shared memory, no tiling: the simple form is
// within reach of the byte bound already, and is easy to verify.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps4 {
  float v[4];
};

// y[b, oy, ox, c] = sum_{i,j} fy[i] * fx[j] * x[b, oy + i - py0, ox + j - px0, c]
// (zero outside the input).  fy/fx are the FLIPPED taps: correlation with the
// flipped kernel is upfirdn2d's convolution.
__global__ void blur4_kernel(const float* __restrict__ x, float* __restrict__ y, int n, int h,
                             int w, int c, int oh, int ow, int py0, int px0, Taps4 fy,
                             Taps4 fx) {
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
    const int iy = oy + i - py0;
    if (iy < 0 || iy >= h) continue;
    float row = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ix = ox + j - px0;
      if (ix < 0 || ix >= w) continue;
      row += fx.v[j] * xb[((int64_t)iy * w + ix) * c];
    }
    acc += fy.v[i] * row;
  }
  y[idx] = acc;
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
  const int64_t total = (int64_t)n * oh * ow * c;
  if (total <= 0) return (int)cudaErrorInvalidValue;
  Taps4 fy = {{fy0, fy1, fy2, fy3}};
  Taps4 fx = {{fx0, fx1, fx2, fx3}};
  blur4_kernel<<<blocks_for(total, 256), 256, 0, (cudaStream_t)stream>>>(x, y, n, h, w, c, oh,
                                                                          ow, py0, px0, fy, fx);
  return (int)cudaGetLastError();
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
