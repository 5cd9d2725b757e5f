// relu(conv3x3(x, w, stride 1, pad 1) + b), NHWC float32, C_in == C_out.
//
// Replaces ops/vgg_pallas.py::conv3x3_relu (_conv3x3_kernel via _conv3x3_call):
// the LPIPS VGG16 square convs (128@128^2, 256@64^2, 512@32^2, 512@16^2 on the
// 256px main path).  Bias and ReLU are flags, so the same kernel computes the
// backward's dx as a plain conv of the ReLU-masked cotangent with spatially
// flipped, in/out-swapped taps (the wrapper prepares both).
//
// What bounds it on the H100: arithmetic.  At C >= 128 each output does 9*C
// multiply-adds per 4-byte store, far above the flop/byte balance, and this
// simple kernel runs on the float32 CUDA cores (no tensor cores), so its
// ceiling is the 67 TFLOP/s float32 rate.  Design: a block computes an 8x8
// pixel x 64 out-channel tile; the input band (tile + 1-pixel halo, zero
// outside the image: the conv's padding) and the weights stream through
// shared memory in 16-channel chunks; every thread keeps 4 pixels x 4
// channels of float32 accumulators in registers and reuses each shared load
// across 12 or 16 multiply-adds (conv_tile.cuh).

#include "conv_tile.cuh"

namespace {

__global__ void __launch_bounds__(FP_THREADS)
    conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y, int h, int wd, int c,
                   int relu) {
  __shared__ __align__(16) float in_s[FP_HALO_W * FP_HALO_W * FP_KC];
  __shared__ __align__(16) float w_s[9 * FP_KC * FP_CO_TILE];

  const int tiles_x = (wd + FP_TILE - 1) / FP_TILE;
  const int ty0 = (blockIdx.x / tiles_x) * FP_TILE;
  const int tx0 = (blockIdx.x % tiles_x) * FP_TILE;
  const int co0 = blockIdx.y * FP_CO_TILE;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid & 15;
  const int pg = tid >> 4;
  const int prow = pg >> 1;
  const int pcol0 = (pg & 1) * 4;
  const float* xb = x + (int64_t)b * h * wd * c;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int ci0 = 0; ci0 < c; ci0 += FP_KC) {
    for (int i = tid; i < FP_HALO_W * FP_HALO_W * FP_KC; i += FP_THREADS) {
      const int k = i % FP_KC;
      const int p = i / FP_KC;
      const int iy = ty0 - 1 + p / FP_HALO_W;
      const int ix = tx0 - 1 + p % FP_HALO_W;
      float v = 0.f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd) v = xb[((int64_t)iy * wd + ix) * c + ci0 + k];
      in_s[i] = v;
    }
    fp_load_weight_chunk(w_s, w, c, c, ci0, co0);
    __syncthreads();
    fp_conv_tile_chunk(in_s, FP_KC, 0, w_s, prow, pcol0, cg, acc);
    __syncthreads();
  }

  const int oy = ty0 + prow;
  if (oy >= h) return;
  const int co = co0 + cg * 4;
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr) {
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = bias[co + q];
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int ox = tx0 + pcol0 + p;
    if (ox >= wd) continue;
    float4 o;
    o.x = acc[p][0] + bv[0];
    o.y = acc[p][1] + bv[1];
    o.z = acc[p][2] + bv[2];
    o.w = acc[p][3] + bv[3];
    if (relu) {
      o.x = fmaxf(o.x, 0.f);
      o.y = fmaxf(o.y, 0.f);
      o.z = fmaxf(o.z, 0.f);
      o.w = fmaxf(o.w, 0.f);
    }
    *reinterpret_cast<float4*>(y + (((int64_t)b * h + oy) * wd + ox) * c + co) = o;
  }
}

}  // namespace

extern "C" {

// bias may be null (no bias).  c must be a multiple of 64.
int fp_conv3x3_f32(const float* x, const float* w, const float* bias, float* y, int n, int h,
                   int wd, int c, int relu, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c % FP_CO_TILE != 0) return (int)cudaErrorInvalidValue;
  const int tiles = ((h + FP_TILE - 1) / FP_TILE) * ((wd + FP_TILE - 1) / FP_TILE);
  dim3 grid(tiles, c / FP_CO_TILE, n);
  conv3x3_kernel<<<grid, FP_THREADS, 0, (cudaStream_t)stream>>>(x, w, bias, y, h, wd, c, relu);
  return (int)cudaGetLastError();
}

}  // extern "C"
