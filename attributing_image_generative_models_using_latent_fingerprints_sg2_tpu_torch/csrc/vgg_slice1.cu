// VGG16 slice 1 (relu1_2) fused: a2 = relu(conv(relu(conv(x, w1) + b1), w2) + b2),
// 3 -> 64 -> 64 channels, NHWC float32, with a backward kernel for dx.
//
// Replaces ops/vgg_slice_pallas.py::vgg_slice1: the forward _slice1_fwd_kernel
// (via _slice1_fwd_call) and the backward _slice1_bwd_kernel (via
// _slice1_bwd_call).  On the 256px main path it runs on [B, 256, 256, 3] in
// every solve step's forward and backward.
//
// What bounds it on the H100: the 64 -> 64 conv's arithmetic (576
// multiply-adds per output on the float32 CUDA cores), and, for an unfused
// spelling, the bytes of the [B, 256, 256, 64] intermediate relu1_1 that
// would be written and read back.  Design: relu1_1 (forward) and dz1
// (backward) live only in shared memory.
//   forward  A block owns an 8x8 output tile.  It loads x with a 2-pixel halo,
//            computes a1 = relu(conv1(x) + b1) for the tile plus a 1-pixel halo
//            into shared memory, zeroing a1 outside the image (conv2's zero
//            padding), then runs conv2 + b2 + ReLU with the 64-channel tile
//            routine of conv_tile.cuh, weights streamed in 16-channel chunks.
//   backward A block owns a 6x6 dx tile.  dz2 = g * [a2 > 0] on a 2-pixel halo
//            (zero outside the image); da1 = conv_T(dz2, w2) on the tile plus a
//            1-pixel halo, i.e. an 8x8 region, through the same tile routine
//            with flipped, in/out-swapped w2; dz1 = da1 * [conv1(x) + b1 > 0]
//            with conv1 recomputed for its sign and dz1 zeroed outside the
//            image; dx = conv_T(dz1, w1) into the 6x6 x 3 tile.  The halo
//            recompute (64 da1 pixels for 36 dx pixels) is the price of keeping
//            every intermediate on chip.

#include "conv_tile.cuh"

namespace {

// ---- forward shared-memory layout (floats) ----
constexpr int F_XW = FP_TILE + 4;                      // x band width (2-pixel halo)
constexpr int F_XS = F_XW * F_XW * 3;                  // 432
constexpr int F_W1 = 27 * 64;                          // 1728
constexpr int F_A1 = FP_HALO_W * FP_HALO_W * 64;       // 6400
constexpr int F_W2 = 9 * FP_KC * FP_CO_TILE;           // 9216
constexpr int F_OFF_W1 = F_XS;
constexpr int F_OFF_B1 = F_OFF_W1 + F_W1;
constexpr int F_OFF_A1 = F_OFF_B1 + 64;                // 2224: 16-byte aligned
constexpr int F_OFF_W2 = F_OFF_A1 + F_A1;              // 8624: 16-byte aligned
constexpr int F_FLOATS = F_OFF_W2 + F_W2;
constexpr size_t F_BYTES = sizeof(float) * F_FLOATS;   // 71360

// ---- backward shared-memory layout (floats) ----
constexpr int B_TILE = FP_TILE - 2;                    // 6x6 dx tile
constexpr int B_DZ2 = FP_HALO_W * FP_HALO_W * 64;      // 10x10 region, offset -2
constexpr int B_DZ1 = FP_TILE * FP_TILE * 64;          // 8x8 region, offset -1
constexpr int B_XS = FP_HALO_W * FP_HALO_W * 3;        // 10x10 x band, offset -2
constexpr int B_OFF_DZ1 = B_DZ2;                       // 6400
constexpr int B_OFF_W2 = B_OFF_DZ1 + B_DZ1;            // 10496: 16-byte aligned
constexpr int B_OFF_XS = B_OFF_W2 + F_W2;
constexpr int B_OFF_W1 = B_OFF_XS + B_XS;
constexpr int B_OFF_B1 = B_OFF_W1 + F_W1;
constexpr int B_OFF_W1F = B_OFF_B1 + 64;
constexpr int B_FLOATS = B_OFF_W1F + F_W1;
constexpr size_t B_BYTES = sizeof(float) * B_FLOATS;   // 94128

__global__ void __launch_bounds__(FP_THREADS)
    slice1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2,
                      const float* __restrict__ b2, float* __restrict__ y, int h, int wd) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* w1s = smem + F_OFF_W1;
  float* b1s = smem + F_OFF_B1;
  float* a1 = smem + F_OFF_A1;
  float* w2s = smem + F_OFF_W2;

  const int tiles_x = (wd + FP_TILE - 1) / FP_TILE;
  const int ty0 = (blockIdx.x / tiles_x) * FP_TILE;
  const int tx0 = (blockIdx.x % tiles_x) * FP_TILE;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* xb = x + (int64_t)b * h * wd * 3;

  for (int i = tid; i < F_XS; i += FP_THREADS) {
    const int k = i % 3;
    const int p = i / 3;
    const int iy = ty0 - 2 + p / F_XW;
    const int ix = tx0 - 2 + p % F_XW;
    float v = 0.f;
    if (iy >= 0 && iy < h && ix >= 0 && ix < wd) v = xb[((int64_t)iy * wd + ix) * 3 + k];
    xs[i] = v;
  }
  for (int i = tid; i < F_W1; i += FP_THREADS) w1s[i] = w1[i];
  if (tid < 64) b1s[tid] = b1[tid];
  __syncthreads();

  // a1 on the 10x10 region at offset -1, zero outside the image
  for (int i = tid; i < F_A1; i += FP_THREADS) {
    const int co = i % 64;
    const int p = i / 64;
    const int r = p / FP_HALO_W;
    const int q = p % FP_HALO_W;
    const int ay = ty0 - 1 + r;
    const int ax = tx0 - 1 + q;
    float v = 0.f;
    if (ay >= 0 && ay < h && ax >= 0 && ax < wd) {
      float z = b1s[co];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
            z = fmaf(xs[((r + dy) * F_XW + q + dx) * 3 + ci], w1s[((dy * 3 + dx) * 3 + ci) * 64 + co], z);
      v = fmaxf(z, 0.f);
    }
    a1[i] = v;
  }
  __syncthreads();

  const int cg = tid & 15;
  const int pg = tid >> 4;
  const int prow = pg >> 1;
  const int pcol0 = (pg & 1) * 4;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  for (int ci0 = 0; ci0 < 64; ci0 += FP_KC) {
    fp_load_weight_chunk(w2s, w2, 64, 64, ci0, 0);
    __syncthreads();
    fp_conv_tile_chunk(a1, 64, ci0, w2s, prow, pcol0, cg, acc);
    __syncthreads();
  }

  const int oy = ty0 + prow;
  if (oy >= h) return;
  const int co = cg * 4;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int ox = tx0 + pcol0 + p;
    if (ox >= wd) continue;
    float4 o;
    o.x = fmaxf(acc[p][0] + b2[co + 0], 0.f);
    o.y = fmaxf(acc[p][1] + b2[co + 1], 0.f);
    o.z = fmaxf(acc[p][2] + b2[co + 2], 0.f);
    o.w = fmaxf(acc[p][3] + b2[co + 3], 0.f);
    *reinterpret_cast<float4*>(y + (((int64_t)b * h + oy) * wd + ox) * 64 + co) = o;
  }
}

// w1: HWIO [3,3,3,64]; w1f = flip_io(w1): [3,3,64,3]; w2f = flip_io(w2): [3,3,64,64].
__global__ void __launch_bounds__(FP_THREADS)
    slice1_bwd_kernel(const float* __restrict__ g, const float* __restrict__ a2,
                      const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w1f,
                      const float* __restrict__ w2f, float* __restrict__ dx, int h, int wd) {
  extern __shared__ __align__(16) float smem[];
  float* dz2 = smem;
  float* dz1 = smem + B_OFF_DZ1;
  float* w2s = smem + B_OFF_W2;
  float* xs = smem + B_OFF_XS;
  float* w1s = smem + B_OFF_W1;
  float* b1s = smem + B_OFF_B1;
  float* w1fs = smem + B_OFF_W1F;

  const int tiles_x = (wd + B_TILE - 1) / B_TILE;
  const int ty0 = (blockIdx.x / tiles_x) * B_TILE;
  const int tx0 = (blockIdx.x % tiles_x) * B_TILE;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int64_t img = (int64_t)b * h * wd;

  // dz2 = g * [a2 > 0] on the 10x10 region at offset -2, zero outside the image
  for (int i = tid; i < B_DZ2; i += FP_THREADS) {
    const int co = i % 64;
    const int p = i / 64;
    const int gy = ty0 - 2 + p / FP_HALO_W;
    const int gx = tx0 - 2 + p % FP_HALO_W;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      const int64_t off = (img + (int64_t)gy * wd + gx) * 64 + co;
      v = a2[off] > 0.f ? g[off] : 0.f;
    }
    dz2[i] = v;
  }
  for (int i = tid; i < B_XS; i += FP_THREADS) {
    const int k = i % 3;
    const int p = i / 3;
    const int gy = ty0 - 2 + p / FP_HALO_W;
    const int gx = tx0 - 2 + p % FP_HALO_W;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) v = x[(img + (int64_t)gy * wd + gx) * 3 + k];
    xs[i] = v;
  }
  for (int i = tid; i < F_W1; i += FP_THREADS) {
    w1s[i] = w1[i];
    w1fs[i] = w1f[i];
  }
  if (tid < 64) b1s[tid] = b1[tid];
  __syncthreads();

  // da1 = conv(dz2, w2f) on the 8x8 region at offset -1
  const int cg = tid & 15;
  const int pg = tid >> 4;
  const int prow = pg >> 1;
  const int pcol0 = (pg & 1) * 4;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  for (int ci0 = 0; ci0 < 64; ci0 += FP_KC) {
    fp_load_weight_chunk(w2s, w2f, 64, 64, ci0, 0);
    __syncthreads();
    fp_conv_tile_chunk(dz2, 64, ci0, w2s, prow, pcol0, cg, acc);
    __syncthreads();
  }

  // dz1 = da1 * [conv1(x) + b1 > 0], zero outside the image
  const int gy = ty0 - 1 + prow;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int q = pcol0 + p;
    const int gx = tx0 - 1 + q;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = cg * 4 + j;
      float z = b1s[co];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dxx = 0; dxx < 3; ++dxx)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
            z = fmaf(xs[((prow + dy) * FP_HALO_W + q + dxx) * 3 + ci],
                     w1s[((dy * 3 + dxx) * 3 + ci) * 64 + co], z);
      dz1[(prow * FP_TILE + q) * 64 + co] = (inside && z > 0.f) ? acc[p][j] : 0.f;
    }
  }
  __syncthreads();

  // dx = conv(dz1, w1f) on the 6x6 tile, 3 channels
  if (tid < B_TILE * B_TILE * 3) {
    const int c = tid % 3;
    const int p = tid / 3;
    const int r = p / B_TILE;
    const int q = p % B_TILE;
    const int oy = ty0 + r;
    const int ox = tx0 + q;
    if (oy < h && ox < wd) {
      float s = 0.f;
      for (int dy = 0; dy < 3; ++dy)
        for (int dxx = 0; dxx < 3; ++dxx) {
          const float* zrow = dz1 + ((r + dy) * FP_TILE + q + dxx) * 64;
          const float* wrow = w1fs + (dy * 3 + dxx) * 64 * 3 + c;
#pragma unroll 8
          for (int k = 0; k < 64; ++k) s = fmaf(zrow[k], wrow[k * 3], s);
        }
      dx[(img + (int64_t)oy * wd + ox) * 3 + c] = s;
    }
  }
}

}  // namespace

extern "C" {

int fp_vgg_slice1_fwd_f32(const float* x, const float* w1, const float* b1, const float* w2,
                          const float* b2, float* y, int n, int h, int wd, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(slice1_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((h + FP_TILE - 1) / FP_TILE) * ((wd + FP_TILE - 1) / FP_TILE);
  dim3 grid(tiles, 1, n);
  slice1_fwd_kernel<<<grid, FP_THREADS, F_BYTES, (cudaStream_t)stream>>>(x, w1, b1, w2, b2, y, h,
                                                                          wd);
  return (int)cudaGetLastError();
}

int fp_vgg_slice1_bwd_f32(const float* g, const float* a2, const float* x, const float* w1,
                          const float* b1, const float* w1f, const float* w2f, float* dx, int n,
                          int h, int wd, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(slice1_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((h + B_TILE - 1) / B_TILE) * ((wd + B_TILE - 1) / B_TILE);
  dim3 grid(tiles, 1, n);
  slice1_bwd_kernel<<<grid, FP_THREADS, B_BYTES, (cudaStream_t)stream>>>(g, a2, x, w1, b1, w1f,
                                                                          w2f, dx, h, wd);
  return (int)cudaGetLastError();
}

}  // extern "C"
