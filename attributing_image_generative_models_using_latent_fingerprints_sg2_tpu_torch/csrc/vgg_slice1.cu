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
// would be written and read back.  Design: relu1_1 (forward) and dz2, dz1
// (backward) live only in shared memory.
//   forward  A block owns an 8x8 output tile.  It loads x with a 2-pixel halo,
//            computes a1 = relu(conv1(x) + b1) for the tile plus a 1-pixel halo
//            into shared memory, zeroing a1 outside the image (conv2's zero
//            padding), then runs conv2 + b2 + ReLU with the 64-channel tile
//            routine of conv_tile.cuh, weights streamed in 16-channel chunks.
//   backward (redesigned for the tensor cores)  The 64 -> 64 adjoint conv is
//            4.83 of the 5.28 GFLOP per image; with g and a2 at 16.8 MB each the
//            bytes cost 0.16 ms per 16-image step and the flops 1.27 ms on the
//            CUDA cores, 0.5 ms as a three-pass TF32 product (tc_tile.cuh).  A
//            512-thread block (4 warpgroups, one an SM) owns a 14x14 dx tile:
//            dz2 = g * [a2 > 0] on the tile plus a 2-pixel halo (18x18, zero
//            outside the image) goes to shared memory in the band layout of
//            tc_tile.cuh; da1 = conv_T(dz2, w2) on 16x16 (M = 256, one 64-row
//            `wgmma` tile a warpgroup, halo recompute 1.31x) runs through
//            fp_tc_tap with the packed adjoint w2 streaming through a ring of
//            four 16 KB stages (bulk async copies, mbarriers); the CUDA cores
//            recompute conv1's sign with the forward kernel's exact fmaf
//            order, one bit per accumulator element; dz1 = da1 * [conv1(x) + b1 > 0] (zero outside the
//            image) overwrites dz2's space once every warpgroup is done with
//            it; dx = conv_T(dz1, w1) is the same tile routine with N padded
//            from 3 to 8 and the packed adjoint w1 (36 KB) resident in shared
//            memory.  Neither relu1_1 nor dz1 nor dz2 reaches device memory.

#include "conv_tile.cuh"
#include "tc_tile.cuh"

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

// ---- backward: tile geometry and shared-memory layout ----
constexpr int B_TILE = 14;                              // dx tile
constexpr int B_R1 = B_TILE + 2;                        // da1 / dz1 region, offset -1
constexpr int B_R2 = B_TILE + 4;                        // dz2 / x region, offset -2
constexpr int B_THREADS = 512;
constexpr int B_STAGES = 4;
constexpr int B_STAGE_FLOATS = 2 * 64 * FP_TC_KC;       // hi + lo of one tap x chunk of w2f
constexpr int B_W1F_FLOATS = 18 * 2 * 8 * FP_TC_KC;     // all of the packed adjoint w1
constexpr int B_BAND_FLOATS = B_R2 * B_R2 * FP_TC_CS;   // one 32-channel chunk of dz2 / dz1
constexpr int B_XS = B_R2 * B_R2 * 3;
constexpr int B_OFF_W1F = B_STAGES * B_STAGE_FLOATS;    // ring first: 1024-byte aligned tiles
constexpr int B_OFF_BAND = B_OFF_W1F + B_W1F_FLOATS;
constexpr int B_OFF_XS = B_OFF_BAND + 2 * B_BAND_FLOATS;
constexpr int B_OFF_W1 = B_OFF_XS + B_XS;
constexpr int B_OFF_B1 = B_OFF_W1 + F_W1;
constexpr int B_OFF_BARS = B_OFF_B1 + 64;               // 8-byte aligned
constexpr size_t B_BYTES = 1024 + sizeof(float) * B_OFF_BARS + (2 * B_STAGES + 1) * sizeof(uint64_t);
static_assert(B_R1 == FP_TC_TILE_W, "a warp's 16 fragment rows are one row of the da1 region");
static_assert(B_OFF_BARS % 2 == 0 && B_OFF_BAND % 4 == 0, "alignment");

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

// w1: HWIO [3,3,3,64]; w1fp, w2fp: the adjoint weights flip_io(w1), flip_io(w2)
// packed by ops/tf32.py::pack_conv_weights with N tiles of 8 and 64.
__global__ void __launch_bounds__(B_THREADS, 1)
    slice1_bwd_kernel(const float* __restrict__ g, const float* __restrict__ a2,
                      const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w1fp,
                      const float* __restrict__ w2fp, float* __restrict__ dx, int h, int wd) {
  extern __shared__ uint8_t smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw + ((1024 - (fp_smem_u32(smem_raw) & 1023)) & 1023));
  float* ring = smem;
  float* w1fs = smem + B_OFF_W1F;
  float* band = smem + B_OFF_BAND;
  float* xs = smem + B_OFF_XS;
  float* w1s = smem + B_OFF_W1;
  float* b1s = smem + B_OFF_B1;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + B_OFF_BARS);
  uint64_t* empty = full + B_STAGES;
  uint64_t* w1f_bar = empty + B_STAGES;

  const int tiles_x = (wd + B_TILE - 1) / B_TILE;
  const int ty0 = (blockIdx.x / tiles_x) * B_TILE;
  const int tx0 = (blockIdx.x % tiles_x) * B_TILE;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int64_t img = (int64_t)b * h * wd;
  constexpr int ITEMS = 18;  // 2 channel chunks x 9 taps
  constexpr uint32_t STAGE_BYTES = sizeof(float) * B_STAGE_FLOATS;
  const uint8_t* w2src = reinterpret_cast<const uint8_t*>(w2fp);

  if (tid == 0) {
    fp_ring_init(full, empty, B_STAGES, B_THREADS / 32);
    fp_mbar_init(w1f_bar, 1);
    fp_mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < B_STAGES - 1; ++j)
      fp_ring_issue(j, B_STAGES, reinterpret_cast<uint8_t*>(ring), w2src, STAGE_BYTES, full, empty);
    fp_mbar_expect_tx(w1f_bar, sizeof(float) * B_W1F_FLOATS);
    fp_bulk_load(w1fs, w1fp, sizeof(float) * B_W1F_FLOATS, w1f_bar);
  }

  // dz2 = g * [a2 > 0] on the 18x18 region at offset -2, zero outside the image
  for (int i = tid; i < B_R2 * B_R2 * 16; i += B_THREADS) {
    const int q = i % 16;
    const int p = i / 16;
    const int gy = ty0 - 2 + p / B_R2;
    const int gx = tx0 - 2 + p % B_R2;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      const int64_t off = (img + (int64_t)gy * wd + gx) * 64 + 4 * q;
      const float4 gv = *reinterpret_cast<const float4*>(g + off);
      const float4 av = *reinterpret_cast<const float4*>(a2 + off);
      v.x = av.x > 0.f ? gv.x : 0.f;
      v.y = av.y > 0.f ? gv.y : 0.f;
      v.z = av.z > 0.f ? gv.z : 0.f;
      v.w = av.w > 0.f ? gv.w : 0.f;
    }
    *reinterpret_cast<float4*>(band + (q / 8) * B_BAND_FLOATS + p * FP_TC_CS + 4 * (q % 8)) = v;
  }
  for (int i = tid; i < B_XS; i += B_THREADS) {
    const int k = i % 3;
    const int p = i / 3;
    const int gy = ty0 - 2 + p / B_R2;
    const int gx = tx0 - 2 + p % B_R2;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) v = x[(img + (int64_t)gy * wd + gx) * 3 + k];
    xs[i] = v;
  }
  for (int i = tid; i < F_W1; i += B_THREADS) w1s[i] = w1[i];
  if (tid < 64) b1s[tid] = b1[tid];
  __syncthreads();

  // The thread's accumulator elements: pixels (ry, gq) and (ry, gq + 8) of the 16x16
  // region, channels 8 jn + 2 t + {0, 1}.  Bit i of `keep` says that element i of the
  // fragment lies inside the image and has conv1(x) + b1 > 0, summed as the forward does.
  const int ry = warp;
  uint32_t keep = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rx = gq + 8 * half;
    const int gy = ty0 - 1 + ry;
    const int gx = tx0 - 1 + rx;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      float xv[27];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int k = 0; k < 9; ++k) xv[dy * 9 + k] = xs[((ry + dy) * B_R2 + rx) * 3 + k];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int co = 8 * jn + 2 * t;
        float z0 = b1s[co], z1 = b1s[co + 1];
#pragma unroll
        for (int k = 0; k < 27; ++k) {
          const float2 wv = *reinterpret_cast<const float2*>(w1s + k * 64 + co);
          z0 = fmaf(xv[k], wv.x, z0);
          z1 = fmaf(xv[k], wv.y, z1);
        }
        if (z0 > 0.f) keep |= 1u << (4 * jn + 2 * half);
        if (z1 > 0.f) keep |= 1u << (4 * jn + 2 * half + 1);
      }
    }
  }

  // da1 = conv(dz2, w2f) on the 16x16 region at offset -1
  float acc[32], acc_lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = acc_lo[i] = 0.f;
  FpFrag fa, fb;
  const int frag = (ry * B_R2 + gq) * FP_TC_CS + 8 * t;
  const uint32_t ring_addr = fp_smem_u32(ring);
#pragma unroll 1
  for (int i = 0; i < ITEMS; ++i) {
    const int slot = i % B_STAGES;
    fp_mbar_wait(full + slot, (i / B_STAGES) & 1);
    const int tap = i % 9;
    const float* px0 =
        band + (i / 9) * B_BAND_FLOATS + frag + ((tap / 3) * B_R2 + tap % 3) * FP_TC_CS;
    const uint32_t b_hi = ring_addr + slot * STAGE_BYTES;
    fp_tc_tap(px0, px0 + 8 * FP_TC_CS, b_hi, b_hi + STAGE_BYTES / 2, acc, acc_lo, fa, fb, [&]() {
      // item i - 1 is done in this warp: release its stage; one thread refills it
      if (i > 0 && lane == 0) fp_mbar_arrive(empty + (i - 1) % B_STAGES);
      if (tid == 0 && i + B_STAGES - 1 < ITEMS)
        fp_ring_issue(i + B_STAGES - 1, B_STAGES, reinterpret_cast<uint8_t*>(ring), w2src,
                      STAGE_BYTES, full, empty);
      __syncwarp();
    });
  }
  fp_wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += acc_lo[i];
  __syncthreads();  // every warpgroup is done reading dz2

  // dz1 = da1 * keep, written over dz2 at the region's own offset (rows and columns 0..15)
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int co = 8 * (i >> 2) + 2 * t;
    const int rx = gq + 8 * ((i >> 1) & 1);
    float2 v;
    v.x = (keep >> i) & 1u ? acc[i] : 0.f;
    v.y = (keep >> (i + 1)) & 1u ? acc[i + 1] : 0.f;
    *reinterpret_cast<float2*>(band + (co / FP_TC_KC) * B_BAND_FLOATS +
                               (ry * B_R2 + rx) * FP_TC_CS + co % FP_TC_KC) = v;
  }
  __syncthreads();

  // dx = conv(dz1, w1f): N = 8 (3 used), outputs on 16x16 of which the 14x14 tile is kept
  float accx[4] = {0.f, 0.f, 0.f, 0.f}, accx_lo[4] = {0.f, 0.f, 0.f, 0.f};
  fp_mbar_wait(w1f_bar, 0);
  const uint32_t w1f_addr = fp_smem_u32(w1fs);
#pragma unroll 1
  for (int i = 0; i < ITEMS; ++i) {
    const int tap = i % 9;
    const float* px0 =
        band + (i / 9) * B_BAND_FLOATS + frag + ((tap / 3) * B_R2 + tap % 3) * FP_TC_CS;
    const uint32_t b_hi = w1f_addr + i * (2 * 8 * FP_TC_KC * 4);
    fp_tc_tap(px0, px0 + 8 * FP_TC_CS, b_hi, b_hi + 8 * FP_TC_KC * 4, accx, accx_lo, fa, fb, []() {});
  }
  fp_wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) accx[i] += accx_lo[i];
  // accx: (row gq, ch 2t), (row gq, ch 2t+1), (row gq+8, ch 2t), (row gq+8, ch 2t+1)
  const int oy = ty0 + ry;
  if (t < 2 && ry < B_TILE && oy < h) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rx = gq + 8 * half;
      const int ox = tx0 + rx;
      if (rx < B_TILE && ox < wd) {
        float* o = dx + (img + (int64_t)oy * wd + ox) * 3 + 2 * t;
        o[0] = accx[2 * half];
        if (t == 0) o[1] = accx[2 * half + 1];
      }
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
                          const float* b1, const float* w1fp, const float* w2fp, float* dx, int n,
                          int h, int wd, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(slice1_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((h + B_TILE - 1) / B_TILE) * ((wd + B_TILE - 1) / B_TILE);
  dim3 grid(tiles, 1, n);
  slice1_bwd_kernel<<<grid, B_THREADS, B_BYTES, (cudaStream_t)stream>>>(g, a2, x, w1, b1, w1fp,
                                                                         w2fp, dx, h, wd);
  return (int)cudaGetLastError();
}

}  // extern "C"
