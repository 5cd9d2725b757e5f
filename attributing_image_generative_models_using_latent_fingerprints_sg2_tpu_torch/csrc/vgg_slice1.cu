// VGG16 slice 1 (relu1_2) fused: a2 = relu(conv(relu(conv(x, w1) + b1), w2) + b2),
// 3 -> 64 -> 64 channels, NHWC float32, with a backward kernel for dx.
//
// Replaces ops/vgg_slice_pallas.py::vgg_slice1: the forward _slice1_fwd_kernel
// (via _slice1_fwd_call) and the backward _slice1_bwd_kernel (via
// _slice1_bwd_call).  On the 256px main path it runs on [B, 256, 256, 3] in
// every solve step's forward and backward.
//
// What bounds it on the H100: the 64 -> 64 conv's arithmetic (576
// multiply-adds per output: 77.3 of the forward's 80.9 GFLOP at batch 16, 0.47
// ms as a three-pass TF32 product on the tensor cores, 1.2 ms on the float32
// CUDA cores), and, for an unfused spelling, the bytes of the [B, 256, 256, 64]
// intermediate relu1_1 that would be written and read back.  Design: relu1_1
// (forward) and dz2, dz1 (backward) live only in shared memory, and both
// 64 -> 64 products run through the `wgmma` tile routine of tc_tile.cuh.
//   forward  A 256-thread block (2 warpgroups, two blocks an SM, so one
//            block's conv1 and epilogue run under the other's `wgmma`s) owns
//            an 8 x 16 output tile.  It loads x with a 2-pixel halo; the CUDA
//            cores compute a1 = relu(conv1(x) + b1) on the tile plus a 1-pixel
//            halo (10 x 18, recompute 1.41x) straight into the band layout of
//            tc_tile.cuh (two 32-channel chunks, 36-float pixel stride), zero
//            outside the image (conv2's padding), each value one `fmaf` chain
//            from b1 over (dy, dx, ci): the order the backward repeats for
//            conv1's sign.  conv2 is 2 chunks x 9 taps of fp_tc_tap on that
//            band, with the packed w2 streaming through a ring of three 16 KB
//            stages that starts filling before conv1 does.  Epilogue as in
//            conv3x3.cu: bias, ReLU, a lane shuffle, 16-byte stores.
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
//
// bfloat16 variants (vgg_slice1_fwd_bf16, vgg_slice1_bwd_bf16), bf16 in and
// out: one pass of bf16 products, float32 accumulators (bound 81 and 85 GFLOP
// at batch 16 over 989 TFLOP/s).  They round where the TPU kernel rounds:
// relu1_1 to bf16 in the band (its `a1band` scratch is x.dtype) and dz1 to bf16
// before the last product; biases are float32, added to the float32 sums.
//   forward  A persistent `wgmma` kernel (tc_tile.cuh's bf16 route): one
//            256-thread block an SM walks the 16 x 16 output tiles.  Its conv1
//            (5.1 GFLOP at batch 16 with the halo, ~0.07 ms on the CUDA cores)
//            costs as much as the whole tensor bound, and it cannot move to the
//            tensor cores (the backward recomputes conv1's sign in its fmaf
//            order), so it runs UNDER conv2's products.  w2, packed unflipped
//            (9 taps x [64 n][64 k] in the 128-byte swizzle, 72 KB), is copied
//            into shared memory once a block by one bulk async copy.  Per tile:
//            conv2 on the 16 x 16 tile is `wgmma.m64n64k16` (4 row tiles, two a
//            warpgroup; A by `ldmatrix` from the a1 band, 18 x 18 pixels as
//            128-byte swizzled rows, B by descriptor from the resident w2), and
//            under each tap's two groups the CUDA cores take one row of conv1's
//            terms for the NEXT tile's a1 (a thread: 9 pixels x 4 channels, w1
//            read once for 36 fmafs and x as a half-warp broadcast, 3 rounds x 3
//            rows = the 9 taps), which is rounded to bf16 into the other band;
//            the raw x rows of the tile after come in by 16-byte `cp.async`
//            meanwhile and become the next x band (float, zero outside the
//            image) at the tile's end.  Epilogue: + b2, ReLU, one rounding,
//            into an output tile in shared memory (quad transposes, 16 bytes a
//            lane), which bulk async copies store row by row while the next
//            tile computes: the 134 MB of output at batch 16 leave in the
//            background instead of in one burst a tile.  Halo recompute 1.27x
//            (the 8 x 16 tile of the float32 kernel: 1.41x).  Shared memory: w2
//            72 KB + two a1 bands 81 KB + the output tile 32 KB + x 6.3 KB + raw
//            x 2.8 KB + w1, b1, b2 as float 7.3 KB = 207,176 bytes with the
//            alignment pad.
//   backward A persistent `wgmma` kernel (tc_tile.cuh's bf16 route): one
//            256-thread block an SM walks the 14 x 14 dx tiles (block j takes
//            tiles j, j + grid, ...).  It copies the packed adjoint w2 (9 taps
//            x [64 n][64 k] bf16 in the 128-byte swizzle, 72 KB) and w1 (N
//            padded to 8, 9 KB) into shared memory once, by bulk async copy.
//            Per tile: dz2 = g * [a2 > 0] on 18 x 18 (zero outside the image)
//            is formed in place over g's band (pixels as 128-byte swizzled
//            rows), while the NEXT tile's g and a2 come in by `cp.async` and its
//            x into registers; da1 = conv_T(dz2, w2) on the 16 x 16 region is
//            `wgmma.m64n64k16` (4 row tiles, two a warpgroup; A by `ldmatrix`
//            from the band, B by descriptor from the resident w2), and under
//            each tap's groups the CUDA cores take conv1's three terms of that
//            tap for both row tiles (the forward's fmaf order; each w1 pair
//            read once); dz1 = bf16(da1 * [z1 > 0]) overwrites dz2; dx =
//            conv_T(dz1, w1) is `wgmma.m64n8k16` (3 of 8 columns used: the
//            product is 0.1 of the tile's flops, ~7% of its time when left out).
//            Shared memory: w2 72 KB + w1 9 KB + two g bands 81 KB + a2 41 KB
//            + two x bands 7.6 KB + w1, b1 as float 7 KB = 223,336 bytes of
//            232,448 with the alignment pad, so one block an SM.  The tile
//            stays 14 x 14 (bands 1.65x the bytes of g and a2, da1 recomputed
//            on 1.31x): a 16-row region a warpgroup would hold 4 x 32
//            accumulators and 4 x 32 conv1 sums a thread, more than the 255
//            registers there are (the kernel uses 255 at 2 x 32 each).

#include "tc_tile.cuh"

namespace {

// ---- forward: tile geometry and shared-memory layout (floats) ----
constexpr int F_TILE_H = 8;                             // output tile: 8 x FP_TC_TILE_W pixels
constexpr int F_BAND_H = F_TILE_H + 2;                  // a1 region, offset -1
constexpr int F_BAND_W = FP_TC_TILE_W + 2;
constexpr int F_XH = F_TILE_H + 4;                      // x region, offset -2
constexpr int F_XW = FP_TC_TILE_W + 4;
constexpr int F_THREADS = 256;
constexpr int F_STAGES = 3;
constexpr int F_STAGE_FLOATS = 2 * 64 * FP_TC_KC;       // hi + lo of one tap x chunk of w2
constexpr int F_BAND_PIXELS = F_BAND_H * F_BAND_W;
constexpr int F_BAND_FLOATS = F_BAND_PIXELS * FP_TC_CS; // one 32-channel chunk of a1
constexpr int F_XS = F_XH * F_XW * 3;
constexpr int F_W1 = 27 * 64;
constexpr int F_OFF_BAND = F_STAGES * F_STAGE_FLOATS;   // ring first: 1024-byte aligned tiles
constexpr int F_OFF_XS = F_OFF_BAND + 2 * F_BAND_FLOATS;
constexpr int F_OFF_W1 = F_OFF_XS + F_XS;
constexpr int F_OFF_B1 = F_OFF_W1 + F_W1;
constexpr int F_OFF_BARS = F_OFF_B1 + 64;
constexpr size_t F_BYTES = 1024 + sizeof(float) * F_OFF_BARS + 2 * F_STAGES * sizeof(uint64_t);
static_assert(F_OFF_BAND % 4 == 0 && F_OFF_W1 % 4 == 0 && F_OFF_BARS % 2 == 0, "alignment");
static_assert(2 * (F_BYTES + 1024) <= 232448, "two blocks an SM");

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

// w1: HWIO [3,3,3,64]; w2p: w2 packed by ops/tf32.py::pack_conv_weights with an N tile of 64.
__global__ void __launch_bounds__(F_THREADS, 2)
    slice1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ w2p,
                      const float* __restrict__ b2, float* __restrict__ y, int h, int wd) {
  extern __shared__ uint8_t smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw + ((1024 - (fp_smem_u32(smem_raw) & 1023)) & 1023));
  float* ring = smem;
  float* band = smem + F_OFF_BAND;
  float* xs = smem + F_OFF_XS;
  float* w1s = smem + F_OFF_W1;
  float* b1s = smem + F_OFF_B1;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F_OFF_BARS);
  uint64_t* empty = full + F_STAGES;

  const int tiles_x = (wd + FP_TC_TILE_W - 1) / FP_TC_TILE_W;
  const int ty0 = (blockIdx.x / tiles_x) * F_TILE_H;
  const int tx0 = (blockIdx.x % tiles_x) * FP_TC_TILE_W;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t img = (int64_t)b * h * wd;
  constexpr int ITEMS = 18;  // 2 channel chunks x 9 taps
  constexpr uint32_t STAGE_BYTES = sizeof(float) * F_STAGE_FLOATS;
  const uint8_t* w2src = reinterpret_cast<const uint8_t*>(w2p);

  if (tid == 0) fp_ring_init(full, empty, F_STAGES, F_THREADS / 32);
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < F_STAGES - 1; ++j)
      fp_ring_issue(j, F_STAGES, reinterpret_cast<uint8_t*>(ring), w2src, STAGE_BYTES, full, empty);
  }

  // x on the 12 x 20 region at offset -2, zero outside the image
  for (int i = tid; i < F_XS; i += F_THREADS) {
    const int k = i % 3;
    const int p = i / 3;
    const int iy = ty0 - 2 + p / F_XW;
    const int ix = tx0 - 2 + p % F_XW;
    float v = 0.f;
    if (iy >= 0 && iy < h && ix >= 0 && ix < wd) v = x[(img + (int64_t)iy * wd + ix) * 3 + k];
    xs[i] = v;
  }
  for (int i = tid; i < F_W1; i += F_THREADS) w1s[i] = w1[i];
  if (tid < 64) b1s[tid] = b1[tid];
  __syncthreads();

  // a1 = relu(conv1(x) + b1) on the 10 x 18 region at offset -1, zero outside the image,
  // into the band layout.  One item = one pixel x 16 channels; a warp's lanes are
  // consecutive pixels of one channel group, so its w1 reads are broadcasts.
  for (int i = tid; i < 4 * F_BAND_PIXELS; i += F_THREADS) {
    const int p = i % F_BAND_PIXELS;
    const int cq = i / F_BAND_PIXELS;
    const int r = p / F_BAND_W;
    const int q = p % F_BAND_W;
    const int ay = ty0 - 1 + r;
    const int ax = tx0 - 1 + q;
    float z[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) z[e] = 0.f;
    if (ay >= 0 && ay < h && ax >= 0 && ax < wd) {
      float xv[27];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int k = 0; k < 9; ++k) xv[dy * 9 + k] = xs[((r + dy) * F_XW + q) * 3 + k];
#pragma unroll
      for (int e = 0; e < 16; ++e) z[e] = b1s[16 * cq + e];
#pragma unroll
      for (int k = 0; k < 27; ++k) {
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(w1s + k * 64 + 16 * cq + e);
          z[e] = fmaf(xv[k], wv.x, z[e]);
          z[e + 1] = fmaf(xv[k], wv.y, z[e + 1]);
          z[e + 2] = fmaf(xv[k], wv.z, z[e + 2]);
          z[e + 3] = fmaf(xv[k], wv.w, z[e + 3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) z[e] = fmaxf(z[e], 0.f);
    }
    float* dst = band + (cq >> 1) * F_BAND_FLOATS + p * FP_TC_CS + 16 * (cq & 1);
#pragma unroll
    for (int e = 0; e < 16; e += 4)
      *reinterpret_cast<float4*>(dst + e) = make_float4(z[e], z[e + 1], z[e + 2], z[e + 3]);
  }
  __syncthreads();

  // a2 = conv(a1, w2) on the 8 x 16 tile: the thread's two pixels are tile row `warp`,
  // columns g and g + 8
  float acc[32], acc_lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = acc_lo[i] = 0.f;
  FpFrag fa, fb;
  const int frag = (warp * F_BAND_W + g) * FP_TC_CS + 8 * t;
  const uint32_t ring_addr = fp_smem_u32(ring);
#pragma unroll 1
  for (int i = 0; i < ITEMS; ++i) {
    const int slot = i % F_STAGES;
    fp_mbar_wait(full + slot, (i / F_STAGES) & 1);
    const int tap = i % 9;
    const float* px0 =
        band + (i / 9) * F_BAND_FLOATS + frag + ((tap / 3) * F_BAND_W + tap % 3) * FP_TC_CS;
    const uint32_t b_hi = ring_addr + slot * STAGE_BYTES;
    fp_tc_tap(px0, px0 + 8 * FP_TC_CS, b_hi, b_hi + STAGE_BYTES / 2, acc, acc_lo, fa, fb, [&]() {
      // item i - 1 is done in this warp: release its stage; one thread refills it
      if (i > 0 && lane == 0) fp_mbar_arrive(empty + (i - 1) % F_STAGES);
      if (tid == 0 && i + F_STAGES - 1 < ITEMS)
        fp_ring_issue(i + F_STAGES - 1, F_STAGES, reinterpret_cast<uint8_t*>(ring), w2src,
                      STAGE_BYTES, full, empty);
      __syncwarp();
    });
  }
  fp_wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += acc_lo[i];

  // epilogue: lanes t and t ^ 1 trade halves so that each owns 4 consecutive channels
  const int oy = ty0 + warp;
  const bool odd = t & 1;
  const int ox = tx0 + g + (odd ? 8 : 0);
  const bool store = oy < h && ox < wd;
  float* yrow = y + (img + (int64_t)oy * wd + ox) * 64 + 2 * (t & 2);
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const float c0 = acc[4 * jn], c1 = acc[4 * jn + 1], c2 = acc[4 * jn + 2], c3 = acc[4 * jn + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c0 : c2, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c1 : c3, 1);
    float4 o = odd ? make_float4(r0, r1, c2, c3) : make_float4(c0, c1, r0, r1);
    const float4 bv = *reinterpret_cast<const float4*>(b2 + 2 * (t & 2) + 8 * jn);
    o.x = fmaxf(o.x + bv.x, 0.f);
    o.y = fmaxf(o.y + bv.y, 0.f);
    o.z = fmaxf(o.z + bv.z, 0.f);
    o.w = fmaxf(o.w + bv.w, 0.f);
    if (store) *reinterpret_cast<float4*>(yrow + 8 * jn) = o;
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


// ---- bfloat16 variants ----
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float s_ld(const bf16* p) {
  return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p)) << 16);
}

struct SwTile {
  int64_t img;  // first pixel of the tile's image
  int ty0, tx0;
};

// Tile `tile` of the persistent walks: images one after another, square tiles of side `side`
// row by row within an image.
__device__ __forceinline__ SwTile sw_tile(int64_t tile, int h, int wd, int side) {
  const int tiles_x = (wd + side - 1) / side;
  const int64_t per_img = (int64_t)((h + side - 1) / side) * tiles_x;
  const int rem = (int)(tile % per_img);
  return {(tile / per_img) * h * wd, (rem / tiles_x) * side, (rem % tiles_x) * side};
}

// ---- forward, bf16: a persistent `wgmma` kernel (tc_tile.cuh's bf16 route) ----
// Shared memory, bytes from a 1024-byte aligned base: the packed w2 taps (resident), two a1
// bands (the tile's and the next one's: 18 x 18 pixels, a pixel one 128-byte row of 64
// channels in the 128-byte swizzle, fp_sw128), the output tile as it lies in global memory
// (16 rows of 16 x 128 bytes), the next tile's x band (20 x 20 pixels, a float4 each: its 3
// channels and a zero), the raw x rows of the tile after it (the 16-byte pieces of global
// memory that hold each row's in-image pixels), w1, b1 and b2 as float.
constexpr int SF_THREADS = 256;
constexpr int SF_TILE = 16;                                  // output tile
constexpr int SF_R1 = SF_TILE + 2;                           // a1 band, offset -1
constexpr int SF_R2 = SF_TILE + 4;                           // x band, offset -2
constexpr int SF_PIX = SF_R1 * SF_R1;                        // 324
constexpr int SF_SEG = SF_R1 / 2;                            // pixels of a conv1 item: half a band row
constexpr int SF_ITEMS = SF_R1 * 2 * 16;                     // conv1 items: SF_SEG pixels x 4 channels: 576
constexpr int SF_RAW_PIECES = 9;                             // 16-byte pieces of a raw x row (<= 120 + 2 * 14 bytes)
constexpr int SF_RAW_ROW = 16 * SF_RAW_PIECES;
constexpr uint32_t SF_BAND = SF_PIX * 128;                   // 41,472
constexpr uint32_t SF_W2 = 9 * 64 * 128;                     // [tap][64 n][64 k] bf16: 73,728
constexpr uint32_t SF_OUT = SF_TILE * SF_TILE * 128;          // the output tile, bf16, as in global memory
constexpr uint32_t SF_OFF_BAND = SF_W2;                      // two bands
constexpr uint32_t SF_OFF_OUT = SF_OFF_BAND + 2 * SF_BAND;
constexpr uint32_t SF_OFF_XS = SF_OFF_OUT + SF_OUT;
constexpr uint32_t SF_OFF_RAW = SF_OFF_XS + 16 * SF_R2 * SF_R2;
constexpr uint32_t SF_OFF_W1 = SF_OFF_RAW + SF_RAW_ROW * SF_R2;
constexpr uint32_t SF_OFF_B1 = SF_OFF_W1 + sizeof(float) * F_W1;
constexpr uint32_t SF_OFF_B2 = SF_OFF_B1 + sizeof(float) * 64;
constexpr uint32_t SF_OFF_BAR = SF_OFF_B2 + sizeof(float) * 64;
constexpr size_t SF_BYTES = 1024 + SF_OFF_BAR + sizeof(uint64_t);
static_assert(SF_OFF_BAND % 1024 == 0 && SF_BAND % 128 == 0 && SF_OFF_OUT % 128 == 0 && SF_OFF_RAW % 16 == 0 &&
                  SF_OFF_BAR % 8 == 0,
              "alignment");
static_assert(SF_R2 * SF_RAW_PIECES <= SF_THREADS && SF_ITEMS <= 3 * SF_THREADS, "work a thread");
static_assert(SF_BYTES <= 232448, "one block an SM");

// Address of the first in-image pixel of x band row r of the tile, rounded down to 16 bytes.
__device__ __forceinline__ uintptr_t sf_row_base(const bf16* x, SwTile tl, int r, int wd) {
  const bf16* p = x + (tl.img + (int64_t)(tl.ty0 - 2 + r) * wd + max(tl.tx0 - 2, 0)) * 3;
  return reinterpret_cast<uintptr_t>(p) & ~(uintptr_t)15;
}

// The raw x rows of the tile's 20 x 20 x 3 region at offset -2, by cp.async: row r's piece j
// (thread 9 r + j) is the j-th 16-byte block from sf_row_base, copied if it holds a byte of
// the row's in-image pixels (a piece may reach past them, never past the 16-byte blocks
// that hold x's own bytes).
__device__ __forceinline__ void sf_load_raw(uint8_t* raw, const bf16* __restrict__ x, SwTile tl, int h,
                                            int wd) {
  const int i = threadIdx.x;
  if (i >= SF_R2 * SF_RAW_PIECES) return;
  const int r = i / SF_RAW_PIECES;
  const int iy = tl.ty0 - 2 + r;
  uintptr_t src = 0;
  bool valid = iy >= 0 && iy < h;
  if (valid) {
    const bf16* end = x + (tl.img + (int64_t)iy * wd + min(tl.tx0 + SF_TILE + 2, wd)) * 3;
    src = sf_row_base(x, tl, r, wd) + 16 * (i % SF_RAW_PIECES);
    valid = src < reinterpret_cast<uintptr_t>(end);
  }
  fp_cp_async16(raw + r * SF_RAW_ROW + 16 * (i % SF_RAW_PIECES),
                valid ? reinterpret_cast<const void*>(src) : static_cast<const void*>(x), valid);
}

// The tile's x band from its raw rows: 20 x 20 float4 (3 channels, 0), zero outside the image.
__device__ __forceinline__ void sf_convert_x(float4* xs, const uint8_t* raw, const bf16* x, SwTile tl,
                                             int h, int wd) {
  for (int p = threadIdx.x; p < SF_R2 * SF_R2; p += SF_THREADS) {
    const int r = p / SF_R2;
    const int iy = tl.ty0 - 2 + r, ix = tl.tx0 - 2 + p % SF_R2;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (iy >= 0 && iy < h && ix >= 0 && ix < wd) {
      const uintptr_t at = reinterpret_cast<uintptr_t>(x + (tl.img + (int64_t)iy * wd + ix) * 3);
      const bf16* q = reinterpret_cast<const bf16*>(raw + r * SF_RAW_ROW + (at - sf_row_base(x, tl, r, wd)));
      v = make_float4(s_ld(q), s_ld(q + 1), s_ld(q + 2), 0.f);
    }
    xs[p] = v;
  }
}

// Row dy of conv1's terms for the thread's item of round `round` (item i = tid + 256 round,
// if i < SF_ITEMS): a1 band pixels (r, c0) .. (r, c0 + 8) with r = i / 32, c0 = 9 (i / 16 % 2),
// channels 4 cq .. 4 cq + 3 with cq = i % 16.  The 16 lanes of a half warp share the pixels, so
// x is read as a broadcast and w1 once for 36 fmafs.  dy = 0 starts the sums at b1; dy = 2
// ends them: ReLU, zero outside the image (conv2's padding), bf16 into the band.  Each element
// is one fmaf chain from b1 over (dy, dx, ci): the float32 kernel's order, which the backward
// repeats for conv1's sign.
__device__ __forceinline__ void sf_conv1(float (&z)[SF_SEG][4], int round, int dy, const float4* __restrict__ xs,
                                         const float* __restrict__ w1s, const float* __restrict__ b1s,
                                         uint8_t* band, SwTile tl, int h, int wd) {
  const int i = threadIdx.x + SF_THREADS * round;
  if (i >= SF_ITEMS) return;
  const int cq = i & 15;
  const int r = i >> 5;
  const int c0 = SF_SEG * ((i >> 4) & 1);
  if (dy == 0) {
    const float4 b = *reinterpret_cast<const float4*>(b1s + 4 * cq);
#pragma unroll
    for (int p = 0; p < SF_SEG; ++p) {
      z[p][0] = b.x;
      z[p][1] = b.y;
      z[p][2] = b.z;
      z[p][3] = b.w;
    }
  }
  float4 xv[SF_SEG + 2];
#pragma unroll
  for (int j = 0; j < SF_SEG + 2; ++j) xv[j] = xs[(r + dy) * SF_R2 + c0 + j];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      const float4 wv = *reinterpret_cast<const float4*>(w1s + (9 * dy + 3 * dx + ci) * 64 + 4 * cq);
#pragma unroll
      for (int p = 0; p < SF_SEG; ++p) {
        const float a = ci == 0 ? xv[p + dx].x : ci == 1 ? xv[p + dx].y : xv[p + dx].z;
        z[p][0] = fmaf(a, wv.x, z[p][0]);
        z[p][1] = fmaf(a, wv.y, z[p][1]);
        z[p][2] = fmaf(a, wv.z, z[p][2]);
        z[p][3] = fmaf(a, wv.w, z[p][3]);
      }
    }
  }
  if (dy == 2) {
    const int ay = tl.ty0 - 1 + r;
#pragma unroll
    for (int p = 0; p < SF_SEG; ++p) {
      const int ax = tl.tx0 - 1 + c0 + p;
      const bool inside = ay >= 0 && ay < h && ax >= 0 && ax < wd;
      const uint2 v = inside ? make_uint2(fp_pack_bf16x2(fmaxf(z[p][0], 0.f), fmaxf(z[p][1], 0.f)),
                                          fp_pack_bf16x2(fmaxf(z[p][2], 0.f), fmaxf(z[p][3], 0.f)))
                             : make_uint2(0u, 0u);
      *reinterpret_cast<uint2*>(band + fp_sw128(r * SF_R1 + c0 + p, cq >> 1) + 8 * (cq & 1)) = v;
    }
  }
}

// x [N,H,W,3] bf16; w1 HWIO [3,3,3,64] bf16; w2p: w2 packed by pack_conv_weights_sw128 (N tile
// 64, not flipped); y [N,H,W,64] bf16.  The grid walks the 16 x 16 tiles: block j takes tiles
// j, j + gridDim.x, ...  While a tile's conv2 runs on the tensor cores, the CUDA cores compute
// the next tile's a1 into the other band, and the raw x of the tile after that comes in.
__global__ void __launch_bounds__(SF_THREADS, 1)
    slice1_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                           const float* __restrict__ b1, const bf16* __restrict__ w2p,
                           const float* __restrict__ b2, bf16* __restrict__ y, int h, int wd,
                           int64_t tiles) {
  extern __shared__ uint8_t smem_sf[];
  uint8_t* base = smem_sf + ((1024 - (fp_smem_u32(smem_sf) & 1023)) & 1023);
  uint8_t* bands = base + SF_OFF_BAND;
  uint8_t* out = base + SF_OFF_OUT;
  float4* xs = reinterpret_cast<float4*>(base + SF_OFF_XS);
  uint8_t* raw = base + SF_OFF_RAW;
  float* w1s = reinterpret_cast<float*>(base + SF_OFF_W1);
  float* b1s = reinterpret_cast<float*>(base + SF_OFF_B1);
  float* b2s = reinterpret_cast<float*>(base + SF_OFF_B2);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(base + SF_OFF_BAR);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int wg = warp >> 2;  // warpgroup wg owns m-tiles 2 wg, 2 wg + 1 (4 tile rows each)
  const int wi = warp & 3;
  const uint32_t w2_addr = fp_smem_u32(base);

  if (tid == 0) {
    fp_mbar_init(wbar, 1);
    fp_mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {  // w2, once a block
    fp_mbar_expect_tx(wbar, SF_W2);
    fp_bulk_load(base, w2p, SF_W2, wbar);
  }
  for (int i = tid; i < F_W1; i += SF_THREADS) w1s[i] = s_ld(w1 + i);
  if (tid < 64) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }

  // the first tile's a1, without products to hide it under; the second tile's x comes in meanwhile
  int64_t tile = blockIdx.x;
  SwTile tl = sw_tile(tile, h, wd, SF_TILE);
  SwTile tn = sw_tile(tile + gridDim.x, h, wd, SF_TILE);
  sf_load_raw(raw, x, tl, h, wd);
  fp_cp_async_wait_all();
  __syncthreads();
  sf_convert_x(xs, raw, x, tl, h, wd);
  __syncthreads();
  if (tile + gridDim.x < tiles) sf_load_raw(raw, x, tn, h, wd);
  {
    float z[SF_SEG][4];
#pragma unroll 1
    for (int k = 0; k < 9; ++k) sf_conv1(z, k / 3, k % 3, xs, w1s, b1s, bands, tl, h, wd);
  }
  fp_cp_async_wait_all();
  __syncthreads();
  if (tile + gridDim.x < tiles) sf_convert_x(xs, raw, x, tn, h, wd);
  __syncthreads();

  // the lane's pixels: ldmatrix row (lane % 16) and accumulator rows gq, gq + 8 of warp wi in
  // m-tile 2 wg + mt, i.e. tile row 8 wg + 4 mt + wi
  const int r_lm = lane & 15;
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int buf = it & 1;
    const uint32_t band_addr = fp_smem_u32(bands + buf * SF_BAND);
    uint8_t* band_next = bands + (buf ^ 1) * SF_BAND;
    const int64_t next = tile + gridDim.x, after = next + gridDim.x;
    const SwTile ta = sw_tile(after, h, wd, SF_TILE);
    if (after < tiles) sf_load_raw(raw, x, ta, h, wd);
    if (it == 0) fp_mbar_wait(wbar, 0);

    // a2 = conv(a1, w2) on the 16 x 16 tile, tap by tap and m-tile by m-tile as `wgmma`
    // groups, one in flight while the next one's fragments are read.  Under each tap's two
    // groups the CUDA cores take one row (dy) of conv1's terms for the next tile's a1.
    float acc[2][32], z[SF_SEG][4];  // acc: written by the `wgmma`s alone (tap 0 starts the sums)
    uint32_t fr[2][4][4];
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dxx = tap % 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ry = 8 * wg + 4 * mt + wi;
        fp_load_a4(fr[mt], band_addr, (ry + dy) * SF_R1 + r_lm + dxx, lane);
        fp_wgmma_bf16_tap(acc[mt], fr[mt], w2_addr + tap * 8192, tap > 0);
        if (mt == 0) fp_wgmma_wait<1>();  // group (tap - 1, 1) is done: fr[1] is free
      }
      if (next < tiles) sf_conv1(z, tap / 3, tap % 3, xs, w1s, b1s, band_next, tn, h, wd);
      fp_wgmma_wait<1>();  // group (tap, 0) is done: fr[0] is free
    }
    fp_wgmma_wait<0>();
    if (tid < SF_TILE) fp_bulk_wait_read<0>();  // the last tile's output copies have left `out`
    fp_cp_async_wait_all();
    __syncthreads();  // the next tile's a1 complete, the raw rows arrived; xs, this band and `out` free

    // epilogue: float32 bias and ReLU, one rounding; the quad's 4 x 4 word transposes give
    // each lane 8 consecutive channels, 16 bytes into the output tile in shared memory, which
    // bulk async copies store row by row under the next tile's products
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int ry = 8 * wg + 4 * mt + wi;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint8_t* op = out + (ry * SF_TILE + gq + 8 * hf) * 128;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 4 * m + q;  // 8-channel group
            v[q] = fp_pack_bf16x2(fmaxf(acc[mt][4 * j + 2 * hf] + b2s[8 * j + 2 * t], 0.f),
                                  fmaxf(acc[mt][4 * j + 2 * hf + 1] + b2s[8 * j + 2 * t + 1], 0.f));
          }
          fp_quad_transpose(v, t);
          *reinterpret_cast<uint4*>(op + 16 * (4 * m + t)) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    fp_fence_proxy_async();
    if (after < tiles) sf_convert_x(xs, raw, x, ta, h, wd);
    __syncthreads();
    if (tid < SF_TILE && tl.ty0 + tid < h) {  // thread r stores tile row r
      fp_bulk_store(y + (tl.img + (int64_t)(tl.ty0 + tid) * wd + tl.tx0) * 64, out + tid * SF_TILE * 128,
                    min(SF_TILE, wd - tl.tx0) * 128);
      fp_bulk_commit();
    }
    tl = tn;
    tn = ta;
  }
  if (tid < SF_TILE) fp_bulk_wait<0>();
}

// ---- backward, bf16: a persistent `wgmma` kernel (tc_tile.cuh's bf16 route) ----
// Shared memory, bytes from a 1024-byte aligned base: the adjoint w2 and w1 taps
// (resident), two dz2 / dz1 bands (the tile's and the next one's), the next tile's
// raw a2, two x bands (float), w1 (float) and b1.  The bands hold 18 x 18 pixels of
// 64 channels, a pixel one 128-byte row in the 128-byte swizzle (fp_sw128).
constexpr int SW_THREADS = 256;
constexpr int SW_PIX = B_R2 * B_R2;                          // 324
constexpr uint32_t SW_BAND = SW_PIX * 128;                   // 41,472
constexpr uint32_t SW_W2 = 9 * 64 * 128;                     // [tap][64 n][64 k] bf16: 73,728
constexpr uint32_t SW_W1F = 9 * 8 * 128;                     // [tap][8 n][64 k] bf16: 9,216
constexpr uint32_t SW_OFF_W1F = SW_W2;
constexpr uint32_t SW_OFF_G = SW_OFF_W1F + SW_W1F;           // two bands
constexpr uint32_t SW_OFF_A2 = SW_OFF_G + 2 * SW_BAND;
constexpr uint32_t SW_OFF_XS = SW_OFF_A2 + SW_BAND;          // two x bands of B_XS floats
constexpr uint32_t SW_OFF_W1 = SW_OFF_XS + 2 * sizeof(float) * B_XS;
constexpr uint32_t SW_OFF_B1 = SW_OFF_W1 + sizeof(float) * F_W1;
constexpr uint32_t SW_OFF_BAR = SW_OFF_B1 + sizeof(float) * 64;
constexpr size_t SW_BYTES = 1024 + SW_OFF_BAR + sizeof(uint64_t);
static_assert(SW_OFF_G % 1024 == 0 && SW_OFF_A2 % 128 == 0 && SW_OFF_BAR % 8 == 0, "alignment");
static_assert(SW_BYTES <= 232448, "one block an SM");

// The tile's g and a2 on the 18 x 18 region at offset -2 (zero outside the image): 16-byte
// cp.async pieces, piece i to thread i % SW_THREADS, which later masks what it loaded.
__device__ __forceinline__ void sw_load_ga(uint8_t* gb, uint8_t* ab, const bf16* __restrict__ g,
                                           const bf16* __restrict__ a2, SwTile tl, int h, int wd) {
  for (int i = threadIdx.x; i < SW_PIX * 8; i += SW_THREADS) {
    const int q = i & 7;
    const int p = i >> 3;
    const int gy = tl.ty0 - 2 + p / B_R2;
    const int gx = tl.tx0 - 2 + p % B_R2;
    const bool valid = gy >= 0 && gy < h && gx >= 0 && gx < wd;
    const int64_t off = valid ? (tl.img + (int64_t)gy * wd + gx) * 64 + 8 * q : 0;
    fp_cp_async16(gb + fp_sw128(p, q), g + off, valid);
    fp_cp_async16(ab + fp_sw128(p, q), a2 + off, valid);
  }
}

// x element i (< B_XS) of the tile's 18 x 18 x 3 region at offset -2, as raw bf16 bits;
// 0 outside the image.
__device__ __forceinline__ uint32_t sw_x(const bf16* __restrict__ x, SwTile tl, int i, int h, int wd) {
  const int p = i / 3;
  const int gy = tl.ty0 - 2 + p / B_R2;
  const int gx = tl.tx0 - 2 + p % B_R2;
  if (gy < 0 || gy >= h || gx < 0 || gx >= wd) return 0u;
  return *reinterpret_cast<const unsigned short*>(x + (tl.img + (int64_t)gy * wd + gx) * 3 + i % 3);
}

// g, a2 [N,H,W,64], x [N,H,W,3] bf16; w1 HWIO bf16; w1fp, w2fp: flip_io(w1), flip_io(w2)
// packed by pack_conv_weights_sw128 with N tiles of 8 and 64.  The grid walks the
// tiles: block j takes tiles j, j + gridDim.x, ...
__global__ void __launch_bounds__(SW_THREADS, 1)
    slice1_bwd_bf16_kernel(const bf16* __restrict__ g, const bf16* __restrict__ a2,
                           const bf16* __restrict__ x, const bf16* __restrict__ w1,
                           const float* __restrict__ b1, const bf16* __restrict__ w1fp,
                           const bf16* __restrict__ w2fp, bf16* __restrict__ dx, int h, int wd,
                           int64_t tiles) {
  extern __shared__ uint8_t smem_sw[];
  uint8_t* base = smem_sw + ((1024 - (fp_smem_u32(smem_sw) & 1023)) & 1023);
  uint8_t* gbuf = base + SW_OFF_G;
  uint8_t* abuf = base + SW_OFF_A2;
  float* xs = reinterpret_cast<float*>(base + SW_OFF_XS);
  float* w1s = reinterpret_cast<float*>(base + SW_OFF_W1);
  float* b1s = reinterpret_cast<float*>(base + SW_OFF_B1);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(base + SW_OFF_BAR);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int wg = warp >> 2;  // warpgroup wg owns m-tiles 2 wg, 2 wg + 1 (16 region rows each 4)
  const int wi = warp & 3;
  const uint32_t w2_addr = fp_smem_u32(base);
  const uint32_t w1f_addr = fp_smem_u32(base + SW_OFF_W1F);

  if (tid == 0) {
    fp_mbar_init(wbar, 1);
    fp_mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {  // the weights, once a block
    fp_mbar_expect_tx(wbar, SW_W2 + SW_W1F);
    fp_bulk_load(base, w2fp, SW_W2, wbar);
    fp_bulk_load(base + SW_OFF_W1F, w1fp, SW_W1F, wbar);
  }
  for (int i = tid; i < F_W1; i += SW_THREADS) w1s[i] = s_ld(w1 + i);
  if (tid < 64) b1s[tid] = b1[tid];
  int64_t tile = blockIdx.x;
  SwTile tl = sw_tile(tile, h, wd, B_TILE);
  sw_load_ga(gbuf, abuf, g, a2, tl, h, wd);
  for (int i = tid; i < B_XS; i += SW_THREADS) xs[i] = __uint_as_float(sw_x(x, tl, i, h, wd) << 16);

  // the lane's pixels: ldmatrix row (lane % 16) and accumulator rows gq, gq + 8 of warp wi
  // in m-tile 2 wg + mt, i.e. region row 8 wg + 4 mt + wi
  const int r_lm = lane & 15;
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int buf = it & 1;
    uint8_t* band = gbuf + buf * SW_BAND;
    const uint32_t band_addr = fp_smem_u32(band);
    const float* xt = xs + buf * B_XS;

    // dz2 = g * [a2 > 0] over the pieces this thread loaded, in place (a2 > 0 read off
    // the bits: sign clear and not zero)
    fp_cp_async_wait_all();
    for (int i = tid; i < SW_PIX * 8; i += SW_THREADS) {
      const uint32_t off = fp_sw128(i >> 3, i & 7);
      uint4* gp = reinterpret_cast<uint4*>(band + off);
      const uint4 gv = *gp;
      const uint4 av = *reinterpret_cast<const uint4*>(abuf + off);
      const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w}, aw[4] = {av.x, av.y, av.z, av.w};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = (aw[e] & 0x8000u) == 0 && (aw[e] & 0x7fffu) != 0 ? 0x0000ffffu : 0u;
        const uint32_t hi = (aw[e] & 0x80000000u) == 0 && (aw[e] & 0x7fff0000u) != 0 ? 0xffff0000u : 0u;
        o[e] = gw[e] & (lo | hi);
      }
      *gp = make_uint4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();  // dz2 and the tile's x band complete; the a2 buffer is free

    // the next tile's g, a2 (cp.async) and x (registers) come in under this tile's products
    const int64_t next = tile + gridDim.x;
    const SwTile tn = sw_tile(next, h, wd, B_TILE);
    uint32_t xr[(B_XS + SW_THREADS - 1) / SW_THREADS];
    if (next < tiles) {
      sw_load_ga(gbuf + (buf ^ 1) * SW_BAND, abuf, g, a2, tn, h, wd);
#pragma unroll
      for (int j = 0; j < (B_XS + SW_THREADS - 1) / SW_THREADS; ++j) {
        const int i = tid + j * SW_THREADS;
        xr[j] = i < B_XS ? sw_x(x, tn, i, h, wd) : 0u;
      }
    }
    if (it == 0) fp_mbar_wait(wbar, 0);

    // da1 = conv(dz2, w2f) on the 16 x 16 region at offset -1, tap by tap and M-tile by
    // M-tile as `wgmma` groups, one in flight while the next one's fragments are read.
    // Under each tap's two groups the CUDA cores take conv1's three terms of that tap (its
    // 3 input channels) for the same pixels, so that z1 = conv1(x) + b1 is summed as the
    // forward kernel sums it: one fmaf chain from b1 over (dy, dx, ci).
    float acc[2][32], z[2][32];  // acc: written by the `wgmma`s alone (tap 0 starts the sums)
    uint32_t fr[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) z[mt][i] = b1s[8 * (i >> 2) + 2 * t + (i & 1)];
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dxx = tap % 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ry = 8 * wg + 4 * mt + wi;
        fp_load_a4(fr[mt], band_addr, (ry + dy) * B_R2 + r_lm + dxx, lane);
        fp_wgmma_bf16_tap(acc[mt], fr[mt], w2_addr + tap * 8192, tap > 0);
        if (mt == 0) fp_wgmma_wait<1>();  // group (tap - 1, 1) is done: fr[1] is free
      }
      // conv1's three terms of this tap for both m-tiles' pixels, each w1 pair read once
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        const int k = 3 * tap + ci;
        float xv[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int p = (8 * wg + 4 * mt + wi + dy) * B_R2 + gq + dxx;
          xv[mt][0] = xt[p * 3 + ci];
          xv[mt][1] = xt[(p + 8) * 3 + ci];
        }
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const float2 wv = *reinterpret_cast<const float2*>(w1s + k * 64 + 8 * jn + 2 * t);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            z[mt][4 * jn] = fmaf(xv[mt][0], wv.x, z[mt][4 * jn]);
            z[mt][4 * jn + 1] = fmaf(xv[mt][0], wv.y, z[mt][4 * jn + 1]);
            z[mt][4 * jn + 2] = fmaf(xv[mt][1], wv.x, z[mt][4 * jn + 2]);
            z[mt][4 * jn + 3] = fmaf(xv[mt][1], wv.y, z[mt][4 * jn + 3]);
          }
        }
      }
      fp_wgmma_wait<1>();  // group (tap, 0) is done: fr[0] is free
    }
    fp_wgmma_wait<0>();
    __syncthreads();  // every warp is done reading dz2

    // dz1 = bf16(da1 * [z1 > 0]), zero outside the image, over dz2 at the region's own
    // offset (rows and columns 0..15 of the band)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int ry = 8 * wg + 4 * mt + wi;
      const int gy = tl.ty0 - 1 + ry;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rx = gq + 8 * hf;
        const int gx = tl.tx0 - 1 + rx;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
        const int p = ry * B_R2 + rx;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int i = 4 * jn + 2 * hf;
          const float v0 = inside && z[mt][i] > 0.f ? acc[mt][i] : 0.f;
          const float v1 = inside && z[mt][i + 1] > 0.f ? acc[mt][i + 1] : 0.f;
          *reinterpret_cast<uint32_t*>(band + p * 128 + ((jn ^ (p & 7)) << 4) + 4 * t) =
              fp_pack_bf16x2(v0, v1);
        }
      }
    }
    if (next < tiles) {
#pragma unroll
      for (int j = 0; j < (B_XS + SW_THREADS - 1) / SW_THREADS; ++j) {
        const int i = tid + j * SW_THREADS;
        if (i < B_XS) xs[(buf ^ 1) * B_XS + i] = __uint_as_float(xr[j] << 16);
      }
    }
    __syncthreads();  // dz1 complete

    // dx = conv(dz1, w1f) on the 16 x 16 region at offset 0 (N = 8, 3 used), of which the
    // 14 x 14 tile is kept; the same fragment walk as da1
    float accx[2][4];  // written by the `wgmma`s alone
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ry = 8 * wg + 4 * mt + wi;
        fp_load_a4(fr[mt], band_addr, (ry + tap / 3) * B_R2 + r_lm + tap % 3, lane);
        fp_wgmma_bf16_tap(accx[mt], fr[mt], w1f_addr + tap * 1024, tap > 0);
        fp_wgmma_wait<1>();
      }
    }
    fp_wgmma_wait<0>();
    // accx[mt]: (row gq, ch 2t), (row gq, ch 2t + 1), (row gq + 8, ch 2t), (row gq + 8, ch 2t + 1)
    if (t < 2) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ry = 8 * wg + 4 * mt + wi;
        const int oy = tl.ty0 + ry;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int rx = gq + 8 * hf;
          const int ox = tl.tx0 + rx;
          if (ry >= B_TILE || rx >= B_TILE || oy >= h || ox >= wd) continue;
          bf16* o = dx + (tl.img + (int64_t)oy * wd + ox) * 3 + 2 * t;
          o[0] = __float2bfloat16_rn(accx[mt][2 * hf]);
          if (t == 0) o[1] = __float2bfloat16_rn(accx[mt][2 * hf + 1]);
        }
      }
    }
    tl = tn;
  }
}

}  // namespace

extern "C" {

int fp_vgg_slice1_fwd_f32(const float* x, const float* w1, const float* b1, const float* w2p,
                          const float* b2, float* y, int n, int h, int wd, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(slice1_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((h + F_TILE_H - 1) / F_TILE_H) * ((wd + FP_TC_TILE_W - 1) / FP_TC_TILE_W);
  dim3 grid(tiles, 1, n);
  slice1_fwd_kernel<<<grid, F_THREADS, F_BYTES, (cudaStream_t)stream>>>(x, w1, b1, w2p, b2, y, h,
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

// One block an SM walks the 16 x 16 tiles.
int fp_vgg_slice1_fwd_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2p,
                           const float* b2, bf16* y, int n, int h, int wd, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(slice1_fwd_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SF_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  const int64_t tiles = (int64_t)n * ((h + SF_TILE - 1) / SF_TILE) * ((wd + SF_TILE - 1) / SF_TILE);
  const int grid = (int)(tiles < sms ? tiles : sms);
  slice1_fwd_bf16_kernel<<<grid, SF_THREADS, SF_BYTES, (cudaStream_t)stream>>>(x, w1, b1, w2p, b2, y, h,
                                                                               wd, tiles);
  return (int)cudaGetLastError();
}

// g and a2 must be 16-byte aligned (64 channels a pixel).  One block an SM walks the tiles.
int fp_vgg_slice1_bwd_bf16(const bf16* g, const bf16* a2, const bf16* x, const bf16* w1,
                           const float* b1, const bf16* w1fp, const bf16* w2fp, bf16* dx, int n,
                           int h, int wd, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 ||
      ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(a2)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(slice1_bwd_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SW_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  const int64_t tiles = (int64_t)n * ((h + B_TILE - 1) / B_TILE) * ((wd + B_TILE - 1) / B_TILE);
  const int grid = (int)(tiles < sms ? tiles : sms);
  slice1_bwd_bf16_kernel<<<grid, SW_THREADS, SW_BYTES, (cudaStream_t)stream>>>(
      g, a2, x, w1, b1, w1fp, w2fp, dx, h, wd, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
