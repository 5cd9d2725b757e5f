// relu(conv3x3(x, w, stride 1, pad 1) + b), NHWC float32 (bfloat16 below), C_in == C_out, as an
// implicit GEMM on Hopper's tensor cores.
//
// Replaces ops/vgg_pallas.py::conv3x3_relu (_conv3x3_kernel via _conv3x3_call):
// the LPIPS VGG16 square convs (128@128^2, 256@64^2, 512@32^2, 512@16^2 on the
// 256px main path).  Bias and ReLU are flags, so the same kernel computes the
// backward's dx as a plain conv of the ReLU-masked cotangent with spatially
// flipped, in/out-swapped taps (the wrapper packs both orientations once).
//
// What bounds it on the H100: arithmetic.  The four shapes do 4.83, 4.83, 4.83
// and 1.21 GFLOP per image against 16.8 MB of input plus output at most (5 us
// at 3.35 TB/s); a 16-chain solve step (8 convs forward, 8 dx) is 889 GFLOP:
// 13.3 ms at the CUDA cores' 67 TFLOP/s, 5.4 ms as a three-pass TF32 product on
// the tensor cores' 495 TFLOP/s (tc_tile.cuh).  This kernel takes the second
// route.
//
// Design: M = 128 output pixels (8 rows x 16 columns) x N = 64 output channels
// per 256-thread block, two blocks an SM, so C512@16^2 at batch 16 is 256
// blocks on 132 SMs.  Each of the two warpgroups owns 64 pixels (4 tile rows)
// and keeps 64x64 float32 accumulators in registers.  K = 9 taps x C_in runs in
// chunks of 32 channels:
//   - the haloed input band (10 x 18 pixels, zero outside the image: the
//     conv's padding) of the NEXT chunk is fetched with `cp.async` into the
//     second of two band buffers while this chunk's nine taps are multiplied;
//   - the packed weights ([N tile][chunk][tap][hi, lo][64][32], pre-swizzled)
//     stream through a ring of three 16 KB stages, one bulk async copy a stage,
//     `mbarrier`s for full and empty;
//   - a tap is twelve `wgmma.m64n64k8` (4 k-steps x 3 passes of the split),
//     A from registers, B from the stage, in two groups of six so that one
//     group runs while the next one's fragments are read and split
//     (fp_tc_tap); the two small passes sum into a second accumulator.
// Epilogue: bias, ReLU, a shuffle between neighbouring lanes so that every
// thread owns 4 consecutive channels, 16-byte stores, ragged edges masked.
//
// conv3x3_relu_bf16 (bfloat16 in and out, the TPU kernel's bf16 mode): one pass
// of bf16 products into float32 accumulators, no split (bound: 889 GFLOP a
// 16-chain step over 989 TFLOP/s, 0.9 ms), on `wgmma.m64n128k16` (tc_tile.cuh's
// bf16 route).  A block is two warpgroups, each owning MT m64 row tiles of 64
// pixels (4 tile rows x 16 columns) by N output channels:
//   - 16 x 16 pixels x 128 channels (MT = 2, one block an SM, 128 float32
//     accumulators a thread) where there are at least as many such blocks as
//     SMs; else 8 x 16 x 128 (MT = 1); where C % 128 == 64, 8 x 16 x 64 (two
//     blocks an SM).  On the 256px main path at batch 16: C128@128^2 1024
//     blocks (7.8 waves of 132 SMs), C256@64^2 512 (3.9), C512@32^2 256 (1.9),
//     C512@16^2 128 blocks of 8 x 16 (one wave; as 16 x 16 tiles it would be 64
//     blocks, half the card).  A grid of blocks one after another, not a
//     persistent walk: a persistent variant (the next tile's band and weights
//     loaded under this tile's products) measured no faster.
//   - K = 9 taps x C runs as items (64-channel chunk, tap).  The weights of an
//     item ([N rows][64 k] bf16 in the 128-byte swizzle, 16 KB at N = 128,
//     packed so by ops/tf32.py::pack_conv_weights_sw128) are one bulk async
//     copy into a ring of 6 stages (4 at MT = 1) with full and empty
//     mbarriers; thread 0 refills the stage of item i - 1 once all eight warps
//     have released it.  B is read by descriptor from the stage.
//   - A comes from registers, by `ldmatrix.x4` from the haloed band (10 or 18
//     rows x 18 pixels x 64 channels, a pixel one 128-byte row in the same
//     swizzle, so the 8 rows of a matrix fall in 8 distinct bank groups),
//     fetched with `cp.async` for the next chunk under this chunk's products.
//     A descriptor cannot read A: a tap shifts the window by a pixel, and the
//     swizzled core matrices of a descriptor start on 8-row (1024-byte) bounds.
//   - A tap is one `wgmma` group of four k16-steps a row tile; groups alternate
//     between two fragment sets, one in flight while the next one's fragments
//     are read.  The accumulators are written by the `wgmma`s alone (the first
//     item's scale-d is 0) and no group is in flight across a barrier: else
//     ptxas serialises every `wgmma` (warning C7515), which cost 15% here.
//   - Epilogue: the float32 bias added to the float32 sum before the one
//     rounding, ReLU, quad transposes to 8 consecutive channels a lane,
//     16-byte stores, ragged edges masked.  The dx pass is the same kernel on
//     the packed adjoint taps without bias and ReLU.

#include "tc_tile.cuh"

namespace {

constexpr int TILE_H = 8;
constexpr int BAND_H = TILE_H + 2;
constexpr int BAND_W = FP_TC_TILE_W + 2;
constexpr int N_TILE = 64;
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int STAGE_FLOATS = 2 * N_TILE * FP_TC_KC;            // hi + lo: 16 KB
constexpr int BAND_FLOATS = BAND_H * BAND_W * FP_TC_CS;        // 25,920 bytes
constexpr size_t SMEM_BYTES =
    1024 + sizeof(float) * (STAGES * STAGE_FLOATS + 2 * BAND_FLOATS) + 2 * STAGES * sizeof(uint64_t);

__device__ __forceinline__ void load_band(float* __restrict__ band, const float* __restrict__ xb,
                                          int ty0, int tx0, int h, int wd, int c, int ci0) {
  for (int i = threadIdx.x; i < BAND_H * BAND_W * (FP_TC_KC / 4); i += THREADS) {
    const int q = i % (FP_TC_KC / 4);
    const int p = i / (FP_TC_KC / 4);
    const int iy = ty0 - 1 + p / BAND_W;
    const int ix = tx0 - 1 + p % BAND_W;
    const bool valid = iy >= 0 && iy < h && ix >= 0 && ix < wd;
    const float* src = valid ? xb + ((int64_t)iy * wd + ix) * c + ci0 + 4 * q : xb;
    fp_cp_async16(band + p * FP_TC_CS + 4 * q, src, valid);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_tc_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                      const float* __restrict__ bias, float* __restrict__ y, int h, int wd, int c,
                      int relu) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (fp_smem_u32(smem_raw) & 1023)) & 1023);
  float* ring = reinterpret_cast<float*>(base);
  float* band = ring + STAGES * STAGE_FLOATS;
  uint64_t* full = reinterpret_cast<uint64_t*>(band + 2 * BAND_FLOATS);
  uint64_t* empty = full + STAGES;

  const int tiles_x = (wd + FP_TC_TILE_W - 1) / FP_TC_TILE_W;
  const int ty0 = (blockIdx.x / tiles_x) * TILE_H;
  const int tx0 = (blockIdx.x % tiles_x) * FP_TC_TILE_W;
  const int co0 = blockIdx.y * N_TILE;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nchunks = c / FP_TC_KC;
  const int items = nchunks * 9;
  const float* xb = x + (int64_t)b * h * wd * c;
  const uint8_t* wsrc =
      reinterpret_cast<const uint8_t*>(wp + (int64_t)blockIdx.y * items * STAGE_FLOATS);
  constexpr uint32_t STAGE_BYTES = sizeof(float) * STAGE_FLOATS;

  if (tid == 0) fp_ring_init(full, empty, STAGES, THREADS / 32);
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < STAGES - 1 && j < items; ++j)
      fp_ring_issue(j, STAGES, reinterpret_cast<uint8_t*>(ring), wsrc, STAGE_BYTES, full, empty);
  }
  load_band(band, xb, ty0, tx0, h, wd, c, 0);
  fp_cp_async_wait_all();
  __syncthreads();

  float acc[N_TILE / 2], acc_lo[N_TILE / 2];
#pragma unroll
  for (int i = 0; i < N_TILE / 2; ++i) acc[i] = acc_lo[i] = 0.f;
  FpFrag fa, fb;

  // the thread's two pixels: tile row `warp`, columns g and g + 8
  const int frag = (warp * BAND_W + g) * FP_TC_CS + 8 * t;
  const uint32_t ring_addr = fp_smem_u32(ring);
  int slot = 0, prev_slot = STAGES - 1;
  uint32_t phase = 0;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if (chunk + 1 < nchunks)
      load_band(band + ((chunk + 1) & 1) * BAND_FLOATS, xb, ty0, tx0, h, wd, c,
                (chunk + 1) * FP_TC_KC);
    const float* bandc = band + (chunk & 1) * BAND_FLOATS + frag;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int i = chunk * 9 + tap;
      fp_mbar_wait(full + slot, phase);
      const float* px0 = bandc + ((tap / 3) * BAND_W + tap % 3) * FP_TC_CS;
      const uint32_t b_hi = ring_addr + slot * STAGE_BYTES;
      fp_tc_tap(px0, px0 + 8 * FP_TC_CS, b_hi, b_hi + STAGE_BYTES / 2, acc, acc_lo, fa, fb, [&]() {
        // item i - 1 is done in this warp: release its stage; one thread refills it
        if (i > 0 && lane == 0) fp_mbar_arrive(empty + prev_slot);
        if (tid == 0 && i + STAGES - 1 < items)
          fp_ring_issue(i + STAGES - 1, STAGES, reinterpret_cast<uint8_t*>(ring), wsrc, STAGE_BYTES,
                        full, empty);
        __syncwarp();
      });
      prev_slot = slot;
      if (++slot == STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }
    // the band buffer of chunk - 1 is overwritten next: its last readers are this chunk's
    // first-half loads at the latest, all issued by now
    fp_cp_async_wait_all();
    __syncthreads();
  }
  fp_wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N_TILE / 2; ++i) acc[i] += acc_lo[i];

  // epilogue: lanes t and t ^ 1 trade halves so that each owns 4 consecutive channels
  const int oy = ty0 + warp;
  const bool odd = t & 1;
  const int ox = tx0 + g + (odd ? 8 : 0);
  const bool store = oy < h && ox < wd;
  float* yrow = y + (((int64_t)b * h + oy) * wd + ox) * c + co0 + 2 * (t & 2);
#pragma unroll
  for (int jn = 0; jn < N_TILE / 8; ++jn) {
    const float c0 = acc[4 * jn], c1 = acc[4 * jn + 1], c2 = acc[4 * jn + 2], c3 = acc[4 * jn + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c0 : c2, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c1 : c3, 1);
    float4 o = odd ? make_float4(r0, r1, c2, c3) : make_float4(c0, c1, r0, r1);
    if (bias != nullptr) {
      const float4 bv = *reinterpret_cast<const float4*>(bias + co0 + 2 * (t & 2) + 8 * jn);
      o.x += bv.x;
      o.y += bv.y;
      o.z += bv.z;
      o.w += bv.w;
    }
    if (relu) {
      o.x = fmaxf(o.x, 0.f);
      o.y = fmaxf(o.y, 0.f);
      o.z = fmaxf(o.z, 0.f);
      o.w = fmaxf(o.w, 0.f);
    }
    if (store) *reinterpret_cast<float4*>(yrow + 8 * jn) = o;
  }
}


// ---- bfloat16 variant (wgmma, tc_tile.cuh's bf16 route) ----
using bf16 = __nv_bfloat16;

// MT m64 row tiles per warpgroup: a block is 8 MT x 16 output pixels x N output channels.
template <int MT, int N>
struct BwTile {
  static constexpr int ROWS = 8 * MT;
  static constexpr int BLOCKS = N == 64 ? 2 : 1;            // blocks an SM
  static constexpr int STAGES = MT == 2 ? 6 : 4;            // weight ring: one tap x 64 channels a stage
  static constexpr uint32_t STAGE_BYTES = N * 128;          // [N rows][64 k] bf16
  static constexpr int BAND_PIX = (ROWS + 2) * BAND_W;      // pixels of 128 bytes (64 channels)
  static constexpr uint32_t BAND_BYTES = BAND_PIX * 128;
  static constexpr size_t SMEM =
      1024 + STAGES * STAGE_BYTES + 2 * BAND_BYTES + 2 * STAGES * sizeof(uint64_t);
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "blocks an SM");
};

// Channels ci0 .. ci0 + 63 of the haloed band (zero outside the image) into `band`, a
// pixel a 128-byte row in the 128-byte swizzle: 16-byte cp.async pieces.
template <int BAND_PIX>
__device__ __forceinline__ void bw_load_band(uint8_t* band, const bf16* __restrict__ xb, int ty0,
                                             int tx0, int h, int wd, int c, int ci0) {
  for (int i = threadIdx.x; i < BAND_PIX * 8; i += THREADS) {
    const int q = i & 7;
    const int p = i >> 3;
    const int iy = ty0 - 1 + p / BAND_W;
    const int ix = tx0 - 1 + p % BAND_W;
    const bool valid = iy >= 0 && iy < h && ix >= 0 && ix < wd;
    const bf16* src = valid ? xb + ((int64_t)iy * wd + ix) * c + ci0 + 8 * q : xb;
    fp_cp_async16(band + fp_sw128(p, q), src, valid);
  }
}

// blockIdx.x = (image, pixel tile, N tile), the N tile fastest so that neighbouring blocks
// share the band in L2.  wp is packed in N tiles of N rows.
template <int MT, int N>
__global__ void __launch_bounds__(THREADS, BwTile<MT, N>::BLOCKS)
    conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                        const float* __restrict__ bias, bf16* __restrict__ y, int h, int wd, int c,
                        int relu) {
  using T = BwTile<MT, N>;
  constexpr int STAGES = T::STAGES;
  constexpr uint32_t STAGE_BYTES = T::STAGE_BYTES;
  extern __shared__ uint8_t smem_bw[];
  uint8_t* base = smem_bw + ((1024 - (fp_smem_u32(smem_bw) & 1023)) & 1023);
  uint8_t* ring = base;
  uint8_t* band = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(band + 2 * T::BAND_BYTES);
  uint64_t* empty = full + STAGES;

  const int n_tiles = c / N;
  const int tiles_x = (wd + FP_TC_TILE_W - 1) / FP_TC_TILE_W;
  const int tiles = ((h + T::ROWS - 1) / T::ROWS) * tiles_x;
  const int nt = blockIdx.x % n_tiles;
  const int tile = (blockIdx.x / n_tiles) % tiles;
  const int b = blockIdx.x / n_tiles / tiles;
  const int ty0 = (tile / tiles_x) * T::ROWS;
  const int tx0 = (tile % tiles_x) * FP_TC_TILE_W;
  const int co0 = nt * N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup wg: tile rows 4 (MT wg + mt) + (warp % 4), mt < MT
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nchunks = c / 64;
  const int items = nchunks * 9;
  const bf16* xb = x + (int64_t)b * h * wd * c;
  const uint8_t* wsrc = reinterpret_cast<const uint8_t*>(wp) + (size_t)nt * items * STAGE_BYTES;
  // One thread: start the copy of item j into its slot, once the slot's last item was released.
  auto issue = [&](int j) { fp_ring_issue(j, STAGES, ring, wsrc, STAGE_BYTES, full, empty); };

  if (tid == 0) fp_ring_init(full, empty, STAGES, THREADS / 32);
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < STAGES - 1 && j < items; ++j) issue(j);
  }
  bw_load_band<T::BAND_PIX>(band, xb, ty0, tx0, h, wd, c, 0);
  fp_cp_async_wait_all();
  __syncthreads();

  float acc[MT][N / 2];  // written by the `wgmma`s alone: item 0 starts each sum
  uint32_t fr[2][4][4];

  const uint32_t ring_addr = fp_smem_u32(ring);
  const uint32_t band_addr = fp_smem_u32(band);
  int slot = 0;
  uint32_t phase = 0;
  // One `wgmma` group: m-tile mt of item i (tap i % 9 of chunk i / 9), its fragments in fr.
  // Groups alternate between the two fragment sets; one stays in flight while the next
  // one's fragments are read.
  auto group = [&](int i, int mt, float(&a)[N / 2], uint32_t(&f)[4][4]) {
    const int tap = i % 9;
    const int row = 4 * (MT * wg + mt) + (warp & 3);
    fp_load_a4(f, band_addr + ((i / 9) & 1) * T::BAND_BYTES,
               (row + tap / 3) * BAND_W + (lane & 15) + tap % 3, lane);
    if (mt == 0) fp_mbar_wait(full + slot, phase);
    fp_wgmma_bf16_tap(a, f, ring_addr + slot * STAGE_BYTES, i > 0);
    fp_wgmma_wait<1>();
    if (mt == 0) {  // item i - 1 is done in this warp: release its stage; one thread refills it
      if (i > 0 && lane == 0) fp_mbar_arrive(empty + (slot + STAGES - 1) % STAGES);
      if (tid == 0 && i + STAGES - 1 < items) issue(i + STAGES - 1);
      __syncwarp();
    }
  };
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if (chunk + 1 < nchunks)
      bw_load_band<T::BAND_PIX>(band + ((chunk + 1) & 1) * T::BAND_BYTES, xb, ty0, tx0, h, wd, c,
                                (chunk + 1) * 64);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int i = chunk * 9 + tap;
      if constexpr (MT == 2) {
        group(i, 0, acc[0], fr[0]);
        group(i, 1, acc[MT - 1], fr[1]);
      } else if (i & 1) {
        group(i, 0, acc[0], fr[1]);
      } else {
        group(i, 0, acc[0], fr[0]);
      }
      if (++slot == STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }
    // No group stays in flight across the barrier.  The band buffer of chunk - 1 is
    // overwritten next: its last readers are this chunk's fragment loads, all done by now.
    fp_wgmma_wait<0>();
    fp_cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: float32 bias and ReLU, one rounding; the quad's 4 x 4 word transposes give
  // each lane 8 consecutive channels, one 16-byte store
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int oy = ty0 + 4 * (MT * wg + mt) + (warp & 3);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int ox = tx0 + g + 8 * rh;
      const bool store = oy < h && ox < wd;
      bf16* yp = y + (((int64_t)b * h + oy) * wd + ox) * c + co0;
#pragma unroll
      for (int m = 0; m < N / 32; ++m) {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * m + q;  // 8-column group
          float v0 = acc[mt][4 * j + 2 * rh], v1 = acc[mt][4 * j + 2 * rh + 1];
          if (bias != nullptr) {
            v0 += bias[co0 + 8 * j + 2 * t];
            v1 += bias[co0 + 8 * j + 2 * t + 1];
          }
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          v[q] = fp_pack_bf16x2(v0, v1);
        }
        fp_quad_transpose(v, t);
        if (store) *reinterpret_cast<uint4*>(yp + 8 * (4 * m + t)) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <int MT, int N>
cudaError_t bw_launch(const bf16* x, const bf16* wp, const float* bias, bf16* y, int64_t blocks,
                      int h, int wd, int c, int relu, cudaStream_t stream) {
  using T = BwTile<MT, N>;
  cudaError_t e = cudaFuncSetAttribute(conv3x3_bf16_kernel<MT, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(conv3x3_bf16_kernel<MT, N>, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  conv3x3_bf16_kernel<MT, N><<<(unsigned)blocks, THREADS, T::SMEM, stream>>>(x, wp, bias, y, h, wd,
                                                                             c, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// wp: the weights packed by ops/tf32.py::pack_conv_weights (N tile 64).
// bias may be null (no bias).  c must be a multiple of 64.
int fp_conv3x3_f32(const float* x, const float* wp, const float* bias, float* y, int n, int h,
                   int wd, int c, int relu, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c % N_TILE != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(conv3x3_tc_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((h + TILE_H - 1) / TILE_H) * ((wd + FP_TC_TILE_W - 1) / FP_TC_TILE_W);
  dim3 grid(tiles, c / N_TILE, n);
  conv3x3_tc_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(x, wp, bias, y, h, wd, c,
                                                                         relu);
  return (int)cudaGetLastError();
}

// wp: the weights packed by ops/tf32.py::pack_conv_weights_sw128 with an N tile of 128
// where c % 128 == 0, else 64; bias float32 or null.  c must be a multiple of 64, x and y
// 16-byte aligned.  Blocks of 16 x 16 pixels x 128 channels where there are at least as
// many as SMs, else of 8 x 16 pixels x 128 channels; where c % 128 == 64, of 8 x 16
// pixels x 64 channels, two an SM.
int fp_conv3x3_bf16(const bf16* x, const bf16* wp, const float* bias, bf16* y, int n, int h,
                    int wd, int c, int relu, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c % 64 != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t cols = (wd + FP_TC_TILE_W - 1) / FP_TC_TILE_W;
  const int64_t blocks8 = (int64_t)n * ((h + 7) / 8) * cols * (c / 64);  // 8-row tiles of 64 channels
  const int64_t blocks16 = (int64_t)n * ((h + 15) / 16) * cols * (c / 128);  // 16-row tiles of 128
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 128 != 0) return (int)bw_launch<1, 64>(x, wp, bias, y, blocks8, h, wd, c, relu, s);
  return (int)(blocks16 >= sms ? bw_launch<2, 128>(x, wp, bias, y, blocks16, h, wd, c, relu, s)
                               : bw_launch<1, 128>(x, wp, bias, y, blocks8 / 2, h, wd, c, relu, s));
}

}  // extern "C"
