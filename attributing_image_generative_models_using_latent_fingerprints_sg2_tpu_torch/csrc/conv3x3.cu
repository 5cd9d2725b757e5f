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
// 16-chain step over 989 TFLOP/s, 0.9 ms).  A simple first version, through
// the warp-level `mma.sync.m16n8k16` bf16 product of tc_tile.cuh (fp_bf16_taps),
// not `wgmma`: the same 8 x 16 pixel x 64 channel block tile, 8 warps of 2 pixel
// rows x 32 channels (2 x 4 fragments); per 32-channel chunk the haloed band
// (10 x 18 pixels) and the chunk's 9 packed weight taps ([tap][64][32] bf16,
// ops/tf32.py::pack_conv_weights_bf16) are copied with `cp.async` into one of
// two shared-memory stages (rows padded to 40 bf16 so that fragment loads are
// free of bank conflicts) while the other stage's 18 k16-steps run.  The
// float32 bias is added to the float32 sum before the one rounding of the
// output, as the TPU kernel does; the dx pass is the same kernel on the packed
// adjoint taps without bias and ReLU.

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


// ---- bfloat16 variant ----
using bf16 = __nv_bfloat16;
constexpr int BT_KC = 32;                                 // input channels per chunk
constexpr int BT_KS = BT_KC + 8;                          // shared row stride, bf16
constexpr int BT_BAND = BAND_H * BAND_W * BT_KS;          // bf16 elements of a stage's band
constexpr int BT_WTS = 9 * N_TILE * BT_KS;                // ... and of its weight taps
constexpr int BT_STAGE = BT_BAND + BT_WTS;                // 60,480 bytes
constexpr size_t BT_SMEM = 2 * sizeof(bf16) * BT_STAGE;

// Chunk `chunk` (input channels 32 chunk ..) of the haloed band, zero outside the
// image, and of the packed weights into a stage: 16-byte cp.async pieces.
__device__ __forceinline__ void bt_load_stage(bf16* __restrict__ stage, const bf16* __restrict__ xb,
                                              const bf16* __restrict__ wsrc, int ty0, int tx0, int h,
                                              int wd, int c, int chunk) {
  const int ci0 = chunk * BT_KC;
  for (int i = threadIdx.x; i < BAND_H * BAND_W * (BT_KC / 8); i += THREADS) {
    const int q = i % (BT_KC / 8);
    const int p = i / (BT_KC / 8);
    const int iy = ty0 - 1 + p / BAND_W;
    const int ix = tx0 - 1 + p % BAND_W;
    const bool valid = iy >= 0 && iy < h && ix >= 0 && ix < wd;
    const bf16* src = valid ? xb + ((int64_t)iy * wd + ix) * c + ci0 + 8 * q : xb;
    fp_cp_async16(stage + p * BT_KS + 8 * q, src, valid);
  }
  const bf16* wc = wsrc + (int64_t)chunk * 9 * N_TILE * BT_KC;
  bf16* wts = stage + BT_BAND;
  for (int i = threadIdx.x; i < 9 * N_TILE * (BT_KC / 8); i += THREADS) {
    const int q = i % (BT_KC / 8);
    const int r = i / (BT_KC / 8);
    fp_cp_async16(wts + r * BT_KS + 8 * q, wc + r * BT_KC + 8 * q, true);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                        const float* __restrict__ bias, bf16* __restrict__ y, int h, int wd, int c,
                        int relu) {
  extern __shared__ __align__(16) uint8_t smem_bt[];
  bf16* stages = reinterpret_cast<bf16*>(smem_bt);
  const int tiles_x = (wd + FP_TC_TILE_W - 1) / FP_TC_TILE_W;
  const int ty0 = (blockIdx.x / tiles_x) * TILE_H;
  const int tx0 = (blockIdx.x % tiles_x) * FP_TC_TILE_W;
  const int co0 = blockIdx.y * N_TILE;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp & 3;   // tile rows 2 wm, 2 wm + 1
  const int wn = warp >> 2;  // output channels 32 wn .. 32 wn + 31 of the block's 64
  const int nchunks = c / BT_KC;
  const bf16* xb = x + (int64_t)b * h * wd * c;
  const bf16* wsrc = wp + (int64_t)blockIdx.y * nchunks * 9 * N_TILE * BT_KC;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  bt_load_stage(stages, xb, wsrc, ty0, tx0, h, wd, c, 0);
  fp_cp_async_commit();
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if (chunk + 1 < nchunks)
      bt_load_stage(stages + ((chunk + 1) & 1) * BT_STAGE, xb, wsrc, ty0, tx0, h, wd, c, chunk + 1);
    fp_cp_async_commit();  // (empty after the last chunk: one group per iteration)
    fp_cp_async_wait<1>();  // this chunk's stage has landed
    __syncthreads();
    const bf16* band = stages + (chunk & 1) * BT_STAGE;
    fp_bf16_taps<2, 4, BT_KC / 16>(acc, band + (2 * wm * BAND_W + g) * BT_KS + 2 * t, BAND_W * BT_KS,
                                   BAND_W, BT_KS, band + BT_BAND + (32 * wn + g) * BT_KS + 2 * t, BT_KS,
                                   N_TILE * BT_KS);
    __syncthreads();  // the next iteration refills this stage
  }

  // epilogue: bias (float32) and ReLU on the float32 sum, one rounding to bf16
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int oy = ty0 + 2 * wm + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = tx0 + g + 8 * half;
      if (oy >= h || ox >= wd) continue;
      bf16* yp = y + (((int64_t)b * h + oy) * wd + ox) * c + co0 + 32 * wn + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (bias != nullptr) {
          v0 += bias[co0 + 32 * wn + 8 * nt + 2 * t];
          v1 += bias[co0 + 32 * wn + 8 * nt + 2 * t + 1];
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(yp + 8 * nt) = fp_pack_bf16x2(v0, v1);
      }
    }
  }
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

// wp: the weights packed by ops/tf32.py::pack_conv_weights_bf16 (N tile 64); bias
// float32 or null.  c must be a multiple of 64, x 16-byte aligned.
int fp_conv3x3_bf16(const bf16* x, const bf16* wp, const float* bias, bf16* y, int n, int h,
                    int wd, int c, int relu, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || c % N_TILE != 0 || n > 65535 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(conv3x3_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BT_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((h + TILE_H - 1) / TILE_H) * ((wd + FP_TC_TILE_W - 1) / FP_TC_TILE_W);
  dim3 grid(tiles, c / N_TILE, n);
  conv3x3_bf16_kernel<<<grid, THREADS, BT_SMEM, (cudaStream_t)stream>>>(x, wp, bias, y, h, wd, c,
                                                                        relu);
  return (int)cudaGetLastError();
}

}  // extern "C"
