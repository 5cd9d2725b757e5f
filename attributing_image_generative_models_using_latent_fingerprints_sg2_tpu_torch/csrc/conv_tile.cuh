// CUDA-core building block of the vgg_slice1 forward (vgg_slice1.cu): one
// input-channel chunk of a 3x3 convolution for an 8x8-pixel x 64-channel
// output tile, computed by 256 threads in float32 `fmaf`s from operands
// already in shared memory.  (conv3x3.cu and the vgg_slice1 backward use the
// tensor-core routine of tc_tile.cuh instead.)
//
// Thread layout: thread t owns output channels cg*4 .. cg*4+3 (cg = t % 16)
// of the 4 pixels (prow, pcol0 .. pcol0+3) with prow = (t / 16) / 2 and
// pcol0 = ((t / 16) % 2) * 4, i.e. 4 x 4 float accumulators in registers.
//
// Operands:
//   in   shared input tile of 10 x 10 pixels (the 8x8 tile plus a 1-pixel halo,
//        row-major, row stride 10) with channel stride `cs`; the chunk's
//        channels start at `coff`.
//   wch  shared weight chunk [9 taps][KC in][64 out] (taps row-major (dy, dx)).
// For each in-channel and kernel row, the 6 input values that the thread's 4
// pixels x 3 kernel columns need are loaded once and reused 12 times; the 4
// output channels come from one 16-byte weight load.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FP_TILE 8
#define FP_HALO_W (FP_TILE + 2)
#define FP_CO_TILE 64
#define FP_KC 16
#define FP_THREADS 256

__device__ __forceinline__ void fp_conv_tile_chunk(const float* __restrict__ in, int cs, int coff,
                                                   const float* __restrict__ wch, int prow,
                                                   int pcol0, int cg, float (&acc)[4][4]) {
#pragma unroll 2
  for (int k = 0; k < FP_KC; ++k) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* row = in + ((prow + dy) * FP_HALO_W + pcol0) * cs + coff + k;
      float xr[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) xr[q] = row[q * cs];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wch + ((dy * 3 + dx) * FP_KC + k) * FP_CO_TILE + cg * 4);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float xv = xr[p + dx];
          acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
          acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
          acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
          acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
        }
      }
    }
  }
}

// Load the weight chunk w[tap][ci0 + k][co0 + j] (HWIO, `cin` in-channels,
// `cout` out-channels) into wch[tap][k][j] for k < FP_KC, j < FP_CO_TILE.
__device__ __forceinline__ void fp_load_weight_chunk(float* __restrict__ wch,
                                                     const float* __restrict__ w, int cin,
                                                     int cout, int ci0, int co0) {
  for (int i = threadIdx.x; i < 9 * FP_KC * FP_CO_TILE; i += FP_THREADS) {
    const int j = i % FP_CO_TILE;
    const int t = i / FP_CO_TILE;
    const int k = t % FP_KC;
    const int tap = t / FP_KC;
    wch[i] = w[((int64_t)tap * cin + ci0 + k) * cout + co0 + j];
  }
}
