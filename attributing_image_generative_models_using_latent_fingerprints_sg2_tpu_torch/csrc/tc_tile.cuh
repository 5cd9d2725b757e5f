// Tensor-core tile routine shared by conv3x3.cu and the backward of
// vgg_slice1.cu: one 3x3 tap x 32 input channels of a convolution, for a
// 64-pixel x N-channel output tile per warpgroup, as Hopper `wgmma` products
// with float32 accuracy.
//
// Stands in for the MXU products of the reference's Pallas kernels
// (ops/vgg_pallas.py::_conv3x3_kernel, ops/vgg_slice_pallas.py::
// _slice1_bwd_kernel).  What bounds those convs on the H100 is arithmetic:
// 2*9*C_in*C_out flops per pixel against 8 bytes per pixel and channel, far
// above the card's flop/byte balance.  The float32 CUDA cores give 67 TFLOP/s;
// the tensor cores give 495 TFLOP/s in TF32 but keep 10 mantissa bits, so each
// product is taken three times over split operands (a = a_hi + a_lo with
// a_hi = tf32(a), a_lo = tf32(a - a_hi), the same for b):
//     a*b ~= a_lo*b_hi + a_hi*b_lo + a_hi*b_hi,   summed in float32,
// which drops only the ~2^-22 relative a_lo*b_lo term: a bound of
// 3 * flops / 495 TFLOP/s, 2.5x under the CUDA-core bound.
//
// Layout of the operands:
//   A (activations) comes from REGISTERS.  The haloed input band lies in
//     shared memory once per 32-channel chunk as [pixel][FP_TC_CS floats]
//     (32 channels + 4 floats of padding, so that the 16-byte fragment loads
//     of a warp fall into distinct banks); a tap's shifted view is then plain
//     address arithmetic, and the hi/lo split happens in registers.  Thread
//     (g = lane / 4, t = lane % 4) of warp w owns tile rows 16 w + g and
//     16 w + g + 8 and reads channels 8 t .. 8 t + 7 of both pixels.  The
//     `wgmma` fragment of k-step s wants logical k = 8 s + t and 8 s + t + 4
//     from that thread: the weights are packed so that logical k = 8 s + t +
//     4 j is physical channel 8 t + 2 s + j (ops/tf32.py::pack_conv_weights).
//   B (weights) comes from shared memory through a `wgmma` descriptor:
//     K-major [N rows][32 k] float32 tiles, 128 bytes a row, in the 128-byte
//     swizzle (16-byte chunk index XOR row % 8), one tile for hi and one for
//     lo.  The packed global array already holds that image, so one bulk
//     async copy (`cp.async.bulk`, completion on an mbarrier) moves a stage.
//   D (float32 accumulators) stays in registers: element i of the N / 2 lies
//     at row g + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 t + i % 2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FP_TC_KC 32                 // input channels per chunk: one 128-byte swizzled row
#define FP_TC_CS (FP_TC_KC + 4)     // band's channel stride in floats
#define FP_TC_TILE_W 16             // output pixels per tile row: one warp's 16 fragment rows

__device__ __forceinline__ uint32_t fp_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier + bulk async copy ----
__device__ __forceinline__ void fp_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(fp_smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fp_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void fp_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(fp_smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void fp_mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(fp_smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void fp_mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(fp_smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from global to shared memory; completion counts on `bar`.
__device__ __forceinline__ void fp_bulk_load(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(fp_smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(fp_smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) from shared to global memory, in this thread's current bulk
// group: the generic-proxy writes to `src` must be fenced (fp_fence_proxy_async) first.
__device__ __forceinline__ void fp_bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(fp_smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void fp_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk groups but the last N have read their shared memory.
template <int N>
__device__ __forceinline__ void fp_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// ... and have completed.
template <int N>
__device__ __forceinline__ void fp_bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Order this thread's shared-memory writes before later async-proxy reads of them.
__device__ __forceinline__ void fp_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- ring of weight stages ----
// Items 0, 1, 2, ... (one tap x one channel chunk of packed weights each,
// `bytes` long and contiguous in global memory) pass through `stages` slots.
// full[slot] counts the copy's bytes; empty[slot] counts one arrival per
// consumer warp, made after the warp's `wgmma`s on the slot have completed.
__device__ __forceinline__ void fp_ring_init(uint64_t* full, uint64_t* empty, int stages,
                                             int consumer_warps) {
  for (int s = 0; s < stages; ++s) {
    fp_mbar_init(full + s, 1);
    fp_mbar_init(empty + s, consumer_warps);
  }
  fp_mbar_init_fence();
}
// One thread: start the copy of item j into its slot, once the slot's last item was released.
__device__ __forceinline__ void fp_ring_issue(int j, int stages, uint8_t* ring,
                                              const uint8_t* src, uint32_t bytes, uint64_t* full,
                                              uint64_t* empty) {
  const int slot = j % stages;
  const int round = j / stages;
  if (round > 0) fp_mbar_wait(empty + slot, (round - 1) & 1);
  fp_mbar_expect_tx(full + slot, bytes);
  fp_bulk_load(ring + (size_t)slot * bytes, src + (size_t)j * bytes, bytes, full + slot);
}

// ---- cp.async (16 bytes; zero fill when !valid) ----
__device__ __forceinline__ void fp_cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fp_smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}
__device__ __forceinline__ void fp_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- wgmma ----
__device__ __forceinline__ void fp_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fp_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fp_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle, 1024-byte
// aligned: 8-row groups 1024 bytes apart (SBO); the leading offset is unused.
__device__ __forceinline__ uint64_t fp_wgmma_desc(uint32_t smem_addr) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// tf32(x): round to nearest, ties away, onto 10 mantissa bits.
__device__ __forceinline__ uint32_t fp_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void fp_wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void fp_wgmma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// The hi and lo fragments of two k-steps (16 of a chunk's 32 channels) of a thread's two pixels.
struct FpFrag {
  uint32_t hi[2][4], lo[2][4];
};

// Read channels c .. c + 3 of both pixels (the thread's share of two k-steps) and split them.
__device__ __forceinline__ void fp_tc_load_half(const float* __restrict__ px0,
                                                const float* __restrict__ px1, FpFrag& f) {
  float v0[4], v1[4];
  *reinterpret_cast<float4*>(v0) = *reinterpret_cast<const float4*>(px0);
  *reinterpret_cast<float4*>(v1) = *reinterpret_cast<const float4*>(px1);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float x0 = v0[2 * s + j], x1 = v1[2 * s + j];
      f.hi[s][2 * j] = fp_tf32(x0);
      f.hi[s][2 * j + 1] = fp_tf32(x1);
      f.lo[s][2 * j] = fp_tf32(x0 - __uint_as_float(f.hi[s][2 * j]));
      f.lo[s][2 * j + 1] = fp_tf32(x1 - __uint_as_float(f.hi[s][2 * j + 1]));
    }
  }
}

// Two k-steps (half = 0 or 1) as one committed `wgmma` group.  The two small
// products go to their own accumulator: the tensor cores' float32 accumulation
// loses up to an ulp of the accumulator per instruction, so keeping two thirds
// of the instructions off the large sum cuts that error by as much.
template <int NREG>
__device__ __forceinline__ void fp_tc_mma_half(const FpFrag& f, uint64_t dh, uint64_t dl, int half,
                                               float (&acc)[NREG], float (&acc_lo)[NREG]) {
  fp_wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    // a k-step is 32 bytes along the swizzled row: 2 units of the address field
    const int k = 2 * (2 * half + s);
    fp_wgmma_tf32(acc_lo, f.lo[s], dh + k);
    fp_wgmma_tf32(acc_lo, f.hi[s], dl + k);
    fp_wgmma_tf32(acc, f.hi[s], dh + k);
  }
  fp_wgmma_commit();
}

// One tap x one 32-channel chunk: acc + acc_lo += A(tap) * (B_hi + B_lo) in three passes.
//   px0, px1  the thread's two pixels in the band at the tap's shift, plus its
//             channel offset 8 * (lane % 4): 8 floats are read from each.
//   b_hi, b_lo  shared-memory addresses of the [N][32] weight tiles.
//   fa, fb    fragment registers, kept by the caller across calls.
//   prev_done()  is called once the PREVIOUS call's `wgmma`s have completed (its
//             weight stage may then be released).
// The two halves are two `wgmma` groups; one stays in flight while the other
// half's fragments are read and split, so on return this call's second group
// is still running: after the last call the caller waits with fp_wgmma_wait<0>.
template <int NREG, class F>
__device__ __forceinline__ void fp_tc_tap(const float* __restrict__ px0,
                                          const float* __restrict__ px1, uint32_t b_hi,
                                          uint32_t b_lo, float (&acc)[NREG], float (&acc_lo)[NREG],
                                          FpFrag& fa, FpFrag& fb, F&& prev_done) {
  const uint64_t dh = fp_wgmma_desc(b_hi), dl = fp_wgmma_desc(b_lo);
  fp_tc_load_half(px0, px1, fa);
  fp_tc_mma_half(fa, dh, dl, 0, acc, acc_lo);
  fp_wgmma_wait<1>();  // the previous call's second group is done: fb is free
  prev_done();
  fp_tc_load_half(px0 + 4, px1 + 4, fb);
  fp_tc_mma_half(fb, dh, dl, 1, acc, acc_lo);
  fp_wgmma_wait<1>();  // this call's first group is done: fa is free
}

#include <cuda_bf16.h>

// Two floats rounded to bf16 (nearest even) and packed, the first in the low half.
__device__ __forceinline__ uint32_t fp_pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- bfloat16 route on `wgmma` (conv3x3_bf16_kernel, slice1_fwd_bf16_kernel,
// slice1_bwd_bf16_kernel) ----
//
// One pass of `wgmma.mma_async.m64nNk16.f32.bf16.bf16`: a bf16 product is exact
// in the float32 accumulator, so no split.
//   B (weights) comes from shared memory through a descriptor: K-major rows of
//     64 bf16 (128 bytes, one 64-channel chunk) in the 128-byte swizzle (16-byte
//     chunk index XOR row % 8), 8-row groups 1024 bytes apart; fp_wgmma_desc as
//     for the float32 route.  A k16-step is 32 bytes along the row, the same
//     byte stride as the float32 route's k8: the descriptor advances by 2.  The
//     packed global array holds that image (ops/tf32.py::pack_conv_weights_sw128).
//   A (activations) comes from REGISTERS, loaded by `ldmatrix.x4` from a band of
//     pixels in shared memory, each pixel one 128-byte row of 64 channels in the
//     same 128-byte swizzle (fp_sw128).  A descriptor cannot read A here: a tap
//     shifts the window by a pixel, and the swizzled core matrices of a
//     descriptor must start on 8-row (1024-byte) boundaries, so only every
//     eighth shift would be addressable.  With `ldmatrix` each lane names its
//     own row: lane l gives pixel (l % 16) of the warp's 16 fragment rows and
//     the 16-byte chunk 2 s + l / 16 of k-step s; 8 consecutive pixels at one
//     chunk index fall in 8 distinct 16-byte bank groups, so the loads are free
//     of bank conflicts.  The fragment is then the `wgmma` A layout: thread
//     (g = lane / 4, t = lane % 4) of warp w holds rows 16 w + g, 16 w + g + 8,
//     channels 2 t, 2 t + 1 and 2 t + 8, 2 t + 9.
//   D as for the float32 route: element i of the N / 2 lies at row g + 8 *
//     ((i / 2) % 2), column 8 * (i / 4) + 2 t + i % 2.

// Byte offset of 16-byte chunk q of pixel p in a band of 128-byte pixel rows.
__device__ __forceinline__ uint32_t fp_sw128(int p, int q) {
  return (uint32_t)(p * 128 + ((q ^ (p & 7)) << 4));
}

__device__ __forceinline__ void fp_ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The four k-steps of one tap x 64-channel chunk: A fragments of the lane's pixel
// `p` (its address row in the band), from the band at shared address `band`.
__device__ __forceinline__ void fp_load_a4(uint32_t (&fr)[4][4], uint32_t band, int p, int lane) {
  const uint32_t row = band + p * 128;
  const int sw = p & 7, h8 = lane >> 4;
#pragma unroll
  for (int s = 0; s < 4; ++s) fp_ldmatrix_x4(fr[s], row + (((2 * s + h8) ^ sw) << 4));
}

__device__ __forceinline__ void fp_wgmma_bf16(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void fp_wgmma_bf16(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void fp_wgmma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// acc = (accumulate ? acc : 0) + A (four k-steps of fr) x B (the [N][64] tile at shared
// address b), as one committed `wgmma` group; the caller waits for it with
// fp_wgmma_wait.  Starting a sum with accumulate = false (the instruction's scale-d
// predicate) leaves the accumulators to the `wgmma`s alone: no other instruction
// writes them while a group is in flight, which ptxas needs to keep the groups
// asynchronous (else it serialises them, warning C7515).
template <int NREG>
__device__ __forceinline__ void fp_wgmma_bf16_tap(float (&acc)[NREG], const uint32_t (&fr)[4][4],
                                                  uint32_t b, bool accumulate = true) {
  const uint64_t desc = fp_wgmma_desc(b);
  fp_wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) fp_wgmma_bf16(acc, fr[s], desc + 2 * s, s > 0 || accumulate);
  fp_wgmma_commit();
}

// Transpose a 4 x 4 block of 32-bit words across the four lanes t = lane % 4 of a
// quad: on return v[r] holds what lane r held in v[t].  Two rounds of two shuffles.
__device__ __forceinline__ void fp_quad_transpose(uint32_t (&v)[4], int t) {
  const bool t1 = t & 2, t0 = t & 1;
#pragma unroll
  for (int c = 0; c < 2; ++c) {  // trade the words whose index bit 1 differs from t's with lane t ^ 2
    const uint32_t r = __shfl_xor_sync(0xffffffffu, t1 ? v[c] : v[2 + c], 2);
    if (t1) v[c] = r; else v[2 + c] = r;
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {  // then bit 0 with lane t ^ 1
    const uint32_t r = __shfl_xor_sync(0xffffffffu, t0 ? v[2 * c] : v[2 * c + 1], 1);
    if (t0) v[2 * c] = r; else v[2 * c + 1] = r;
  }
}
