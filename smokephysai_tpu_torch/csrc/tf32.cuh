// Split-TF32 ("3xTF32") products on the tensor cores, shared by the float32
// flash kernels (flash_tokens.cu, flash_bwd.cu): the split of a float32
// operand into two TF32 parts, mma.sync m16n8k8 with float32 accumulation,
// and cp.async tile copies into padded shared memory.
//
// A float32 x is carried as hi = tf32(x) and lo = tf32(x - hi), each rounded
// to the nearest TF32 value (10 stored mantissa bits, ties away from zero:
// cvt.rna.tf32.f32); x - hi is exact in float32. A product a b is summed as
// lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), small terms first, into a float32
// accumulator. The dropped lo lo term and the rounding of lo leave ~2^-21 of
// each product, where a single TF32 product keeps ~2^-11. Three TF32
// products at 495 TFLOP/s (H100 SXM, dense) give ~165 TFLOP/s of
// float32-accurate products, against 67 TFLOP/s for float32 FMAs.
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA), for
// lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// So the C fragment of one 8-column n-tile is the A fragment of an 8-deep
// k-step whose k order is (2t, 2t + 1) for (t, t + 4): a product's
// probabilities feed the next product with no exchange between threads,
// when the next product's B reads its rows in that order.
#pragma once

#include <stdint.h>

namespace {

// rows (queries or keys) of a float32 CTA: four warps of 16 rows each. CTAs
// of 32 and 16 rows were slower on the card at both measured shapes
constexpr int F32_ROWS = 64;
constexpr int F32_THREADS = 2 * F32_ROWS;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi and lo parts of the N values of a fragment
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = to_tf32(x[i]);
    lo[i] = to_tf32(x[i] - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, float32-accurate: lo hi', hi lo', then hi hi'; b = (b0, b1) as
// float32 values, split here
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  const float b[2] = {b0, b1};
  uint32_t bh[2], bl[2];
  split_tf32(b, bh, bl);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ROWS x HD floats of one head (row stride D floats in global memory) into
// shared memory at `dst` with a row pitch of P floats, 16 bytes a copy,
// spread over the CTA's F32_THREADS threads
template <int HD, int P, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src, int D) {
  constexpr int CH = HD / 4, N = ROWS * CH;  // 16-byte chunks per row, in all
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += F32_THREADS) {
    const int i = i0 + threadIdx.x;
    if (N % F32_THREADS == 0 || i < N) {
      const int r = i / CH, c = i % CH;
      cp_async16(dst + (r * P + c * 4) * 4, src + (size_t)r * D + c * 4);
    }
  }
}

// N contiguous floats (N a multiple of 4, at most 4 F32_THREADS) into shared
// memory at `dst`
template <int N>
__device__ __forceinline__ void load_vec(uint32_t dst, const float* src) {
  static_assert(N % 4 == 0 && N / 4 <= F32_THREADS, "one copy per thread");
  if (threadIdx.x < N / 4) cp_async16(dst + threadIdx.x * 16, src + threadIdx.x * 4);
}

}  // namespace
