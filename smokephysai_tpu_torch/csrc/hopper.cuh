// Hopper (sm_90a) primitives shared by the flash attention kernels
// (flash_tokens.cu, flash_bwd.cu): mbarriers, TMA loads from 3D tensor maps
// and 1D bulk copies, wgmma shared-memory descriptors and the wgmma
// products in inline PTX, and the host-side tensor-map encoder.
//
// A head's tile of a token-major [B, L, D] bf16 tensor is [rows, hd] at
// column h*hd. TMA copies it as NBOX boxes of [rows, BOX] (BOX = min(hd,
// 64)), each under the swizzle of its row's bytes (32, 64 or 128), one box
// after another in shared memory; the wgmma descriptors name the same
// layout. Rows past L zero-fill (3D maps: never the next batch element's).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the shared-memory layout of a [rows, HD] bf16 tile of one head
template <int HD>
struct HeadTile {
  static constexpr int BOX = HD < 64 ? HD : 64;  // columns per TMA box
  static constexpr int ROW = BOX * 2;            // bytes per box row = swizzle span
  static constexpr int NBOX = HD / BOX;          // 2 at head_dim 128
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

// the retry loop inside the asm: no branch of the C++ program
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// arrives where `pred` holds, by a predicated instruction, not a branch:
// ptxas serialises every wgmma of a kernel whose in-flight products cross
// a divergent branch, so the consumers' code has none
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(bar), "r"((int)pred) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// a 32-bit store where `pred` holds (predicated, as mbar_arrive_if)
__device__ __forceinline__ void st_b32_if(void* dst, uint32_t v, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.b32 [%0], %1;\n}\n"
      :: "l"(dst), "r"(v), "r"((int)pred) : "memory");
}

// one box of a 3D tensor map into shared memory; completion counted on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of contiguous
// global memory into shared memory; completion counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma reading them as an operand)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (not 0, which __syncthreads uses) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout type
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
#ifdef FLASH_PROBE_NO_EXP  // measurement only: what the exponentials cost
  return x;
#endif
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- wgmma

#define WG_D8(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
                 "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_D16(o) WG_D8(o), WG_D8(o + 8)
#define WG_D32(o) WG_D16(o), WG_D16(o + 16)
#define WG_D64(o) WG_D32(o), WG_D32(o + 32)
#define WG_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R16 WG_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R32 WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R64 WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B from shared memory; TA / TB
// = 1: that operand is MN-major (transposed), else K-major
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" WG_R8 "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : WG_D8(0) : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_R16 "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : WG_D16(0) : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32 "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : WG_D32(0) : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  } else {
    static_assert(N == 128, "wgmma_ss: N is 16, 32, 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64 "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : WG_D64(0) : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A in registers (the accumulator
// layout of a [64 x 16] tile, bf16 pairs), B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" WG_R8 "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : WG_D8(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_R16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_D16(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D32(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    static_assert(N == 128, "wgmma_rs: N is 16, 32, 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D64(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}

#undef WG_D8
#undef WG_D16
#undef WG_D32
#undef WG_D64
#undef WG_R8
#undef WG_R16
#undef WG_R32
#undef WG_R64

// S (+)= A B^T for one warpgroup's 64 rows of A and N rows of B, both
// K-major [rows, HD] head tiles: one wgmma per 16 columns of the head dim.
// A's tile has A_ROWS rows per box and B's B_ROWS (the boxes' strides); a
// descriptor's low bits are the address / 16, so an offset within a tile is
// added to them.
template <int HD, int N, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void issue_abt(float (&d)[N / 2], uint64_t da, uint64_t db) {
  using T = HeadTile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 / T::BOX, col = kk * 16 % T::BOX;
    wgmma_ss<N, 0, 0>(d, da + ((c * A_ROWS * T::ROW + col * 2) >> 4),
                      db + ((c * B_ROWS * T::ROW + col * 2) >> 4), kk > 0);
  }
}

// D += P V over K_STEPS * 16 rows of V: P from registers (one [64 x 16]
// fragment per k-step), V an MN-major [rows, HD] head tile (its boxes LBO
// apart in the descriptor)
template <int HD, int K_STEPS>
__device__ __forceinline__ void issue_pv(float (&d)[HD / 2],
                                         const uint32_t (&pa)[K_STEPS][4], uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < K_STEPS; ++kk)
    wgmma_rs<HD>(d, pa[kk], dv + ((kk * 16 * HeadTile<HD>::ROW) >> 4), 1);
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver function, looked up once through
// cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// [B, L, D] bf16 as a 3D map (D innermost), box [1, rows, BOX] at the
// swizzle of the box's row
template <int HD>
bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int D, int rows) {
  using T = HeadTile<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::BOX, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = T::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the card's SM count, for a persistent grid
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace
