// Multi-head flash attention forward on token-major [B, L, D] tensors.
//
// Replaces, in smokephysai_tpu/ops/pallas/attention.py:
// - _flash_kernel_bld (:478), the kernel of flash_attention_tokens (:521),
//   the serving primal of flash_attention_tokens_trainable: out =
//   softmax(q k^T * scale) v per head, where head h is the column slice
//   [h*hd, (h+1)*hd) of D, P is cast to v's type before P.V with float32
//   accumulation, and no logsumexp is kept (the lean instantiation);
// - _flash_fwd_kernel_bld (:135), the kernel of _flash_tokens_fwd_lse
//   (:315), the training forward: the same, and lse = max + log(sum) per
//   row and head, [B, H, L] float32 in natural-log units, for the backward
//   in csrc/flash_bwd.cu (the LSE instantiation: the lean code with the lse
//   store compiled in, so both give the same output bits);
// - flash_attention (:82), head-major [B, H, L, hd]: the wrapper launches
//   the lean instantiation on the [B*H, L, hd] view with one head.
//
// What bounds it on an H100: operations at the model's shapes. Serving
// (B=64, L=1024, D=512, 8 heads of 64) does 4*B*H*L^2*64 = 137 GFLOP on
// 268 MB of bf16 in and out, ~510 FLOP per byte, above the card's ~295
// FLOP/byte ridge: 0.139 ms at 989 TFLOP/s; training (B=8) 17.2 GFLOP,
// 0.0174 ms. Bytes where the batch is small: the volumetric trunk at B=1
// ([1,512,256], 8 heads of 32) moves 1 MB for 0.27 GFLOP, 0.3 us at 3.35
// TB/s; there the launch and one wave of 32 CTAs set the time.
//
// Design (sm_90a: wgmma, TMA, mbarriers, setmaxnreg), for the tensor-core
// rate that only wgmma reaches:
// - One persistent CTA per SM walks the (128-query tile, head, batch) work
//   items in order, so one item's epilogue overlaps the next one's loads.
//   A CTA is a producer warpgroup (one thread issues every TMA load; the
//   group gives up registers with setmaxnreg) and two consumer warpgroups,
//   each owning 64 query rows (wgmma's M).
// - TMA copies Q (once per item) and 128-key tiles of K and V into a ring
//   of shared-memory stages (3 stages, 2 at head_dim 128), each guarded by
//   a full and an empty mbarrier, for K and V apart so S = Q K^T can start
//   while V is still in flight. The tensor maps are 3D over [B, L, D] with
//   a box of [1, rows, hd] at column h*hd, read in place: no transposes
//   surround the call, as on the TPU. Rows past L zero-fill instead of
//   reading the next batch element. Keys past L (L % 128 == 64: the TAIL
//   instantiation) are masked to -inf before the max; a consumer whose 64
//   queries lie past L runs on the zero fill and stores nothing. The
//   swizzle is the row's bytes (32, 64 or 128; at head_dim 128 two
//   64-column boxes under the 128-byte swizzle), and the wgmma descriptors
//   name the same layout.
// - S = Q K^T is wgmma m64n128k16 with Q and K from shared memory and the
//   accumulator in registers. The online softmax runs on that register
//   fragment (row max and row sum across the quad by shuffles, exp2 with
//   scale * log2(e) folded into one FMA). P is rounded to bf16 in registers
//   and is the register A operand of O += P V (wgmma m64n{hd}k16, V from
//   shared memory as the MN-major B). O stays in float32 registers across
//   all key tiles, is rescaled there and is written once, as acc / l.
//   Nothing but the K/V ring and Q touches shared memory in the key loop.
// - Within a warpgroup, S of tile j and P V of tile j-1 are issued together
//   and the softmax of tile j runs while P V finishes. Three rules of ptxas
//   shape the code, each of which otherwise serialises every wgmma or the
//   overlap: the consumers have no divergent branch (arrivals and stores
//   are predicated instructions), the softmax only reads the S registers,
//   and P alternates between two register sets instead of being copied.
//   Turn-taking between the two warpgroups (named barriers) was slower on
//   the card and is not used.
// Numerics as the TPU kernel and the plain version: the row sum l adds the
// float32 p, P is rounded to v's type before P.V, which sums in float32,
// and lse = m * ln 2 + log(l) with the max m kept in log2 units.
//
// float32 (for checking the algorithm at full precision): a scalar FMA
// kernel, one thread per query row, 64-query and 64-key tiles.
//
// Head dim: a template parameter, instantiated for 16, 32, 64 and 128 (the
// launcher picks it from D / heads). Shared memory per CTA, bf16: Q 128*hd*2
// plus 2 * stages * 128*hd*2 for the ring (28 KB at 16, 56 KB at 32, 112 KB
// at 64, 160 KB at 128); float32: 2 * 64 * hd * 4 (32 KB at 64).
//
// cuTensorMapEncodeTiled, a driver function, is looked up once through
// cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda.
// FLASH_PROBE_NO_KV_LOADS and FLASH_PROBE_NO_EXP make measurement-only
// builds with wrong results (scripts/flash_fwd_probe.py): K and V loaded
// for the first tiles only, and the exponentials replaced by their input.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------- bf16 (Hopper)

constexpr int BQ = 128;      // query rows per work item: two consumer warpgroups
constexpr int BK = 128;      // keys per K/V tile
constexpr int THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

template <int HD>
struct Cfg {
  static constexpr int BOX = HD < 64 ? HD : 64;  // columns per TMA box
  static constexpr int ROW = BOX * 2;            // bytes per box row = swizzle span
  static constexpr int NBOX = HD / BOX;          // 2 at head_dim 128
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static constexpr int STAGES = HD == 128 ? 2 : 3;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int NBARS = 2 + 4 * STAGES;
  // + 1024: the dynamic shared memory is aligned up to the 128-byte
  // swizzle's 1024-byte period inside the kernel
  static constexpr int SMEM = BAR_OFFSET + NBARS * 8 + 1024;
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

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


// S = Q K^T for one warpgroup's 64 rows and a 128-key tile: one wgmma per
// 16 columns of the head dim, from descriptors of the warpgroup's Q rows
// and of the stage's K tile (K-major; a descriptor's low bits are the
// address / 16, so an offset within the tile is added to them)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint64_t dq, uint64_t dk) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 / C::BOX, col = kk * 16 % C::BOX;
    wgmma_ss_n128(sc, dq + ((c * BQ * C::ROW + col * 2) >> 4),
                  dk + ((c * BK * C::ROW + col * 2) >> 4), kk > 0);
  }
}

// O += P V for a 128-key tile: P from registers, V MN-major (one wgmma per
// 16 keys; at head_dim 128 the two 64-column boxes are LBO apart)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint64_t dv) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t d = dv + ((kk * 16 * C::ROW) >> 4);
    if constexpr (HD == 16) wgmma_rs_n16(acc, pa[kk], d, 1);
    else if constexpr (HD == 32) wgmma_rs_n32(acc, pa[kk], d, 1);
    else if constexpr (HD == 64) wgmma_rs_n64(acc, pa[kk], d, 1);
    else wgmma_rs_n128(acc, pa[kk], d, 1);
  }
}

// The online softmax of one S tile in its register fragment: sc[4i + e] is
// row r0 (e < 2) or r1 = r0 + 8, key 8i + 2 quad + (e & 1). With TAIL
// (L % 128 == 64), keys at or past `valid` (64 or more) are masked. The
// running max (log2 units) and this thread's part of the row sums are
// updated from the float32 p = exp2(s * scale_log2 - max); c0, c1 are the
// factors the accumulator rows are rescaled by. P = p rounded to bf16 goes to pb: the accumulator's
// layout for keys [16kk, 16kk + 16) is the register A operand's layout of
// that k-step, so neighbouring pairs pack straight into it. sc is only
// read: ptxas waits out every wgmma in flight before a write to a register
// a wgmma wrote, which would stop this overlapping the P V in flight (and
// pb must not be the registers that product reads).
template <bool TAIL>
__device__ __forceinline__ void online_softmax(const float (&sc)[BK / 2], int valid,
                                               float scale_log2, float& m0, float& m1,
                                               float& l0, float& l1, float& c0, float& c1,
                                               uint32_t (&pb)[BK / 16][4]) {
  // L is a multiple of 64, so only the upper 64 keys of the last tile can
  // lie past L: capped at -inf there, by a select rather than a branch
  const float cap = valid > BK / 2 ? INFINITY : -INFINITY;
  auto score = [&](int i) { return TAIL && i >= BK / 4 ? fminf(sc[i], cap) : sc[i]; };
  float x0 = NEG_INF, x1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    x0 = fmaxf(x0, fmaxf(score(4 * i), score(4 * i + 1)));
    x1 = fmaxf(x1, fmaxf(score(4 * i + 2), score(4 * i + 3)));
  }
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  const float n0 = fmaxf(m0, x0 * scale_log2), n1 = fmaxf(m1, x1 * scale_log2);
  c0 = ex2(m0 - n0);
  c1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // keys of pair e: row r0 for e even, r1 for e odd
      const int i = 8 * kk + 2 * e;
      const float n = e % 2 ? n1 : n0;
      const float p0 = ex2(fmaf(score(i), scale_log2, -n));
      const float p1 = ex2(fmaf(score(i + 1), scale_log2, -n));
      (e % 2 ? sum1 : sum0) += p0 + p1;
      pb[kk][e] = pack_bf16(p0, p1);
    }
  l0 = l0 * c0 + sum0;  // summed across the quad once, at the end
  l1 = l1 * c1 + sum1;
}

template <int HD, bool LSE, bool TAIL>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int L, int D,
                 int H, int nq, int items, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int ST = C::STAGES, ROW = C::ROW, BOX = C::BOX;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to that
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + C::Q_BYTES;      // stage s at + s * KV_BYTES
  const uint32_t sV = sK + ST * C::KV_BYTES;  // 〃
  const uint32_t bars = base + C::BAR_OFFSET;
  const uint32_t full_q = bars, empty_q = bars + 8;
  const uint32_t full_k = bars + 16, full_v = full_k + 8 * ST;  // stage s at + 8 * s
  const uint32_t empty_k = full_v + 8 * ST, empty_v = empty_k + 8 * ST;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 8);  // one arrival per consumer warp
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 8);
      mbar_init(empty_v + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (L + BK - 1) / BK;  // key tiles per item
  const int wg = threadIdx.x / 128;  // 0: producer, 1 and 2: consumers

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0, qph = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, qph ^= 1) {
        const int qt = item % nq, h = (item / nq) % H, b = item / (nq * H);
        mbar_wait(empty_q, qph ^ 1);
        mbar_expect_tx(full_q, C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::NBOX; ++c)
          tma_load_3d(sQ + c * BQ * ROW, &tm_q, full_q, h * HD + c * BOX, qt * BQ, b);
        for (int j = 0; j < nk; ++j) {
#ifdef FLASH_PROBE_NO_KV_LOADS  // measurement only: what the K/V loads cost
          if (item != (int)blockIdx.x || j >= ST) {
            mbar_wait(empty_k + 8 * s, ph ^ 1);
            mbar_arrive_if(full_k + 8 * s, true);
            mbar_wait(empty_v + 8 * s, ph ^ 1);
            mbar_arrive_if(full_v + 8 * s, true);
            if (++s == ST) { s = 0; ph ^= 1; }
            continue;
          }
#endif
          mbar_wait(empty_k + 8 * s, ph ^ 1);
          mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::NBOX; ++c)
            tma_load_3d(sK + s * C::KV_BYTES + c * BK * ROW, &tm_k, full_k + 8 * s,
                        h * HD + c * BOX, j * BK, b);
          mbar_wait(empty_v + 8 * s, ph ^ 1);
          mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
#pragma unroll
          for (int c = 0; c < C::NBOX; ++c)
            tma_load_3d(sV + s * C::KV_BYTES + c * BK * ROW, &tm_v, full_v + 8 * s,
                        h * HD + c * BOX, j * BK, b);
          if (++s == ST) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int cw = wg - 1;  // this warpgroup's 64 rows of the 128-query tile
    const int t = threadIdx.x % 128, lane = t % 32, quad = lane & 3;
    // this thread's two fragment rows within the item's 128 queries
    const int r0 = cw * 64 + (t / 32) * 16 + lane / 4, r1 = r0 + 8;
    // the descriptors of this warpgroup's Q rows and of stage 0's K and V
    const uint64_t dq = make_desc(sQ + cw * 64 * ROW, 16, 8 * ROW, C::LAYOUT);
    const uint64_t dk0 = make_desc(sK, 16, 8 * ROW, C::LAYOUT);
    const uint64_t dv0 = make_desc(sV, BK * ROW, 8 * ROW, C::LAYOUT);
    constexpr uint64_t STAGE = C::KV_BYTES >> 4;  // a stage's step in the descriptor
    const bool leader = lane == 0;  // arrives on the empty barriers for its warp
    int s = 0;
    uint32_t ph = 0, qph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, qph ^= 1) {
      const int qt = item % nq, h = (item / nq) % H, b = item / (nq * H);
      // past L (L % 128 == 64) the warpgroup's Q rows are TMA's zero fill:
      // it runs the same code (no branch) and stores nothing
      const bool active = qt * BQ + cw * 64 < L;
      float acc[HD / 2], sc[BK / 2], c0, c1;
      uint32_t pa[BK / 16][4], pb[BK / 16][4];  // P of alternate tiles
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
      float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;  // m in log2 units

      // tile 0: S and its softmax
      mbar_wait(full_q, qph);
      mbar_wait(full_k + 8 * s, ph);
      wgmma_fence();
      issue_qk<HD>(sc, dq, dk0 + s * STAGE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive_if(empty_k + 8 * s, leader);
      mbar_arrive_if(empty_q, leader && nk == 1);
      online_softmax<TAIL>(sc, L, scale_log2, m0, m1, l0, l1, c0, c1, pa);
      int sv = s;  // the stage of the V tile that pa multiplies
      uint32_t phv = ph;
      if (++s == ST) { s = 0; ph ^= 1; }

      // tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} in flight together;
      // the softmax of S_j runs while the second product finishes. P_{j-1}
      // is read from `pin` while P_j is written to `pout`: the two register
      // sets alternate from tile to tile, since a copy from one to the other
      // would let ptxas merge them.
      auto tile = [&](int j, const uint32_t (&pin)[BK / 16][4], uint32_t (&pout)[BK / 16][4]) {
        mbar_wait(full_k + 8 * s, ph);
        mbar_wait(full_v + 8 * sv, phv);
        wgmma_fence();
        issue_qk<HD>(sc, dq, dk0 + s * STAGE);
        wgmma_commit();
        issue_pv<HD>(acc, pin, dv0 + sv * STAGE);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        mbar_arrive_if(empty_k + 8 * s, leader);
        mbar_arrive_if(empty_q, leader && j == nk - 1);
        online_softmax<TAIL>(sc, L - j * BK, scale_log2, m0, m1, l0, l1, c0, c1, pout);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive_if(empty_v + 8 * sv, leader);
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          acc[4 * i] *= c0;
          acc[4 * i + 1] *= c0;
          acc[4 * i + 2] *= c1;
          acc[4 * i + 3] *= c1;
        }
        sv = s;
        phv = ph;
        if (++s == ST) { s = 0; ph ^= 1; }
      };
      // the last tile's O += P V
      auto last = [&](const uint32_t (&pin)[BK / 16][4]) {
        mbar_wait(full_v + 8 * sv, phv);
        wgmma_fence();
        issue_pv<HD>(acc, pin, dv0 + sv * STAGE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive_if(empty_v + 8 * sv, leader);
      };
      for (int j = 1; j < nk; j += 2) {
        tile(j, pa, pb);
        if (j + 1 < nk) tile(j + 1, pb, pa);
      }
      if (nk % 2) last(pa);
      else last(pb);

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const int q0 = qt * BQ;
      __nv_bfloat16* o0 = o + ((size_t)b * L + q0 + r0) * D + h * HD + 2 * quad;
      __nv_bfloat16* o1 = o0 + (size_t)8 * D;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        st_b32_if(o0 + 8 * i, pack_bf16(acc[4 * i] / l0, acc[4 * i + 1] / l0), active);
        st_b32_if(o1 + 8 * i, pack_bf16(acc[4 * i + 2] / l1, acc[4 * i + 3] / l1), active);
      }
      if constexpr (LSE) {
        float* dst = lse + ((size_t)b * H + h) * L + q0;
        st_b32_if(dst + r0, __float_as_uint(m0 * LN2 + logf(l0)), active && quad == 0);
        st_b32_if(dst + r1, __float_as_uint(m1 * LN2 + logf(l1)), active && quad == 0);
      }
    }
  }
}

// ---------------------------------------------------------------- float32

constexpr int F32_BQ = 64;  // query rows per block, one per thread
constexpr int F32_BK = 64;  // keys per tile

template <int HD, bool LSE>
__global__ void __launch_bounds__(F32_BQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int L, int D, float scale) {
  // K and V tiles [F32_BK][HD] each, dynamic: 64 KB at head_dim 128
  extern __shared__ __align__(16) float smem32[];
  float (*sK)[HD] = reinterpret_cast<float (*)[HD]>(smem32);
  float (*sV)[HD] = reinterpret_cast<float (*)[HD]>(smem32 + F32_BK * HD);
  const size_t base = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * HD;
  const int row = blockIdx.x * F32_BQ + threadIdx.x;
  float qr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = q[base + (size_t)row * D + c];
    acc[c] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;
  for (int k0 = 0; k0 < L; k0 += F32_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_BK * HD; i += blockDim.x) {
      int j = i / HD, c = i % HD;
      sK[j][c] = k[base + (size_t)(k0 + j) * D + c];
      sV[j][c] = v[base + (size_t)(k0 + j) * D + c];
    }
    __syncthreads();
    float s[F32_BK];
    float mx = NEG_INF;
    for (int j = 0; j < F32_BK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < HD; ++c) dot += qr[c] * sK[j][c];
      s[j] = dot * scale;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] *= corr;
    for (int j = 0; j < F32_BK; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
#pragma unroll
      for (int c = 0; c < HD; ++c) acc[c] += p * sV[j][c];
    }
    l = l * corr + sum;
    m = m_new;
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) o[base + (size_t)row * D + c] = acc[c] / l;
  if (LSE) lse[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * L + row] = m + logf(l);
}

// ---------------------------------------------------------------- launchers

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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
  using C = Cfg<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)C::BOX, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = C::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : C::ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool LSE>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int L, int heads, int D, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!make_map<HD>(&tq, q, B, L, D, BQ) || !make_map<HD>(&tk, k, B, L, D, BK) ||
      !make_map<HD>(&tv, v, B, L, D, BK))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int nq = (L + BQ - 1) / BQ;
  const long long items = (long long)nq * heads * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // L % 128 == 64: the instantiation that masks the last key tile
  auto kernel = L % BK ? flash_fwd_kernel<HD, LSE, true> : flash_fwd_kernel<HD, LSE, false>;
  constexpr int smem = Cfg<HD>::SMEM;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = items < sms ? (int)items : sms;
  kernel<<<grid, THREADS, smem, st>>>(tq, tk, tv, (__nv_bfloat16*)o, lse, L, D, heads, nq,
                                      (int)items, (float)((double)scale * 1.4426950408889634));
  return (int)cudaGetLastError();
}

template <int HD, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int L, int heads, int D, float scale, int dtype,
           cudaStream_t st) {
  if (dtype == 0) return launch_bf16<HD, LSE>(q, k, v, o, lse, B, L, heads, D, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = 2 * F32_BK * HD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L / F32_BQ, heads, B);
  flash_f32_kernel<HD, LSE><<<grid, F32_BQ, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, L, D, scale);
  return (int)cudaGetLastError();
}

template <bool LSE>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int L, int heads, int D, float scale,
              int dtype, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16, LSE>(q, k, v, o, lse, B, L, heads, D, scale, dtype, st);
    case 32: return launch<32, LSE>(q, k, v, o, lse, B, L, heads, D, scale, dtype, st);
    case 64: return launch<64, LSE>(q, k, v, o, lse, B, L, heads, D, scale, dtype, st);
    case 128: return launch<128, LSE>(q, k, v, o, lse, B, L, heads, D, scale, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Needs head_dim D / heads in {16, 32, 64,
// 128} and L a multiple of 64; q, k, v, o contiguous [B, L, D], 16-byte aligned.
// lse: null for the lean (serving) kernel, else [B, heads, L] float32.
extern "C" int flash_tokens_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int L, int D,
                                int heads, float scale, int dtype,
                                void* stream) {
  if (B <= 0 || L <= 0 || L % 64 != 0 || heads <= 0 || D % heads != 0 ||
      B > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = D / heads;
  if (lse == nullptr)
    return launch_hd<false>(hd, q, k, v, o, nullptr, B, L, heads, D, scale, dtype, st);
  return launch_hd<true>(hd, q, k, v, o, (float*)lse, B, L, heads, D, scale, dtype, st);
}
