// Multi-head flash attention backward on token-major [B, L, D] tensors.
//
// Replaces, in smokephysai_tpu/ops/pallas/attention.py, _flash_trainable_bwd
// (:366), the backward of flash_attention_tokens_trainable:
// - fused (the default): _flash_bwd_fused_kernel (:254), launched at :412;
// - split (SMOKEPHYS_FUSED_BWD=0): _flash_bwd_dq_kernel (:178, launched at
//   :436) and _flash_bwd_dkv_kernel (:214, launched at :449).
// From q, k, v, dO, the forward's logsumexp lse [B, H, L] and delta =
// rowsum(dO * O) [B, H, L] (a plain PyTorch reduce before the launch, as it
// is an XLA reduce in JAX), per head h (the column slice [h*hd, (h+1)*hd)):
//   S = q k^T * scale,  P = exp(S - lse),  dP = dO v^T,
//   dS = P * (dP - delta) * scale,
//   dV = P^T dO,  dK = dS^T q,  dQ = dS k,
// rounding where the TPU kernels round: P to v's type before P^T dO, dS to
// q's type before dS k and dS^T q, every product summed in float32.
//
// What bounds it on an H100: operations. At the training shape (B=8,
// L=1024, D=512, 8 heads of 64) the fused kernel's five products are
// 10*B*H*L^2*hd = 43 GFLOP on ~50 MB in and out (~860 FLOP per byte, above
// the ~295 FLOP/byte ridge): 0.043 ms at 989 TFLOP/s bf16. The split pair
// recomputes S and dP in both kernels: dq 6*B*H*L^2*hd = 25.8 GFLOP (0.026
// ms), dk/dv 8*B*H*L^2*hd = 34.4 GFLOP (0.035 ms).
//
// Design, bf16 (sm_90a: wgmma, TMA, mbarriers, setmaxnreg; the primitives
// in hopper.cuh). Both kernels are persistent: one CTA per SM walks the
// work items in order. A CTA is a producer warpgroup (one thread issues
// every TMA load; the group gives up registers with setmaxnreg) and two
// consumer warpgroups, each owning 64 rows of the item (wgmma's M). TMA
// reads the [B, L, D] tensors in place through 3D tensor maps (box [1,
// rows, hd] at column h*hd, zero fill past L), as the forward does, so no
// transposes surround the call.
// - The key-tile kernel, flash_bwd_kv_kernel<HD, DQ> (DQ: the fused
//   kernel; !DQ: the split route's dk/dv kernel, the same code with the dQ
//   step compiled out, so its dk and dv are the fused kernel's bits). An
//   item is (128-key tile, head, batch): K and V of the tile are loaded
//   once; 64-query tiles of Q and dO, with their 64 lse and delta values
//   (1D bulk copies), stream through a ring of 3 stages under full and
//   empty mbarriers. Each consumer computes S^T = K Q^T and dP^T = V dO^T
//   for its 64 keys (wgmma m64n64k16, both operands K-major from shared
//   memory, accumulators in registers), then P^T = exp2(S^T * scale *
//   log2(e) - lse * log2(e)) and dS^T on those registers, rounded to bf16
//   there: they are the register A operands of dV += P^T dO and dK += dS^T
//   Q (wgmma m64n{hd}k16, dO and Q from shared memory as MN-major B). dK
//   and dV stay in float32 registers across all query tiles and are
//   written once, in k's type. The CTAs of one head start at different
//   query tiles (key tile kt at query tile kt), so they do not add into
//   the same dQ rows at once.
// - dQ (DQ only): each consumer writes its dS^T (64 keys x 64 queries,
//   bf16) to shared memory under the 128-byte swizzle, into one of two
//   buffers by the tile's parity; after a named barrier over both
//   consumers, one of them computes the tile's dQ = dS K over all 128 keys
//   (wgmma with dS as MN-major A and K as MN-major B) and adds it into the
//   zeroed float32 [B, L, D] dQ buffer by vector reductions
//   (red.global.add.v4.f32: four columns per thread after one exchange
//   within the quad). The two take turns by the tile's parity:
//   the turn is a template parameter of each consumer's loop, chosen once,
//   so no branch on the warpgroup crosses a product. One share per 128 keys
//   goes to the buffer (8 per dQ value at L = 1024), half of what one share
//   per warpgroup sent. The order of the sum still varies from run to run.
// - The query-tile kernel, flash_bwd_dq_kernel<HD> (the split route's dq,
//   no atomics: its dq is the same bits on every run, and each batch
//   element's is that of a call on it alone). An item is (128-query tile,
//   head, batch): Q and dO are loaded once, tiles of 128 keys (64 at
//   head_dim 128) of K and V stream through the ring. Each consumer
//   computes S = Q K^T and dP = dO V^T for its 64 queries (wgmma, K-major,
//   as the forward's S), P and dS on those registers with the row's lse
//   and delta held in registers, dS rounded to bf16 as the register A
//   operand of dQ += dS K (K as MN-major B). dQ stays in float32
//   registers and is written once, in q's type.
// - Tails (L % 128 == 64). Only a 128-row tile can reach past L. Its rows
//   there are TMA's zero fill: zero keys give S = dP = 0 and a dS whose
//   product with the zero K rows adds nothing, and a consumer whose 64 rows
//   lie past L computes on the fill and stores nothing. lse and delta past
//   L are read as 0 (never the next batch element's), so P and dS stay
//   finite there.
// - Each consumer waits out its products before its elementwise step and
//   again before the next tile; the other consumer's products fill the
//   tensor cores meanwhile. There is no divergent branch in a consumer's
//   loop (predicated arrivals, stores and reductions), which ptxas would
//   answer by serialising every wgmma (C7513, C7518 in -Xptxas -v).
// What the design does about the WMMA kernels' limits: S^T, dP^T, P^T and
// dS^T never go through shared memory, except dS^T for dQ (once per query
// tile); dQ's one scalar atomicAdd per value and block became one vector
// reduction per four values and 128 keys; TMA loads run ahead of the
// products in the ring instead of between two __syncthreads; a CTA is three
// warpgroups, the consumers at up to 240 registers (setmaxnreg), and reads
// each Q and dO tile once per 128 keys, not once per 64.
//
// Head dim: a template parameter, instantiated for 16, 32, 64 and 128 (the
// launcher picks it from D / heads). Shared memory per CTA, bf16: key-tile
// kernel K, V 2 * 128 * hd * 2 + 3 stages of Q, dO (2 * 64 * hd * 2) and
// lse, delta (512), + two dS^T buffers of 16 KB with DQ (fused: 55 KB at
// 16, 75 KB at 32, 115 KB at 64, 195 KB at 128; dk/dv 32 KB less);
// query-tile kernel Q, dO 2 * 128 * hd * 2 + 3 stages of K, V (2 * BK * hd
// * 2): 33 KB at 16, 65 KB at 32, 129 KB at 64, 161 KB at 128. Registers
// per consumer thread: dK and dV hd/2 floats each, S^T and dP^T 32 each,
// P^T and dS^T 16 each, a tile's dQ hd/2. ptxas (CUDA 12.9) spills only in
// the fused kernel at head_dim 128: 344 bytes of spill stores and 524 of
// loads per thread (192-byte stack frame); the dk/dv kernel there and
// every other instantiation spill nothing. float32 key-tile kernel: K, V 2
// * 64 * (hd + 4) * 4, two stages of Q, dO, lse, delta, + the tile's dS
// [QT][68] with DQ (fused: 72 KB at 32, 77 KB at 64, 141 KB at 128); ptxas
// gives the fused kernel 221 registers at 16 and 255 above, the
// dk/dv kernel 145 / 235 / 165 / 255, and spills in neither.
// Tried on the card and dropped, no faster beyond the spread between calls
// at any head dim: issuing the next tile's S^T and dP^T with this tile's
// dV and dK (one wait per tile; it ran out of registers at head_dim 128,
// ptxas C7512); K and V of the item held as register A operands at
// head_dim <= 64; and, at head_dim 128, dP^T issued only after P^T was
// formed, or the tile's dQ computed in two 64-column halves (the spill
// stayed).
//
// float32, flash_bwd_f32_kernel<HD, DQ> (DQ: the fused kernel; !DQ: the
// split route's dk/dv kernel, the same code with the dQ step compiled out,
// so its dk and dv are the fused kernel's bits). Bound at [8,1024,512], 8
// heads of 64: 43 GFLOP, 0.261 ms at 165 TFLOP/s (split TF32, tf32.cuh; see
// flash_tokens.cu for the split and for mma.sync rather than wgmma).
// - A CTA of four warps, 64 keys (F32_ROWS, tf32.cuh), per (key tile,
//   head, batch); each warp owns 16 keys. K and V of the tile are
//   loaded once into shared memory; tiles of 32 queries (64 at head dims up
//   to 32) of Q and dO, with their lse and delta, stream through two stages
//   by cp.async (row pitch hd + 4 floats: conflict-free fragment loads).
//   The 64-key blocks of a head start at different query tiles, so they
//   add into different dQ rows at once.
// - Per query tile and warp: S^T = K Q^T and dP^T = V dO^T (K and V split
//   per k-step from shared memory), then P^T = exp2(S^T * scale * log2(e) -
//   lse * log2(e)) and dS^T = P^T (dP^T - delta) scale on the fragments;
//   their C fragments are the A fragments of dV += P^T dO and dK += dS^T Q
//   as they stand (queries of a k-step in the order (2t, 2t + 1)). Each
//   head-column tile's sum over the query tile is formed in a fresh
//   accumulator and added to dK, dV in float32 registers (the tensor cores
//   truncate as they accumulate: one accumulator over all of L crossed the
//   1e-5 bound at head_dim 128); dK and dV are written once.
// - DQ: dS^T goes to shared memory as dS, the tile's dQ = dS K over the
//   CTA's 64 keys is formed by MMA in units of (16 queries, half the head
//   columns) spread over the warps, and added into the zeroed float32 dq by
//   red.global.add.v4.f32, four columns per thread after one exchange in
//   the quad: one reduction per four values and 64 keys, where the scalar
//   kernel took an atomicAdd per value. The order of that sum varies from
//   run to run.
// The split dq kernel in float32 (flash_bwd_dq_f32_kernel) is still the
// scalar one: one thread per query of a 64-query tile, FMA products.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- bf16 (Hopper)

constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int STAGES = 3;

// a 32-bit store to shared memory
__device__ __forceinline__ void st_shared_b32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(dst), "r"(v) : "memory");
}

// FLASH_PROBE_NO_DQ_RED makes a measurement-only build with a wrong dq
// (scripts/flash_probe.py): the fused kernel's dQ reductions are not issued
#ifdef FLASH_PROBE_NO_DQ_RED
constexpr bool RED = false;
#else
constexpr bool RED = true;
#endif

// adds four floats to 16-byte aligned global memory where `pred` holds
// (predicated, as mbar_arrive_if)
__device__ __forceinline__ void red_add_v4_if(float* dst, float a, float b, float c,
                                              float d, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n}\n"
      :: "l"(dst), "f"(a), "f"(b), "f"(c), "f"(d), "r"((int)pred) : "memory");
}

// float32 [64 x HD] accumulator rows r0, r1 (the thread's fragment rows)
// to bf16 at `dst` (row 0 of the warpgroup's 64, column 2 * quad), stored
// where `pred` holds
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[HD / 2],
                                           int r0, int D, bool pred) {
  __nv_bfloat16* d0 = dst + (size_t)r0 * D;
  __nv_bfloat16* d1 = d0 + (size_t)8 * D;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    st_b32_if(d0 + 8 * i, pack_bf16(acc[4 * i], acc[4 * i + 1]), pred);
    st_b32_if(d1 + 8 * i, pack_bf16(acc[4 * i + 2], acc[4 * i + 3]), pred);
  }
}

// ---------------------------------------------------------------- key-tile kernel

constexpr int KV_ROWS = 128;  // keys per work item: 64 per consumer warpgroup
constexpr int Q_ROWS = 64;    // queries per streamed tile

template <int HD, bool DQ>
struct KvCfg {
  static constexpr int KV_BYTES = KV_ROWS * HD * 2;  // the K or the V tile
  static constexpr int QT_BYTES = Q_ROWS * HD * 2;   // a Q or a dO tile
  static constexpr int STAGE_BYTES = 2 * QT_BYTES;   // Q, then dO
  static constexpr int DS_OFFSET = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  // dS^T of both warpgroups, bf16, twice (the tile's index in the item, mod 2)
  static constexpr int DS_BUF = KV_ROWS * Q_ROWS * 2;
  static constexpr int DS_BYTES = DQ ? 2 * DS_BUF : 0;
  static constexpr int VEC_BYTES = 2 * Q_ROWS * 4;   // a stage's lse, then delta
  static constexpr int VEC_OFFSET = DS_OFFSET + DS_BYTES;
  static constexpr int BAR_OFFSET = VEC_OFFSET + STAGES * VEC_BYTES;
  static constexpr int NBARS = 2 + 2 * STAGES;
  // + 1024: the dynamic shared memory is aligned up to the 128-byte
  // swizzle's 1024-byte period inside the kernel
  static constexpr int SMEM = BAR_OFFSET + NBARS * 8 + 1024;
};

template <int HD, bool DQ>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* dq, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int L, int D, int H, int nkt,
                    int items, float scale, float scale_log2) {
  using C = KvCfg<HD, DQ>;
  using T = HeadTile<HD>;
  constexpr int ROW = T::ROW, BOX = T::BOX;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to that
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + C::KV_BYTES;
  const uint32_t sQ = base + 2 * C::KV_BYTES;  // stage s at + s * STAGE_BYTES, dO at + QT_BYTES
  const uint32_t sDS = base + C::DS_OFFSET;
  const uint32_t sVec = base + C::VEC_OFFSET;  // stage s at + s * VEC_BYTES
  const uint32_t bars = base + C::BAR_OFFSET;
  const uint32_t full_kv = bars, empty_kv = bars + 8;
  const uint32_t full = bars + 16, empty = full + 8 * STAGES;  // stage s at + 8 * s
  const int nq = L / Q_ROWS;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 8);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;  // 0: producer, 1 and 2: consumers

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0, kvph = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, kvph ^= 1) {
        const int kt = item % nkt, h = (item / nkt) % H, b = item / (nkt * H);
        mbar_wait(empty_kv, kvph ^ 1);
        mbar_expect_tx(full_kv, 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::NBOX; ++c) {
          tma_load_3d(sK + c * KV_ROWS * ROW, &tm_k, full_kv, h * HD + c * BOX, kt * KV_ROWS, b);
          tma_load_3d(sV + c * KV_ROWS * ROW, &tm_v, full_kv, h * HD + c * BOX, kt * KV_ROWS, b);
        }
        const float* vl = lse + ((size_t)b * H + h) * L;
        const float* vd = delta + ((size_t)b * H + h) * L;
        int j = kt % nq;
        for (int n = 0; n < nq; ++n) {
          const uint32_t q_s = sQ + s * C::STAGE_BYTES, vec_s = sVec + s * C::VEC_BYTES;
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, C::STAGE_BYTES + C::VEC_BYTES);
#pragma unroll
          for (int c = 0; c < T::NBOX; ++c) {
            tma_load_3d(q_s + c * Q_ROWS * ROW, &tm_q, full + 8 * s, h * HD + c * BOX,
                        j * Q_ROWS, b);
            tma_load_3d(q_s + C::QT_BYTES + c * Q_ROWS * ROW, &tm_do, full + 8 * s,
                        h * HD + c * BOX, j * Q_ROWS, b);
          }
          bulk_load(vec_s, vl + j * Q_ROWS, Q_ROWS * 4, full + 8 * s);
          bulk_load(vec_s + Q_ROWS * 4, vd + j * Q_ROWS, Q_ROWS * 4, full + 8 * s);
          if (++j == nq) j = 0;
          if (++s == STAGES) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int cw = wg - 1;  // this warpgroup's 64 keys of the 128-key tile
    const int t = threadIdx.x % 128, lane = t % 32, quad = lane & 3;
    // this thread's two fragment rows within the warpgroup's 64
    const int r0 = (t / 32) * 16 + lane / 4, r1 = r0 + 8;
    // K-major: the warpgroup's keys of K and V (A of S^T and dP^T), stage
    // 0's Q and dO (their B)
    const uint64_t dk_a = make_desc(sK + cw * 64 * ROW, 16, 8 * ROW, T::LAYOUT);
    const uint64_t dv_a = make_desc(sV + cw * 64 * ROW, 16, 8 * ROW, T::LAYOUT);
    const uint64_t dq_b = make_desc(sQ, 16, 8 * ROW, T::LAYOUT);
    const uint64_t ddo_b = make_desc(sQ + C::QT_BYTES, 16, 8 * ROW, T::LAYOUT);
    // MN-major: stage 0's Q and dO as the B of dK and dV
    const uint64_t dq_mn = make_desc(sQ, Q_ROWS * ROW, 8 * ROW, T::LAYOUT);
    const uint64_t ddo_mn = make_desc(sQ + C::QT_BYTES, Q_ROWS * ROW, 8 * ROW, T::LAYOUT);
    constexpr uint64_t STAGE = C::STAGE_BYTES >> 4;  // a stage's step in the descriptor
    // dQ = dS K over the tile's 128 keys: dS^T of both warpgroups (a
    // 128-byte row of 64 queries per key; buffer 1 at + DS_BUF) as
    // MN-major A, the whole K tile as MN-major B
    const uint64_t dds_a = make_desc(sDS, 64 * 128, 8 * 128, 1);
    const uint64_t dk_mn = make_desc(sK, KV_ROWS * ROW, 8 * ROW, T::LAYOUT);
    const uint32_t ds_rows = sDS + cw * 64 * 128;  // this warpgroup's rows of dS^T
    const bool leader = lane == 0;  // arrives on the empty barriers for its warp
    const bool odd = quad & 1;      // the dQ reduction's role within the quad
    // generic pointer to stage 0's lse (delta at + Q_ROWS)
    const float* vec0 = reinterpret_cast<const float*>(smem_raw + (sVec - raw));

    // The consumer loop. With DQ the two warpgroups take turns at dQ: the
    // one whose TURN is the parity of the query tile's index in the item
    // computes the tile's whole dQ. TURN is a template parameter, chosen
    // once below, so no branch on the warpgroup crosses a product.
    auto consume = [&](auto turn) {
      constexpr int TURN = decltype(turn)::value;
      int s = 0;
      uint32_t ph = 0, kvph = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, kvph ^= 1) {
        const int kt = item % nkt, h = (item / nkt) % H, b = item / (nkt * H);
        const int k0 = kt * KV_ROWS + cw * 64;  // the warpgroup's first key
        // past L (L % 128 == 64) the warpgroup's K and V rows are TMA's zero
        // fill: it runs the same code (no branch) and stores nothing
        const bool active = k0 < L;
        float gk[HD / 2], gv[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) gk[i] = gv[i] = 0.0f;
        mbar_wait(full_kv, kvph);
        int j = kt % nq;

        // one query tile; BUF (the tile's index in the item, mod 2) picks
        // the dS^T buffer, and with DQ whether this warpgroup computes dQ
        auto tile = [&](auto buf) {
          constexpr int BUF = decltype(buf)::value;
          // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries)
          float st[Q_ROWS / 2], dpt[Q_ROWS / 2];
          mbar_wait(full + 8 * s, ph);
          wgmma_fence();
          issue_abt<HD, Q_ROWS, KV_ROWS, Q_ROWS>(st, dk_a, dq_b + s * STAGE);
          issue_abt<HD, Q_ROWS, KV_ROWS, Q_ROWS>(dpt, dv_a, ddo_b + s * STAGE);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(st);
          fence_regs(dpt);

          // P^T and dS^T in the accumulator layout: st[4g + e] is key row r0
          // (e < 2) or r1, query 8g + 2 quad + (e & 1); the pair of k-step
          // g/2, register 2 (g % 2) + (row r1) of the A operand
          uint32_t pp[Q_ROWS / 16][4], pds[Q_ROWS / 16][4];
          const float* vl = vec0 + s * (C::VEC_BYTES / 4);
#pragma unroll
          for (int g = 0; g < Q_ROWS / 8; ++g) {
            const float2 l2 = *reinterpret_cast<const float2*>(vl + 8 * g + 2 * quad);
            const float2 d2 = *reinterpret_cast<const float2*>(vl + Q_ROWS + 8 * g + 2 * quad);
            const float la = l2.x * LOG2E, lb = l2.y * LOG2E;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int i = 4 * g + 2 * rr;
              const float p0 = ex2(fmaf(st[i], scale_log2, -la));
              const float p1 = ex2(fmaf(st[i + 1], scale_log2, -lb));
              pp[g / 2][2 * (g % 2) + rr] = pack_bf16(p0, p1);
              pds[g / 2][2 * (g % 2) + rr] = pack_bf16(p0 * (dpt[i] - d2.x) * scale,
                                                       p1 * (dpt[i + 1] - d2.y) * scale);
            }
          }
          if constexpr (DQ) {
            // dS^T to shared memory under the 128-byte swizzle: the 16-byte
            // chunk g of row r sits at chunk g ^ (r & 7), and r & 7 = lane / 4
#pragma unroll
            for (int g = 0; g < Q_ROWS / 8; ++g)
#pragma unroll
              for (int rr = 0; rr < 2; ++rr)
                st_shared_b32(ds_rows + BUF * C::DS_BUF + (rr ? r1 : r0) * 128 +
                                  ((g ^ (lane >> 2)) << 4) + quad * 4,
                              pds[g / 2][2 * (g % 2) + rr]);
            fence_proxy_async();
          }

          // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
          wgmma_fence();
          issue_pv<HD, Q_ROWS / 16>(gv, pp, ddo_mn + s * STAGE);
          issue_pv<HD, Q_ROWS / 16>(gk, pds, dq_mn + s * STAGE);
          wgmma_commit();
          if constexpr (DQ) {
            // both warpgroups' dS^T of this tile are in shared memory, and
            // the previous tile's dQ is done reading the other buffer, which
            // the next tile writes
            bar_sync(1, 256);
          }
          wgmma_wait<0>();
          fence_regs(gk);
          fence_regs(gv);
          mbar_arrive_if(empty + 8 * s, leader);
          if constexpr (DQ && BUF == TURN) {
            // the tile's dQ (64 queries x HD) = dS K over its 128 keys
            float gq[HD / 2];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KV_ROWS / 16; ++kk)
              wgmma_ss<HD, 1, 1>(gq, dds_a + ((BUF * C::DS_BUF + kk * 16 * 128) >> 4),
                                 dk_mn + ((kk * 16 * ROW) >> 4), kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(gq);
            // four columns per thread: the even lane of a quad pair takes
            // row r0's four, the odd one row r1's, after swapping a pair each
            float* dst = dq + ((size_t)b * L + j * Q_ROWS + (odd ? r1 : r0)) * D + h * HD +
                         2 * (quad & 2);
#pragma unroll
            for (int i = 0; i < HD / 8; ++i) {
              const float sx = odd ? gq[4 * i] : gq[4 * i + 2];
              const float sy = odd ? gq[4 * i + 1] : gq[4 * i + 3];
              const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
              const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
              red_add_v4_if(dst + 8 * i, odd ? rx : gq[4 * i], odd ? ry : gq[4 * i + 1],
                            odd ? gq[4 * i + 2] : rx, odd ? gq[4 * i + 3] : ry, RED);
            }
          }
          if (++j == nq) j = 0;
          if (++s == STAGES) { s = 0; ph ^= 1; }
        };
        for (int n = 0; n < nq; n += 2) {
          tile(std::integral_constant<int, 0>{});
          if (n + 1 < nq) tile(std::integral_constant<int, 1>{});
        }
        // the item's last dQ is done with its buffer (with an odd count of
        // tiles, the buffer the next item's first tile writes) and with K
        if constexpr (DQ) bar_sync(1, 256);
        mbar_arrive_if(empty_kv, leader);
        const size_t at = ((size_t)b * L + k0) * D + h * HD + 2 * quad;
        store_rows<HD>(dk + at, gk, r0, D, active);
        store_rows<HD>(dv + at, gv, r0, D, active);
      }
    };
    if (!DQ || cw == 0) consume(std::integral_constant<int, 0>{});
    else consume(std::integral_constant<int, 1>{});
  }
}

// ---------------------------------------------------------------- query-tile kernel

constexpr int DQ_ROWS = 128;  // queries per work item: 64 per consumer warpgroup

template <int HD>
struct DqCfg {
  static constexpr int BK = HD == 128 ? 64 : 128;  // keys per streamed tile
  static constexpr int Q_BYTES = DQ_ROWS * HD * 2;  // the Q or the dO tile
  static constexpr int KV_BYTES = BK * HD * 2;      // a K or a V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K, then V
  static constexpr int BAR_OFFSET = 2 * Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int NBARS = 2 + 2 * STAGES;
  static constexpr int SMEM = BAR_OFFSET + NBARS * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int L, int D, int H, int nq, int items,
                    float scale, float scale_log2) {
  using C = DqCfg<HD>;
  using T = HeadTile<HD>;
  constexpr int ROW = T::ROW, BOX = T::BOX, BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + C::Q_BYTES;
  const uint32_t sK = base + 2 * C::Q_BYTES;  // stage s at + s * STAGE_BYTES, V at + KV_BYTES
  const uint32_t bars = base + C::BAR_OFFSET;
  const uint32_t full_q = bars, empty_q = bars + 8;
  const uint32_t full = bars + 16, empty = full + 8 * STAGES;  // stage s at + 8 * s
  const int nk = (L + BK - 1) / BK;  // key tiles per item

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 8);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

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
        mbar_expect_tx(full_q, 2 * C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < T::NBOX; ++c) {
          tma_load_3d(sQ + c * DQ_ROWS * ROW, &tm_q, full_q, h * HD + c * BOX, qt * DQ_ROWS, b);
          tma_load_3d(sdO + c * DQ_ROWS * ROW, &tm_do, full_q, h * HD + c * BOX,
                      qt * DQ_ROWS, b);
        }
        for (int j = 0; j < nk; ++j) {
          const uint32_t k_s = sK + s * C::STAGE_BYTES;
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, C::STAGE_BYTES);
#pragma unroll
          for (int c = 0; c < T::NBOX; ++c) {
            tma_load_3d(k_s + c * BK * ROW, &tm_k, full + 8 * s, h * HD + c * BOX, j * BK, b);
            tma_load_3d(k_s + C::KV_BYTES + c * BK * ROW, &tm_v, full + 8 * s,
                        h * HD + c * BOX, j * BK, b);
          }
          if (++s == STAGES) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int cw = wg - 1;  // this warpgroup's 64 queries of the 128-query tile
    const int t = threadIdx.x % 128, lane = t % 32, quad = lane & 3;
    // this thread's two fragment rows within the warpgroup's 64
    const int r0 = (t / 32) * 16 + lane / 4, r1 = r0 + 8;
    // K-major: the warpgroup's rows of Q and dO (A of S and dP), stage 0's
    // K and V (their B); MN-major: stage 0's K as the B of dQ
    const uint64_t dq_a = make_desc(sQ + cw * 64 * ROW, 16, 8 * ROW, T::LAYOUT);
    const uint64_t ddo_a = make_desc(sdO + cw * 64 * ROW, 16, 8 * ROW, T::LAYOUT);
    const uint64_t dk_b = make_desc(sK, 16, 8 * ROW, T::LAYOUT);
    const uint64_t dv_b = make_desc(sK + C::KV_BYTES, 16, 8 * ROW, T::LAYOUT);
    const uint64_t dk_mn = make_desc(sK, BK * ROW, 8 * ROW, T::LAYOUT);
    constexpr uint64_t STAGE = C::STAGE_BYTES >> 4;  // a stage's step in the descriptor
    const bool leader = lane == 0;  // arrives on the empty barriers for its warp
    int s = 0;
    uint32_t ph = 0, qph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, qph ^= 1) {
      const int qt = item % nq, h = (item / nq) % H, b = item / (nq * H);
      const int q0 = qt * DQ_ROWS + cw * 64;  // the warpgroup's first query
      // past L (L % 128 == 64) the warpgroup's Q and dO rows are TMA's zero
      // fill: it runs the same code (no branch), with lse and delta 0 there,
      // and stores nothing
      const bool active = q0 < L;
      const size_t row_base = ((size_t)b * H + h) * L;
      const int qa = min(q0 + r0, L - 1), qb = min(q0 + r1, L - 1);  // in range
      const float xa = lse[row_base + qa], xb = lse[row_base + qb];
      const float ya = delta[row_base + qa], yb = delta[row_base + qb];
      const float la = active ? xa * LOG2E : 0.0f, lb = active ? xb * LOG2E : 0.0f;
      const float da = active ? ya : 0.0f, db = active ? yb : 0.0f;
      float acc[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
      mbar_wait(full_q, qph);
      for (int j = 0; j < nk; ++j) {
        // S = Q K^T and dP = dO V^T (64 queries x BK keys)
        float sc[BK / 2], dpc[BK / 2];
        mbar_wait(full + 8 * s, ph);
        wgmma_fence();
        issue_abt<HD, BK, DQ_ROWS, BK>(sc, dq_a, dk_b + s * STAGE);
        issue_abt<HD, BK, DQ_ROWS, BK>(dpc, ddo_a, dv_b + s * STAGE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dpc);

        // dS in the accumulator layout: sc[8kk + 2e] is query row r0 (e even)
        // or r1, keys 16kk + 8 (e / 2) + 2 quad + {0, 1}: register e of k-step kk
        uint32_t pds[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * kk + 2 * e;
            const float l = e % 2 ? lb : la, dl = e % 2 ? db : da;
            const float p0 = ex2(fmaf(sc[i], scale_log2, -l));
            const float p1 = ex2(fmaf(sc[i + 1], scale_log2, -l));
            pds[kk][e] = pack_bf16(p0 * (dpc[i] - dl) * scale, p1 * (dpc[i + 1] - dl) * scale);
          }

        // dQ += dS K over the tile's keys
        wgmma_fence();
        issue_pv<HD, BK / 16>(acc, pds, dk_mn + s * STAGE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive_if(empty + 8 * s, leader);
        mbar_arrive_if(empty_q, leader && j == nk - 1);
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }
      store_rows<HD>(dq + ((size_t)b * L + q0) * D + h * HD + 2 * quad, acc, r0, D, active);
    }
  }
}

// ---------------------------------------------------------------- float32

constexpr int BT = 64;  // the dq kernel's queries per block and keys per tile

// the float32 dq kernel's shared memory: Q dO K V rows of HD + 1 floats
template <int HD>
struct Geo {
  static constexpr int P32 = HD + 1;
  static constexpr size_t SMEM_DQ_F32 = 4 * BT * P32 * sizeof(float);
};

// the float32 key-tile kernel (tensor cores): F32_ROWS keys per CTA (four
// warps of 16 keys), QT-query tiles of Q, dO, lse and delta through two
// stages
template <int HD>
struct F32Kv {
  static constexpr int QT = HD >= 64 ? 32 : 64;  // queries per streamed tile
  static constexpr int P = HD + 4;  // row pitch in floats: conflict-free fragment loads
  static constexpr int QTILE = QT * P;           // floats of a Q or a dO tile
  static constexpr int STAGE = 2 * QTILE + 2 * QT;  // Q, dO, lse, delta
  static constexpr int PDS = F32_ROWS + 4;  // row pitch of dS [QT][PDS]
  // bytes: K and V of the CTA, two stages, and with DQ the tile's dS
  static constexpr int smem(bool dq) {
    return 4 * (2 * F32_ROWS * P + 2 * STAGE + (dq ? QT * PDS : 0));
  }
};

// float32 (DQ = false: the dkv kernel, the same code without the dQ step).
// Each warp owns 16 keys: per query tile it forms S^T = K Q^T and dP^T =
// V dO^T, then P^T and dS^T on the fragments, and dV += P^T dO, dK +=
// dS^T Q; with DQ the tile's dQ = dS K over the CTA's keys is added into the
// zeroed float32 dq by red.global.add.v4.f32.
template <int HD, bool DQ>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* dq, float* __restrict__ dk, float* __restrict__ dv, int L,
                     int D, float scale, float scale_log2) {
  using C = F32Kv<HD>;
  constexpr int QT = C::QT, P = C::P, PDS = C::PDS, KS = HD / 8, NT = QT / 8, HN = HD / 8;
  constexpr int NWARPS = F32_THREADS / 32;
  extern __shared__ __align__(16) float smem32[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int H = gridDim.y;
  const size_t head = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * HD;
  const size_t row_base = ((size_t)blockIdx.z * H + blockIdx.y) * L;
  const int k0 = blockIdx.x * F32_ROWS;
  float* sK = smem32;  // [F32_ROWS][P]
  float* sV = sK + F32_ROWS * P;
  float* ring = sV + F32_ROWS * P;  // stage s at + s * STAGE: Q, dO, lse, delta
  float* sDS = ring + 2 * C::STAGE;  // DQ: dS [QT][PDS], queries by keys
  const uint32_t sbase = smem_addr(smem32);
  const uint32_t sring = sbase + 2 * F32_ROWS * P * 4;
  const int nq = L / QT;
  // the query tile order starts at the key block's own tile, so the CTAs of
  // a head add into different dQ rows at once
  const int q_first = blockIdx.x % nq;
  auto load_tile = [&](int i) {  // the i-th query tile of this CTA's order
    const int qt = (q_first + i) % nq;
    const uint32_t dst = sring + (i & 1) * C::STAGE * 4;
    load_rows<HD, P, QT>(dst, q + head + (size_t)qt * QT * D, D);
    load_rows<HD, P, QT>(dst + C::QTILE * 4, dout + head + (size_t)qt * QT * D, D);
    load_vec<QT>(dst + 2 * C::QTILE * 4, lse + row_base + qt * QT);
    load_vec<QT>(dst + (2 * C::QTILE + QT) * 4, delta + row_base + qt * QT);
    cp_async_commit();
  };
  load_rows<HD, P, F32_ROWS>(sbase, k + head + (size_t)k0 * D, D);
  load_rows<HD, P, F32_ROWS>(sbase + F32_ROWS * P * 4, v + head + (size_t)k0 * D, D);
  load_tile(0);  // one group with K and V

  float gk[HN][4], gv[HN][4];  // dK, dV of the warp's 16 keys, n-tile = 8 head columns
#pragma unroll
  for (int n = 0; n < HN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.0f;
  const float* kw = sK + (warp * 16 + g) * P + t;  // A fragments: key rows g, g + 8
  const float* vw = sV + (warp * 16 + g) * P + t;

  for (int i = 0; i < nq; ++i) {
    if (i + 1 < nq) {
      load_tile(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sQ = ring + (i & 1) * C::STAGE;
    const float* sdO = sQ + C::QTILE;
    const float* sL = sdO + C::QTILE;
    const float* sDl = sL + QT;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x QT queries, n-tile j =
    // queries 8j..8j+7 (B: Q and dO rows)
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float ka[4] = {kw[8 * kk], kw[8 * P + 8 * kk], kw[8 * kk + 4], kw[8 * P + 8 * kk + 4]};
      const float va[4] = {vw[8 * kk], vw[8 * P + 8 * kk], vw[8 * kk + 4], vw[8 * P + 8 * kk + 4]};
      uint32_t kh[4], kl[4], vh[4], vl[4];
      split_tf32(ka, kh, kl);
      split_tf32(va, vh, vl);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* qr = sQ + (8 * j + g) * P + 8 * kk + t;
        const float* dr = sdO + (8 * j + g) * P + 8 * kk + t;
        mma3(st[j], kh, kl, qr[0], qr[4]);
        mma3(dpt[j], vh, vl, dr[0], dr[4]);
      }
    }

    // P^T = exp2(S^T scale log2(e) - lse log2(e)) and dS^T = P^T (dP^T -
    // delta) scale in place: c0, c2 are query 8j + 2t, c1, c3 query 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(sL + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(sDl + 8 * j + 2 * t);
      const float la = lv.x * LOG2E, lb = lv.y * LOG2E;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(st[j][e], scale_log2, e % 2 ? -lb : -la));
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - (e % 2 ? dl.y : dl.x)) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q: k-step j = queries 8j..8j+7 in the
    // order (2t, 2t + 1), so the n-tiles above are the A fragments as they
    // stand; B: dO and Q rows 8j + 2t, 8j + 2t + 1. Each n-tile's sum over
    // the tile's queries is formed in a fresh accumulator and added to dV,
    // dK in float32 (the tensor cores truncate as they accumulate: summed
    // over all of L in one accumulator, that bias crossed the 1e-5 bound)
    uint32_t ph[NT][4], pl[NT][4], dh[NT][4], dl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float pa[4] = {st[j][0], st[j][2], st[j][1], st[j][3]};
      const float da[4] = {dpt[j][0], dpt[j][2], dpt[j][1], dpt[j][3]};
      split_tf32(pa, ph[j], pl[j]);
      split_tf32(da, dh[j], dl[j]);
    }
#pragma unroll
    for (int n = 0; n < HN; ++n) {
      float tv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, tk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* dr = sdO + (8 * j + 2 * t) * P + 8 * n + g;
        const float* qr = sQ + (8 * j + 2 * t) * P + 8 * n + g;
        mma3(tv, ph[j], pl[j], dr[0], dr[P]);
        mma3(tk, dh[j], dl[j], qr[0], qr[P]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gv[n][e] += tv[e];
        gk[n][e] += tk[e];
      }
    }

    if constexpr (DQ) {
      // dS^T to shared memory as dS [query][key], then the tile's dQ = dS K
      // over the CTA's keys: units of (16 queries, half the head columns)
      // spread over the warps, each added by 16-byte reductions
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float* d0 = sDS + (8 * j + 2 * t) * PDS + warp * 16 + g;
        d0[0] = dpt[j][0];
        d0[PDS] = dpt[j][1];
        d0[8] = dpt[j][2];
        d0[PDS + 8] = dpt[j][3];
      }
      __syncthreads();
      const int qt = (q_first + i) % nq;
      constexpr int HALF = HN / 2 > 0 ? HN / 2 : 1;  // n-tiles per unit
      constexpr int UNITS = (QT / 16) * (HN / HALF);
      static_assert(UNITS % NWARPS == 0, "every warp takes as many units");
#pragma unroll
      for (int u0 = 0; u0 < UNITS; u0 += NWARPS) {
        const int u = u0 + warp, mt = u % (QT / 16), n0 = (u / (QT / 16)) * HALF;
        float acc[HALF][4];
#pragma unroll
        for (int n = 0; n < HALF; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
        const float* ar = sDS + (16 * mt + g) * PDS + t;
        for (int ks = 0; ks < F32_ROWS / 8; ++ks) {
          const float a[4] = {ar[8 * ks], ar[8 * PDS + 8 * ks], ar[8 * ks + 4],
                              ar[8 * PDS + 8 * ks + 4]};
          uint32_t ah[4], al[4];
          split_tf32(a, ah, al);
          const float* br = sK + (8 * ks + t) * P + 8 * n0 + g;  // B: K rows 8ks + t, + 4
#pragma unroll
          for (int n = 0; n < HALF; ++n) mma3(acc[n], ah, al, br[8 * n], br[4 * P + 8 * n]);
        }
        // one exchange in the quad: even t take row g, columns 2t..2t+3;
        // odd t row g + 8, columns 2t-2..2t+1
        const bool odd = t & 1;
        float* dst = dq + head + (size_t)(qt * QT + 16 * mt + g + (odd ? 8 : 0)) * D +
                     8 * n0 + 2 * (t & ~1);
#pragma unroll
        for (int n = 0; n < HALF; ++n) {
          const float s0 = odd ? acc[n][0] : acc[n][2], s1 = odd ? acc[n][1] : acc[n][3];
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          red_add_v4_if(dst + 8 * n, odd ? r0 : acc[n][0], odd ? r1 : acc[n][1],
                        odd ? acc[n][2] : r0, odd ? acc[n][3] : r1, RED);
        }
      }
    }
    __syncthreads();  // this stage (and dS) is free
  }

  // dK, dV C fragments: rows (keys) g, g + 8, columns 8n + 2t, + 1
  const size_t r0 = head + (size_t)(k0 + warp * 16 + g) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < HN; ++n) {
    *reinterpret_cast<float2*>(dk + r0 + 8 * n) = make_float2(gk[n][0], gk[n][1]);
    *reinterpret_cast<float2*>(dk + r0 + 8 * D + 8 * n) = make_float2(gk[n][2], gk[n][3]);
    *reinterpret_cast<float2*>(dv + r0 + 8 * n) = make_float2(gv[n][0], gv[n][1]);
    *reinterpret_cast<float2*>(dv + r0 + 8 * D + 8 * n) = make_float2(gv[n][2], gv[n][3]);
  }
}

// float32 dq: one thread per query of the block's 64-query tile
template <int HD>
__global__ void __launch_bounds__(BT)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int L, int D, float scale) {
  constexpr int P32 = Geo<HD>::P32;  // row pitch, one bank apart
  extern __shared__ __align__(16) float smem32[];
  float* sQ = smem32;
  float* sdO = sQ + BT * P32;
  float* sK = sdO + BT * P32;
  float* sV = sK + BT * P32;
  const int H = gridDim.y;
  const size_t base = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * HD;
  const size_t row_base = ((size_t)blockIdx.z * H + blockIdx.y) * L;
  const int q0 = blockIdx.x * BT;
  const int t = threadIdx.x;
  for (int i = t; i < BT * HD; i += BT) {
    int j = i / HD, c = i % HD;
    sQ[j * P32 + c] = q[base + (size_t)(q0 + j) * D + c];
    sdO[j * P32 + c] = dout[base + (size_t)(q0 + j) * D + c];
  }
  const float lse_t = lse[row_base + q0 + t], delta_t = delta[row_base + q0 + t];
  float gq[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) gq[c] = 0.0f;

  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();
    for (int i = t; i < BT * HD; i += BT) {
      int j = i / HD, c = i % HD;
      sK[j * P32 + c] = k[base + (size_t)(k0 + j) * D + c];
      sV[j * P32 + c] = v[base + (size_t)(k0 + j) * D + c];
    }
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        s += sQ[t * P32 + c] * sK[j * P32 + c];
        dp += sdO[t * P32 + c] * sV[j * P32 + c];
      }
      const float pr = expf(s * scale - lse_t);
      const float ds = pr * (dp - delta_t) * scale;
#pragma unroll
      for (int c = 0; c < HD; ++c) gq[c] += ds * sK[j * P32 + c];
    }
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) dq[base + (size_t)(q0 + t) * D + c] = gq[c];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the four tensor maps of q, k, v, dout: q and dout with boxes of q_rows
// rows, k and v of kv_rows
template <int HD>
bool make_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
               const void* dout, int B, int L, int D, int q_rows, int kv_rows) {
  return make_map<HD>(&maps[0], q, B, L, D, q_rows) &&
         make_map<HD>(&maps[1], k, B, L, D, kv_rows) &&
         make_map<HD>(&maps[2], v, B, L, D, kv_rows) &&
         make_map<HD>(&maps[3], dout, B, L, D, q_rows);
}

// the persistent grid over `items` work items; 0 where the SM count fails
inline int persistent_grid(long long items, cudaError_t* err) {
  int sms = 0;
  *err = sm_count(&sms);
  if (*err != cudaSuccess) return 0;
  return items < sms ? (int)items : sms;
}

// the fused kernel (DQ) or the dkv kernel (!DQ; dq unused)
template <int HD, bool DQ>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int B, int L, int D, int heads, float scale, int dtype, cudaStream_t st) {
  if (dtype == 0) {
    CUtensorMap maps[4];
    if (!make_maps<HD>(maps, q, k, v, dout, B, L, D, Q_ROWS, KV_ROWS))
      return (int)cudaErrorInvalidValue;
    const int nkt = (L + KV_ROWS - 1) / KV_ROWS;
    const long long items = (long long)nkt * heads * B;
    if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    const int grid = persistent_grid(items, &err);
    if (err != cudaSuccess) return (int)err;
    constexpr int smem = KvCfg<HD, DQ>::SMEM;
    err = allow_smem(flash_bwd_kv_kernel<HD, DQ>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_kv_kernel<HD, DQ><<<grid, THREADS, smem, st>>>(
        maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta,
        (float*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, L, D, heads, nkt, (int)items,
        scale, (float)((double)scale * 1.4426950408889634));
  } else if (dtype == 1) {
    constexpr int smem = F32Kv<HD>::smem(DQ);
    cudaError_t err = allow_smem(flash_bwd_f32_kernel<HD, DQ>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_f32_kernel<HD, DQ><<<dim3(L / F32_ROWS, heads, B), F32_THREADS, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq, (float*)dk, (float*)dv, L, D, scale,
        (float)((double)scale * 1.4426950408889634));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int L,
              int D, int heads, float scale, int dtype, cudaStream_t st) {
  if (dtype == 0) {
    CUtensorMap maps[4];
    if (!make_maps<HD>(maps, q, k, v, dout, B, L, D, DQ_ROWS, DqCfg<HD>::BK))
      return (int)cudaErrorInvalidValue;
    const int nq = (L + DQ_ROWS - 1) / DQ_ROWS;
    const long long items = (long long)nq * heads * B;
    if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    const int grid = persistent_grid(items, &err);
    if (err != cudaSuccess) return (int)err;
    constexpr int smem = DqCfg<HD>::SMEM;
    err = allow_smem(flash_bwd_dq_kernel<HD>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<HD><<<grid, THREADS, smem, st>>>(
        maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta,
        (__nv_bfloat16*)dq, L, D, heads, nq, (int)items, scale,
        (float)((double)scale * 1.4426950408889634));
  } else if (dtype == 1) {
    constexpr size_t smem = Geo<HD>::SMEM_DQ_F32;
    cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<HD>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_f32_kernel<HD><<<dim3(L / BT, heads, B), BT, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq, L, D, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// checks the shape and calls f with the head dim as a compile-time constant
template <typename F>
int by_head_dim(int B, int L, int D, int heads, F&& f) {
  if (B <= 0 || L <= 0 || L % BT != 0 || heads <= 0 || D % heads != 0 ||
      B > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  switch (D / heads) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. q, k, v, dout [B, L, D] contiguous,
// 16-byte aligned, in `dtype`; lse, delta [B, heads, L] float32. Each needs
// head_dim D / heads in {16, 32, 64, 128} and L a multiple of 64.
//
// The fused backward: dq a zeroed float32 [B, L, D] buffer the kernel adds
// into; dk, dv [B, L, D] in `dtype`.
extern "C" int flash_tokens_bwd(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dk,
                                void* dv, int B, int L, int D, int heads,
                                float scale, int dtype, void* stream) {
  return by_head_dim(B, L, D, heads, [&](auto hd) {
    return launch<decltype(hd)::value, true>(q, k, v, dout, lse, delta, dq, dk, dv, B, L,
                                             D, heads, scale, (int)dtype,
                                             (cudaStream_t)stream);
  });
}

// The split pair. dq [B, L, D] in `dtype`, written once.
extern "C" int flash_tokens_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int B, int L, int D, int heads,
                                   float scale, int dtype, void* stream) {
  return by_head_dim(B, L, D, heads, [&](auto hd) {
    return launch_dq<decltype(hd)::value>(q, k, v, dout, lse, delta, dq, B, L, D, heads,
                                          scale, dtype, (cudaStream_t)stream);
  });
}

// dk, dv [B, L, D] in `dtype`, written once.
extern "C" int flash_tokens_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int L, int D,
                                    int heads, float scale, int dtype, void* stream) {
  return by_head_dim(B, L, D, heads, [&](auto hd) {
    return launch<decltype(hd)::value, false>(q, k, v, dout, lse, delta, nullptr, dk, dv,
                                              B, L, D, heads, scale, dtype,
                                              (cudaStream_t)stream);
  });
}
