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
// float32, flash_f32_kernel<HD, LSE> (the model paths that run in float32:
// SmokePhysNet3D under use_flash, the float32 2D train step, the PGD report
// under use_flash). Bound at [8,1024,512], 8 heads of 64: 17.2 GFLOP, 0.104
// ms at 165 TFLOP/s, the rate of float32-accurate products as three TF32
// products (csrc/tf32.cuh); a float32 FMA kernel tops out at 67 TFLOP/s.
// - Every product on the tensor cores in split TF32 (mma.sync m16n8k8, hi
//   and lo parts of each operand, small terms first): a single TF32 pass
//   keeps ~3 digits and breaks the 1e-5 bound; the split keeps ~2^-21.
// - mma.sync and not wgmma: TF32 wgmma takes only K-major operands from
//   shared memory, so V would need a transpose and K, V^T hi/lo copies in
//   shared memory; with mma.sync each fragment is split in registers. A
//   wgmma variant is the next step if this one sits far from its bound.
// - A CTA of four warps, 64 query rows (F32_ROWS, tf32.cuh), per (query
//   tile, head, batch); each warp owns 16 query rows. CTAs of 32 and 16
//   rows, which give every SM a CTA at [1,512,256], were slower on the card
//   at both measured shapes (PERF.md). Tiles of 64 keys (32 at
//   head_dim 128) of K and V stream through two stages of padded shared
//   memory (row pitch hd + 4 floats: conflict-free fragment loads) by
//   cp.async.cg 16-byte copies, the next tile's in flight while this one is
//   multiplied.
// - Q is split once into registers (at head_dim 128 it stays in shared
//   memory and is split per tile: 255 registers otherwise). S = Q K^T, then
//   the online softmax on the accumulator fragment (row max and sum across
//   the quad by shuffles, exp2 of one FMA with scale * log2(e) folded in).
//   S's C fragment of 8 keys is P's A fragment of the next product as it
//   stands, with the keys of the k-step taken in the order (2t, 2t + 1)
//   (tf32.cuh): no shuffle and no shared memory between the two products.
// - Each tile's P V is formed in a fresh accumulator and added to O in
//   float32 (O = O c + P V, one FMA): the tensor cores truncate as they
//   accumulate, and summed over L = 1024 keys in one accumulator that bias
//   reached 1.6e-5 of the output, past the 1e-5 bound. O is written once,
//   as acc / l; lse = m * ln 2 + log(l), as the bf16 kernel.
// - The lean and LSE instantiations are the same code with the lse store
//   compiled in: the same output bits. No atomics: the same bits every run.
//
// Head dim: a template parameter, instantiated for 16, 32, 64 and 128 (the
// launcher picks it from D / heads). Shared memory per CTA, bf16: Q 128*hd*2
// plus 2 * stages * 128*hd*2 for the ring (28 KB at 16, 56 KB at 32, 112 KB
// at 64, 160 KB at 128); float32: two stages of K and V, 4 * 64 * (hd + 4)
// * 4 (20 KB at 16, 36 KB at 32, 68 KB at 64), at 128 two stages of 32 keys
// and Q (99 KB).
//
// The Hopper primitives (mbarriers, TMA, wgmma descriptors and products,
// the tensor-map encoder) are in hopper.cuh, shared with flash_bwd.cu.
// FLASH_PROBE_NO_KV_LOADS and FLASH_PROBE_NO_EXP make measurement-only
// builds with wrong results (scripts/flash_probe.py): K and V loaded
// for the first tiles only, and the exponentials replaced by their input.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32.cuh"

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
  static constexpr int BOX = HeadTile<HD>::BOX;
  static constexpr int ROW = HeadTile<HD>::ROW;
  static constexpr int NBOX = HeadTile<HD>::NBOX;
  static constexpr uint64_t LAYOUT = HeadTile<HD>::LAYOUT;
  static constexpr int STAGES = HD == 128 ? 2 : 3;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int NBARS = 2 + 4 * STAGES;
  // + 1024: the dynamic shared memory is aligned up to the 128-byte
  // swizzle's 1024-byte period inside the kernel
  static constexpr int SMEM = BAR_OFFSET + NBARS * 8 + 1024;
};


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
      issue_abt<HD, BK, BQ, BK>(sc, dq, dk0 + s * STAGE);
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
        issue_abt<HD, BK, BQ, BK>(sc, dq, dk0 + s * STAGE);
        wgmma_commit();
        issue_pv<HD, BK / 16>(acc, pin, dv0 + sv * STAGE);
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
        issue_pv<HD, BK / 16>(acc, pin, dv0 + sv * STAGE);
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

// ---------------------------------------------------------------- float32 (tensor cores)

template <int HD>
struct F32Cfg {
  static constexpr int BK = HD == 128 ? 32 : 64;  // keys per K/V tile
  static constexpr int P = HD + 4;  // row pitch in floats: conflict-free fragment loads
  static constexpr int TILE = BK * P;  // floats of one K or V tile
  // Q split once into registers; at 128 read from shared memory and split
  // per tile, which keeps the kernel inside 255 registers
  static constexpr bool Q_SPLIT = HD <= 64;
  // bytes: Q at 128, then K and V in two stages
  static constexpr int SMEM = 4 * ((Q_SPLIT ? 0 : F32_ROWS * P) + 4 * TILE);
};

// One CTA of four warps per (query tile of F32_ROWS, head, batch); each warp
// owns 16 query rows, the thread rows r0 and r0 + 8 of the fragments.
template <int HD, bool LSE>
__global__ void __launch_bounds__(F32_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int L, int D, float scale_log2) {
  using C = F32Cfg<HD>;
  constexpr int BK = C::BK, P = C::P, KS = HD / 8, NT = BK / 8;
  extern __shared__ __align__(16) float smem32[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t head = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * HD;
  const int r0 = blockIdx.x * F32_ROWS + warp * 16 + g;
  const int nk = L / BK;
  const float* sQ = smem32;  // Q_SPLIT: unused
  float* ring = smem32 + (C::Q_SPLIT ? 0 : F32_ROWS * P);  // stage s at + 2 s TILE: K, V
  const uint32_t sring = smem_addr(ring);
  auto load_kv = [&](int j) {
    const uint32_t dst = sring + (j & 1) * 2 * C::TILE * 4;
    load_rows<HD, P, BK>(dst, k + head + (size_t)j * BK * D, D);
    load_rows<HD, P, BK>(dst + C::TILE * 4, v + head + (size_t)j * BK * D, D);
    cp_async_commit();
  };
  if constexpr (!C::Q_SPLIT)  // in the first group
    load_rows<HD, P, F32_ROWS>(smem_addr(smem32), q + head + (size_t)blockIdx.x * F32_ROWS * D,
                               D);
  load_kv(0);

  // Q's A fragment of k-step kk (head columns 8kk..8kk+7): split once, or
  // read from shared memory and split per tile
  uint32_t qh[C::Q_SPLIT ? KS : 1][4], ql[C::Q_SPLIT ? KS : 1][4];
  if constexpr (C::Q_SPLIT) {
    const float* q0 = q + head + (size_t)r0 * D;
    const float* q1 = q0 + (size_t)8 * D;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float qf[4] = {q0[8 * kk + t], q1[8 * kk + t], q0[8 * kk + t + 4],
                           q1[8 * kk + t + 4]};
      split_tf32(qf, qh[kk], ql[kk]);
    }
  }
  const float* qw = sQ + (warp * 16 + g) * P + t;

  float acc[HD / 8][4];  // O, n-tile n = head columns 8n..8n+7
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;  // m in log2 units

  for (int j = 0; j < nk; ++j) {
    // tile j + 1 loads while tile j is multiplied: its stage was freed by
    // the barrier that closed tile j - 1
    if (j + 1 < nk) {
      load_kv(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sK = ring + (j & 1) * 2 * C::TILE;
    const float* sV = sK + C::TILE;

    // S = Q K^T: n-tile i = keys 8i..8i+7 of the tile (B: K rows)
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (C::Q_SPLIT) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qh[kk][e];
          al[e] = ql[kk][e];
        }
      } else {
        const float qf[4] = {qw[8 * kk], qw[8 * P + 8 * kk], qw[8 * kk + 4],
                             qw[8 * P + 8 * kk + 4]};
        split_tf32(qf, ah, al);
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float* kr = sK + (8 * i + g) * P + 8 * kk + t;
        mma3(s[i], ah, al, kr[0], kr[4]);
      }
    }

    // the online softmax on the fragment: row max and sum across the quad,
    // exp2 with scale * log2(e) folded into one FMA
    float x0 = NEG_INF, x1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      x0 = fmaxf(x0, fmaxf(s[i][0], s[i][1]));
      x1 = fmaxf(x1, fmaxf(s[i][2], s[i][3]));
    }
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    const float n0 = fmaxf(m0, x0 * scale_log2), n1 = fmaxf(m1, x1 * scale_log2);
    const float c0 = ex2(m0 - n0), c1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      s[i][0] = ex2(fmaf(s[i][0], scale_log2, -n0));
      s[i][1] = ex2(fmaf(s[i][1], scale_log2, -n0));
      s[i][2] = ex2(fmaf(s[i][2], scale_log2, -n1));
      s[i][3] = ex2(fmaf(s[i][3], scale_log2, -n1));
      sum0 += s[i][0] + s[i][1];
      sum1 += s[i][2] + s[i][3];
    }
    l0 = l0 * c0 + sum0;  // summed across the quad once, at the end
    l1 = l1 * c1 + sum1;

    // O = O c + P V: the tile's P V in a fresh accumulator, added to O in
    // float32 (the tensor cores truncate as they accumulate: summed over all
    // of L in one accumulator, that bias crossed the 1e-5 bound at L = 1024).
    // k-step i = keys 8i..8i+7 in the order (2t, 2t + 1), so S's n-tile i is
    // P's A fragment as it stands; B: V rows 8i + 2t, 8i + 2t + 1
    float pv[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float pa[4] = {s[i][0], s[i][2], s[i][1], s[i][3]};
      uint32_t ph[4], pl[4];
      split_tf32(pa, ph, pl);
      const float* vr = sV + (8 * i + 2 * t) * P + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) mma3(pv[n], ph, pl, vr[8 * n], vr[P + 8 * n]);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] = fmaf(acc[n][0], c0, pv[n][0]);
      acc[n][1] = fmaf(acc[n][1], c0, pv[n][1]);
      acc[n][2] = fmaf(acc[n][2], c1, pv[n][2]);
      acc[n][3] = fmaf(acc[n][3], c1, pv[n][3]);
    }
    __syncthreads();  // every warp is done with this stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* o0 = o + head + (size_t)r0 * D + 2 * t;
  float* o1 = o0 + (size_t)8 * D;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(o0 + 8 * n) = make_float2(acc[n][0] / l0, acc[n][1] / l0);
    *reinterpret_cast<float2*>(o1 + 8 * n) = make_float2(acc[n][2] / l1, acc[n][3] / l1);
  }
  if (LSE && t == 0) {
    float* dst = lse + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * L;
    dst[r0] = m0 * LN2 + logf(l0);
    dst[r0 + 8] = m1 * LN2 + logf(l1);
  }
}

// ---------------------------------------------------------------- launchers

template <int HD, bool LSE>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int L, int heads, int D, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!make_map<HD>(&tq, q, B, L, D, BQ) || !make_map<HD>(&tk, k, B, L, D, BK) ||
      !make_map<HD>(&tv, v, B, L, D, BK))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
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
           int B, int L, int heads, int D, float scale, int dtype, cudaStream_t st) {
  if (dtype == 0) return launch_bf16<HD, LSE>(q, k, v, o, lse, B, L, heads, D, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  constexpr int smem = F32Cfg<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L / F32_ROWS, heads, B);
  flash_f32_kernel<HD, LSE><<<grid, F32_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, L, D,
      (float)((double)scale * 1.4426950408889634));
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
                                int heads, float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || L % 64 != 0 || heads <= 0 || D % heads != 0 ||
      B > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = D / heads;
  if (lse == nullptr)
    return launch_hd<false>(hd, q, k, v, o, nullptr, B, L, heads, D, scale, dtype, st);
  return launch_hd<true>(hd, q, k, v, o, (float*)lse, B, L, heads, D, scale, dtype, st);
}
