// Multi-head flash attention backward on token-major [B, L, D] tensors.
//
// Replaces: smokephysai_tpu/ops/pallas/attention.py, _flash_trainable_bwd
// with the fused kernel _flash_bwd_fused_kernel (the default backward of
// flash_attention_tokens_trainable). From q, k, v, dO, the forward's
// logsumexp lse [B, H, L] and delta = rowsum(dO * O) [B, H, L] (a plain
// PyTorch reduce before the launch, as it is an XLA reduce in JAX), per head:
//   S = q k^T * scale,  P = exp(S - lse),  dP = dO v^T,
//   dS = P * (dP - delta) * scale,
//   dV = P^T dO,  dK = dS^T q,  dQ = dS k,
// rounding where the TPU kernel rounds: P to v's type before P^T dO, dS to
// q's type before dS k and dS^T q, all products accumulated in float32.
//
// What bounds it on an H100: operations. At the training shape (B=8,
// L=1024, D=512, 8 heads) the five products are 10*B*H*L^2*64 = 43 GFLOP
// on ~50 MB in and out, ~860 FLOP per byte, above the ~295 FLOP/byte
// ridge: 0.043 ms at 989 TFLOP/s bf16.
//
// Design: the TPU kernel walks q-blocks in sequence and keeps per-(batch,
// head) f32 dk/dv accumulators resident across those grid steps; CUDA
// blocks run in no order, so here one block owns one (64-key tile, head,
// batch): its dK and dV live in registers (WMMA accumulator fragments,
// float32) while the block loops over all 64-query tiles, recomputing S
// and dP once per tile as the fused TPU kernel does (five products, not the
// split kernels' seven). dQ for a query tile needs every key tile, so each
// block adds its share dS k into a float32 [B, L, D] buffer with atomicAdd
// (the wrapper zeroes it and casts it to q's type): one launch and no
// second pass that would recompute S and dP again, at the price of a sum
// whose order varies from run to run. Q, K, V and dO are read in place
// from [B, L, D] at the head's column offset (head h = columns
// [h*hd, (h+1)*hd)), so no head-major transposes surround the call.
// bf16: 4 warps, each owning 16 keys of the tile; S^T and dP^T tiles go
// through shared memory for the elementwise step, P^T and dS^T are kept in
// shared memory as bf16 for the three products that read them. float32
// (for checking the algorithm at full precision): a scalar kernel, one
// thread per key. wgmma and TMA are not used yet.
//
// Head dim: a template parameter, instantiated for 16, 32, 64 and 128 (the
// launcher picks it from D / heads). The tiles' row pitch, the shared
// memory, the dK/dV fragments and the WMMA loops over the head dim scale
// with it; the 64-key and 64-query tiles do not. At head_dim 64 the code
// computes what it did when 64 was built in. Shared memory per block, bf16:
// 4 * 64 * (hd + 8) * 2 + 2 * 64 * 4 + 8 * 16 * L4 * 4 + 2 * 64 * 72 * 2 +
// 64 * L4 * 4 bytes with L4 = max(64, hd) + 4 (106 KB at 64, 186 KB at 128);
// float32: (4 * 64 * (hd + 1) + 64 * 65) * 4 (81 KB at 64, 145 KB at 128).
//
// The split pair (the JAX package's SMOKEPHYS_FUSED_BWD=0 route:
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel, both on token-major
// [B, L, D] with the heads looped inside, grid (batch, q-block)) is two
// kernels with no atomics, so its gradients are the same bits on every run
// and each batch element's are those of a call on it alone:
// - dq: one block per (64-query tile, head, batch). Each warp keeps its 16
//   query rows of Q and dO as WMMA A fragments, loops over all 64-key
//   tiles, recomputes S = Q K^T and dP = dO V^T, forms dS (to q's type) and
//   accumulates dQ += dS K in float32 fragments; it writes dq once, in q's
//   type. Three products: 6*B*H*L^2*hd = 25.8 GFLOP at the training shape,
//   0.026 ms at 989 TFLOP/s (on ~42 MB, 0.013 ms at 3.35 TB/s).
// - dkv: the fused kernel above with its dQ step compiled out (template
//   flag DQ = false; the fused instantiation, DQ = true, is the code it
//   was). Four products: 8*B*H*L^2*hd = 34.4 GFLOP, 0.035 ms (~50 MB).
// Both are bound by operations, and both recompute S and dP: seven
// products against the fused kernel's five. What limits them as written is
// what limits the fused kernel: WMMA (mma.sync) rather than wgmma, S and
// dP staged through shared memory for the elementwise step, and 4 warps
// per block. Shared memory of the dq kernel per block, bf16:
// 4 * 64 * (hd + 8) * 2 + 2 * 64 * 4 + 8 * 16 * L4 * 4 + 64 * 72 * 2 bytes
// (81 KB at 64, 147 KB at 128); float32: 4 * 64 * (hd + 1) * 4 (67 KB at
// 64, 132 KB at 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BT = 64;       // keys per block and queries per tile
constexpr int WARPS = 4;     // bf16 kernel: 16 keys per warp
constexpr int LDP = BT + 8;  // bf16 P^T / dS^T row pitch
constexpr size_t VEC_BYTES = BT * sizeof(float);
constexpr size_t PT_BYTES = BT * LDP * sizeof(__nv_bfloat16);

// the tile geometry of head dim HD
template <int HD>
struct Geo {
  static constexpr int LDT = HD + 8;  // bf16 tile row pitch (elements)
  // float tile row pitch: S^T and dP^T (64 queries wide), dK, dV and dQ
  // (HD wide)
  static constexpr int LDS = (HD > BT ? HD : BT) + 4;
  static constexpr size_t TILE_BYTES = BT * LDT * sizeof(__nv_bfloat16);
  static constexpr size_t WS_BYTES = 16 * LDS * sizeof(float);  // one warp's f32 tile
  static constexpr size_t DQ_BYTES = BT * LDS * sizeof(float);
  // sK sV sQ sdO | lse delta | S^T dP^T per warp | P^T dS^T | dQ staging
  static constexpr size_t SMEM_BF16 = 4 * TILE_BYTES + 2 * VEC_BYTES +
                                      2 * WARPS * WS_BYTES + 2 * PT_BYTES + DQ_BYTES;
  // float32 kernel: K V Q dO rows of HD + 1 floats, dS rows of BT + 1
  static constexpr int P32 = HD + 1;
  static constexpr int PDS = BT + 1;
  static constexpr size_t SMEM_F32 = (4 * BT * P32 + BT * PDS) * sizeof(float);
  // the dkv kernels leave out their last region: dQ staging, float32 dS
  static constexpr size_t SMEM_DKV_BF16 = SMEM_BF16 - DQ_BYTES;
  static constexpr size_t SMEM_DKV_F32 = SMEM_F32 - BT * PDS * sizeof(float);
  // dq kernel: sQ sdO sK sV | lse delta | S dP per warp | dS
  static constexpr size_t SMEM_DQ_BF16 =
      4 * TILE_BYTES + 2 * VEC_BYTES + 2 * WARPS * WS_BYTES + PT_BYTES;
  static constexpr size_t SMEM_DQ_F32 = 4 * BT * P32 * sizeof(float);
};

template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int D) {
  // 64 rows x HD bf16 in 16-byte chunks
  constexpr int CHUNKS = HD / 8;
  for (int i = threadIdx.x; i < BT * CHUNKS; i += blockDim.x) {
    int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    *reinterpret_cast<uint4*>(dst + r * Geo<HD>::LDT + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

// DQ = false: the dkv kernel (no dQ step, dq unused)
template <int HD, bool DQ>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* dq,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int L, int D,
                      float scale) {
  using G = Geo<HD>;
  constexpr int LDT = G::LDT, LDS = G::LDS;
  constexpr size_t TILE_BYTES = G::TILE_BYTES, WS_BYTES = G::WS_BYTES;
  constexpr int HALF = HD / 2;  // dK / dV columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(p); p += TILE_BYTES;
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(p); p += TILE_BYTES;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(p); p += TILE_BYTES;
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(p); p += TILE_BYTES;
  float* sLse = reinterpret_cast<float*>(p); p += VEC_BYTES;
  float* sDelta = reinterpret_cast<float*>(p); p += VEC_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sS = reinterpret_cast<float*>(p + warp * WS_BYTES);
  float* sDP = reinterpret_cast<float*>(p + (WARPS + warp) * WS_BYTES);
  p += 2 * WARPS * WS_BYTES;
  __nv_bfloat16* sPt = reinterpret_cast<__nv_bfloat16*>(p); p += PT_BYTES;
  __nv_bfloat16* sdSt = reinterpret_cast<__nv_bfloat16*>(p); p += PT_BYTES;
  float* sDQ = reinterpret_cast<float*>(p);

  const int H = gridDim.y;
  const size_t base = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * HD;
  const size_t row_base = ((size_t)blockIdx.z * H + blockIdx.y) * L;
  const int k0 = blockIdx.x * BT;
  load_tile<HD>(sK, k + base + (size_t)k0 * D, D);
  load_tile<HD>(sV, v + base + (size_t)k0 * D, D);

  // the warp's 16 keys: rows w*16.. of the K and V tiles, as A fragments
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fk[HD / 16], fv[HD / 16];
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fat;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fbt;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc, fdk[HD / 16], fdv[HD / 16];
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::load_matrix_sync(fk[kk], sK + warp * 16 * LDT + kk * 16, LDT);
    wmma::load_matrix_sync(fv[kk], sV + warp * 16 * LDT + kk * 16, LDT);
    wmma::fill_fragment(fdk[kk], 0.0f);
    wmma::fill_fragment(fdv[kk], 0.0f);
  }

  // lane owns key row r of the warp's 16 and query columns [half*32, +32)
  const int r = lane >> 1, half = lane & 1;
  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<HD>(sQ, q + base + (size_t)q0 * D, D);
    load_tile<HD>(sdO, dout + base + (size_t)q0 * D, D);
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      sLse[i] = lse[row_base + q0 + i];
      sDelta[i] = delta[row_base + q0 + i];
    }
    __syncthreads();

    // S^T = K_w Q^T and dP^T = V_w dO^T (16 keys x 64 queries)
#pragma unroll
    for (int nt = 0; nt < BT / 16; ++nt) {
      wmma::fill_fragment(fc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::load_matrix_sync(fbt, sQ + nt * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(fc, fk[kk], fbt, fc);
      }
      wmma::store_matrix_sync(sS + nt * 16, fc, LDS, wmma::mem_row_major);
      wmma::fill_fragment(fc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::load_matrix_sync(fbt, sdO + nt * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(fc, fv[kk], fbt, fc);
      }
      wmma::store_matrix_sync(sDP + nt * 16, fc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // P = exp(S * scale - lse), dS = P (dP - delta) scale, both to bf16
    {
      const float* srow = sS + r * LDS + half * 32;
      const float* dprow = sDP + r * LDS + half * 32;
      __nv_bfloat16* prow = sPt + (warp * 16 + r) * LDP + half * 32;
      __nv_bfloat16* dsrow = sdSt + (warp * 16 + r) * LDP + half * 32;
#pragma unroll
      for (int c = 0; c < 32; c += 2) {
        const int j = half * 32 + c;
        float s0 = srow[c] * scale, s1 = srow[c + 1] * scale;
        float p0 = expf(s0 - sLse[j]), p1 = expf(s1 - sLse[j + 1]);
        float ds0 = p0 * (dprow[c] - sDelta[j]) * scale;
        float ds1 = p1 * (dprow[c + 1] - sDelta[j + 1]) * scale;
        *reinterpret_cast<__nv_bfloat162*>(prow + c) = __floats2bfloat162_rn(p0, p1);
        *reinterpret_cast<__nv_bfloat162*>(dsrow + c) = __floats2bfloat162_rn(ds0, ds1);
      }
    }
    __syncwarp();

    // dV_w += P^T_w dO and dK_w += dS^T_w Q (16 keys x HD dims)
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < HD / 16; ++nt) {
        wmma::load_matrix_sync(fa, sPt + warp * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, sdO + kk * 16 * LDT + nt * 16, LDT);
        wmma::mma_sync(fdv[nt], fa, fb, fdv[nt]);
        wmma::load_matrix_sync(fa, sdSt + warp * 16 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, sQ + kk * 16 * LDT + nt * 16, LDT);
        wmma::mma_sync(fdk[nt], fa, fb, fdk[nt]);
      }
    }
    if constexpr (DQ) {
      __syncthreads();  // dS^T of all four warps is in shared memory

      // dQ rows w*16.. of this query tile = dS (16 x 64 keys) K (64 x HD),
      // with dS read as the transpose of dS^T
#pragma unroll
      for (int nt = 0; nt < HD / 16; ++nt) {
        wmma::fill_fragment(fc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
          wmma::load_matrix_sync(fat, sdSt + kk * 16 * LDP + warp * 16, LDP);
          wmma::load_matrix_sync(fb, sK + kk * 16 * LDT + nt * 16, LDT);
          wmma::mma_sync(fc, fat, fb, fc);
        }
        wmma::store_matrix_sync(sDQ + warp * 16 * LDS + nt * 16, fc, LDS,
                                wmma::mem_row_major);
      }
      __syncwarp();
      float* dq_rows = dq + base + (size_t)(q0 + warp * 16) * D;
      for (int i = lane; i < 16 * HD; i += 32) {
        const int rr = i / HD, cc = i % HD;
        atomicAdd(dq_rows + (size_t)rr * D + cc, sDQ[(warp * 16 + rr) * LDS + cc]);
      }
    }
  }

  // dK and dV of the warp's 16 keys, through its f32 tile, cast to bf16
  __nv_bfloat16* outs[2] = {dk, dv};
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < HD / 16; ++nt)
      wmma::store_matrix_sync(sS + nt * 16, which == 0 ? fdk[nt] : fdv[nt],
                              LDS, wmma::mem_row_major);
    __syncwarp();
    __nv_bfloat16* dst = outs[which] + base + (size_t)(k0 + warp * 16 + r) * D + half * HALF;
    const float* src = sS + r * LDS + half * HALF;
#pragma unroll
    for (int c = 0; c < HALF; c += 8) {
      uint4 packed;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        p2[t] = __floats2bfloat162_rn(src[c + 2 * t], src[c + 2 * t + 1]);
      *reinterpret_cast<uint4*>(dst + c) = packed;
    }
  }
}

// float32: one thread per key of the block's 64-key tile (DQ = false: the
// dkv kernel)
template <int HD, bool DQ>
__global__ void __launch_bounds__(BT)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* dq,
                     float* __restrict__ dk, float* __restrict__ dv, int L,
                     int D, float scale) {
  constexpr int P32 = Geo<HD>::P32;  // row pitch, one bank apart
  constexpr int PDS = Geo<HD>::PDS;  // dS row pitch
  extern __shared__ __align__(16) float smem32[];
  float* sK = smem32;
  float* sV = sK + BT * P32;
  float* sQ = sV + BT * P32;
  float* sdO = sQ + BT * P32;
  float* sDS = sdO + BT * P32;  // [query][key]
  const int H = gridDim.y;
  const size_t base = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * HD;
  const size_t row_base = ((size_t)blockIdx.z * H + blockIdx.y) * L;
  const int k0 = blockIdx.x * BT;
  const int t = threadIdx.x;
  for (int i = t; i < BT * HD; i += BT) {
    int j = i / HD, c = i % HD;
    sK[j * P32 + c] = k[base + (size_t)(k0 + j) * D + c];
    sV[j * P32 + c] = v[base + (size_t)(k0 + j) * D + c];
  }
  float gk[HD], gv[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) gk[c] = gv[c] = 0.0f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();
    for (int i = t; i < BT * HD; i += BT) {
      int j = i / HD, c = i % HD;
      sQ[j * P32 + c] = q[base + (size_t)(q0 + j) * D + c];
      sdO[j * P32 + c] = dout[base + (size_t)(q0 + j) * D + c];
    }
    __syncthreads();
    for (int i = 0; i < BT; ++i) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        s += sQ[i * P32 + c] * sK[t * P32 + c];
        dp += sdO[i * P32 + c] * sV[t * P32 + c];
      }
      const float pr = expf(s * scale - lse[row_base + q0 + i]);
      const float ds = pr * (dp - delta[row_base + q0 + i]) * scale;
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        gv[c] += pr * sdO[i * P32 + c];
        gk[c] += ds * sQ[i * P32 + c];
      }
      if constexpr (DQ) sDS[i * PDS + t] = ds;
    }
    if constexpr (DQ) {
      __syncthreads();
      // thread t as query row t: its share of dQ from this key tile
      for (int c = 0; c < HD; ++c) {
        float acc = 0.0f;
        for (int j = 0; j < BT; ++j) acc += sDS[t * PDS + j] * sK[j * P32 + c];
        atomicAdd(dq + base + (size_t)(q0 + t) * D + c, acc);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    dk[base + (size_t)(k0 + t) * D + c] = gk[c];
    dv[base + (size_t)(k0 + t) * D + c] = gv[c];
  }
}

// dq: one block per (64-query tile, head, batch); each warp owns 16 query
// rows and keeps their Q and dO as A fragments and their dQ in float32
// accumulator fragments across all key tiles
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int L, int D,
                         float scale) {
  using G = Geo<HD>;
  constexpr int LDT = G::LDT, LDS = G::LDS;
  constexpr size_t TILE_BYTES = G::TILE_BYTES, WS_BYTES = G::WS_BYTES;
  constexpr int HALF = HD / 2;  // dQ columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(p); p += TILE_BYTES;
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(p); p += TILE_BYTES;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(p); p += TILE_BYTES;
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(p); p += TILE_BYTES;
  float* sLse = reinterpret_cast<float*>(p); p += VEC_BYTES;
  float* sDelta = reinterpret_cast<float*>(p); p += VEC_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sS = reinterpret_cast<float*>(p + warp * WS_BYTES);
  float* sDP = reinterpret_cast<float*>(p + (WARPS + warp) * WS_BYTES);
  p += 2 * WARPS * WS_BYTES;
  __nv_bfloat16* sdS = reinterpret_cast<__nv_bfloat16*>(p) + warp * 16 * LDP;

  const int H = gridDim.y;
  const size_t base = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * HD;
  const size_t row_base = ((size_t)blockIdx.z * H + blockIdx.y) * L;
  const int q0 = blockIdx.x * BT;
  load_tile<HD>(sQ, q + base + (size_t)q0 * D, D);
  load_tile<HD>(sdO, dout + base + (size_t)q0 * D, D);
  for (int i = threadIdx.x; i < BT; i += blockDim.x) {
    sLse[i] = lse[row_base + q0 + i];
    sDelta[i] = delta[row_base + q0 + i];
  }

  // the warp's 16 queries: rows w*16.. of the Q and dO tiles
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fq[HD / 16], fdo[HD / 16];
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fbt;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc, fdq[HD / 16];
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::load_matrix_sync(fq[kk], sQ + warp * 16 * LDT + kk * 16, LDT);
    wmma::load_matrix_sync(fdo[kk], sdO + warp * 16 * LDT + kk * 16, LDT);
    wmma::fill_fragment(fdq[kk], 0.0f);
  }

  // lane owns query row r of the warp's 16 and key columns [half*32, +32)
  const int r = lane >> 1, half = lane & 1;
  const float lse_r = sLse[warp * 16 + r], delta_r = sDelta[warp * 16 + r];
  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // every warp is done with the previous key tile
    load_tile<HD>(sK, k + base + (size_t)k0 * D, D);
    load_tile<HD>(sV, v + base + (size_t)k0 * D, D);
    __syncthreads();

    // S = Q_w K^T and dP = dO_w V^T (16 queries x 64 keys)
#pragma unroll
    for (int nt = 0; nt < BT / 16; ++nt) {
      wmma::fill_fragment(fc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::load_matrix_sync(fbt, sK + nt * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(fc, fq[kk], fbt, fc);
      }
      wmma::store_matrix_sync(sS + nt * 16, fc, LDS, wmma::mem_row_major);
      wmma::fill_fragment(fc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::load_matrix_sync(fbt, sV + nt * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(fc, fdo[kk], fbt, fc);
      }
      wmma::store_matrix_sync(sDP + nt * 16, fc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // P = exp(S * scale - lse), dS = P (dP - delta) scale, to bf16
    {
      const float* srow = sS + r * LDS + half * 32;
      const float* dprow = sDP + r * LDS + half * 32;
      __nv_bfloat16* dsrow = sdS + r * LDP + half * 32;
#pragma unroll
      for (int c = 0; c < 32; c += 2) {
        float p0 = expf(srow[c] * scale - lse_r);
        float p1 = expf(srow[c + 1] * scale - lse_r);
        float ds0 = p0 * (dprow[c] - delta_r) * scale;
        float ds1 = p1 * (dprow[c + 1] - delta_r) * scale;
        *reinterpret_cast<__nv_bfloat162*>(dsrow + c) = __floats2bfloat162_rn(ds0, ds1);
      }
    }
    __syncwarp();

    // dQ_w += dS_w K (16 queries x HD dims)
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wmma::load_matrix_sync(fa, sdS + kk * 16, LDP);
#pragma unroll
      for (int nt = 0; nt < HD / 16; ++nt) {
        wmma::load_matrix_sync(fb, sK + kk * 16 * LDT + nt * 16, LDT);
        wmma::mma_sync(fdq[nt], fa, fb, fdq[nt]);
      }
    }
  }

  // dQ of the warp's 16 queries, through its f32 tile, cast to bf16
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < HD / 16; ++nt)
    wmma::store_matrix_sync(sS + nt * 16, fdq[nt], LDS, wmma::mem_row_major);
  __syncwarp();
  __nv_bfloat16* dst = dq + base + (size_t)(q0 + warp * 16 + r) * D + half * HALF;
  const float* src = sS + r * LDS + half * HALF;
#pragma unroll
  for (int c = 0; c < HALF; c += 8) {
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      p2[t] = __floats2bfloat162_rn(src[c + 2 * t], src[c + 2 * t + 1]);
    *reinterpret_cast<uint4*>(dst + c) = packed;
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

// the fused kernel (DQ) or the dkv kernel (!DQ; dq unused)
template <int HD, bool DQ>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int B, int L, int D, int heads, float scale, int dtype,
           cudaStream_t st) {
  dim3 grid(L / BT, heads, B);
  if (dtype == 0) {
    constexpr size_t smem = DQ ? Geo<HD>::SMEM_BF16 : Geo<HD>::SMEM_DKV_BF16;
    cudaError_t err = allow_smem(flash_bwd_bf16_kernel<HD, DQ>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_bf16_kernel<HD, DQ><<<grid, WARPS * 32, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
        (const float*)lse, (const float*)delta, (float*)dq,
        (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, L, D, scale);
  } else if (dtype == 1) {
    constexpr size_t smem = DQ ? Geo<HD>::SMEM_F32 : Geo<HD>::SMEM_DKV_F32;
    cudaError_t err = allow_smem(flash_bwd_f32_kernel<HD, DQ>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_f32_kernel<HD, DQ><<<grid, BT, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq, (float*)dk, (float*)dv, L, D, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int L,
              int D, int heads, float scale, int dtype, cudaStream_t st) {
  dim3 grid(L / BT, heads, B);
  if (dtype == 0) {
    constexpr size_t smem = Geo<HD>::SMEM_DQ_BF16;
    cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<HD>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_bf16_kernel<HD><<<grid, WARPS * 32, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
        (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq, L, D,
        scale);
  } else if (dtype == 1) {
    constexpr size_t smem = Geo<HD>::SMEM_DQ_F32;
    cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<HD>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_f32_kernel<HD><<<grid, BT, smem, st>>>(
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
                                    int heads, float scale, int dtype,
                                    void* stream) {
  return by_head_dim(B, L, D, heads, [&](auto hd) {
    return launch<decltype(hd)::value, false>(q, k, v, dout, lse, delta, nullptr, dk, dv,
                                              B, L, D, heads, scale, dtype,
                                              (cudaStream_t)stream);
  });
}
