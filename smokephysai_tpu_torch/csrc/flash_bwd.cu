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
// [h*64, (h+1)*64)), so no head-major transposes surround the call.
// bf16: 4 warps, each owning 16 keys of the tile; S^T and dP^T tiles go
// through shared memory for the elementwise step, P^T and dS^T are kept in
// shared memory as bf16 for the three products that read them. float32
// (for checking the algorithm at full precision): a scalar kernel, one
// thread per key. wgmma and TMA are not used yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int HD = 64;       // head dim
constexpr int BT = 64;       // keys per block and queries per tile
constexpr int WARPS = 4;     // bf16 kernel: 16 keys per warp
constexpr int LDT = HD + 8;  // bf16 tile row pitch (elements)
constexpr int LDS = BT + 4;  // float tile row pitch
constexpr int LDP = BT + 8;  // bf16 P^T / dS^T row pitch

constexpr size_t TILE_BYTES = BT * LDT * sizeof(__nv_bfloat16);
constexpr size_t VEC_BYTES = BT * sizeof(float);
constexpr size_t WS_BYTES = 16 * LDS * sizeof(float);   // one warp's f32 tile
constexpr size_t PT_BYTES = BT * LDP * sizeof(__nv_bfloat16);
constexpr size_t DQ_BYTES = BT * LDS * sizeof(float);
// sK sV sQ sdO | lse delta | S^T dP^T per warp | P^T dS^T | dQ staging
constexpr size_t SMEM_BF16 = 4 * TILE_BYTES + 2 * VEC_BYTES +
                             2 * WARPS * WS_BYTES + 2 * PT_BYTES + DQ_BYTES;

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int D) {
  // 64 rows x 64 bf16 = 512 16-byte chunks
  for (int i = threadIdx.x; i < BT * HD / 8; i += blockDim.x) {
    int r = i >> 3, c = (i & 7) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDT + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

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
  load_tile(sK, k + base + (size_t)k0 * D, D);
  load_tile(sV, v + base + (size_t)k0 * D, D);

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
    load_tile(sQ, q + base + (size_t)q0 * D, D);
    load_tile(sdO, dout + base + (size_t)q0 * D, D);
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

    // dV_w += P^T_w dO and dK_w += dS^T_w Q (16 keys x 64 dims)
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
    __syncthreads();  // dS^T of all four warps is in shared memory

    // dQ rows w*16.. of this query tile = dS (16 x 64 keys) K (64 x 64),
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
    __nv_bfloat16* dst = outs[which] + base + (size_t)(k0 + warp * 16 + r) * D + half * 32;
    const float* src = sS + r * LDS + half * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      uint4 packed;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        p2[t] = __floats2bfloat162_rn(src[c + 2 * t], src[c + 2 * t + 1]);
      *reinterpret_cast<uint4*>(dst + c) = packed;
    }
  }
}

// float32: one thread per key of the block's 64-key tile
constexpr int P32 = HD + 1;  // row pitch, one bank apart
constexpr size_t SMEM_F32 = 5 * BT * P32 * sizeof(float);

__global__ void __launch_bounds__(BT)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* dq,
                     float* __restrict__ dk, float* __restrict__ dv, int L,
                     int D, float scale) {
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
      sDS[i * P32 + t] = ds;
    }
    __syncthreads();
    // thread t as query row t: its share of dQ from this key tile
    for (int c = 0; c < HD; ++c) {
      float acc = 0.0f;
      for (int j = 0; j < BT; ++j) acc += sDS[t * P32 + j] * sK[j * P32 + c];
      atomicAdd(dq + base + (size_t)(q0 + t) * D + c, acc);
    }
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    dk[base + (size_t)(k0 + t) * D + c] = gk[c];
    dv[base + (size_t)(k0 + t) * D + c] = gv[c];
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. q, k, v, dout [B, L, D] contiguous,
// 16-byte aligned, in `dtype`; lse, delta [B, heads, L] float32; dq a
// zeroed float32 [B, L, D] buffer the kernel adds into; dk, dv [B, L, D] in
// `dtype`. Needs head_dim 64 (D = 64 * heads) and L a multiple of 64.
extern "C" int flash_tokens_bwd(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dk,
                                void* dv, int B, int L, int D, int heads,
                                float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || L % BT != 0 || heads <= 0 || D != heads * HD ||
      B > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(L / BT, heads, B);
  if (dtype == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BF16);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_bf16_kernel<<<grid, WARPS * 32, SMEM_BF16, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
        (const float*)lse, (const float*)delta, (float*)dq,
        (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, L, D, scale);
  } else if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_f32_kernel<<<grid, BT, SMEM_F32, st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq, (float*)dk, (float*)dv, L, D, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
