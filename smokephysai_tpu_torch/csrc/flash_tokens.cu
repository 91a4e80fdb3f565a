// Multi-head flash attention forward on token-major [B, L, D] tensors.
//
// Replaces: smokephysai_tpu/ops/pallas/attention.py, flash_attention_tokens
// (_flash_kernel_bld), the serving primal of flash_attention_tokens_trainable:
// out = softmax(q k^T * scale) v per head, where head h is the column slice
// [h*hd, (h+1)*hd) of D, P is cast to v's type before P.V with float32
// accumulation, and no logsumexp is kept. The LSE instantiation of the same
// kernels replaces _flash_tokens_fwd_lse (_flash_fwd_kernel_bld), the
// training forward: it also writes lse = m + log(l) per row and head,
// [B, H, L] float32, for the backward (csrc/flash_bwd.cu). The lean
// instantiation, which the serving path launches, writes no lse and is the
// same code as before the LSE variant existed.
//
// What bounds it on an H100: operations. At the serving shape (B=64,
// L=1024, D=512, 8 heads) it does 4*B*H*L^2*64 = 137 GFLOP on 268 MB of
// bf16 in and out, ~510 FLOP per byte, above the card's ~295 FLOP/byte
// ridge, so the tensor cores are the limit (0.14 ms at 989 TFLOP/s).
//
// Design: one block per (64-query tile, head, batch). Q, K and V are read in
// place from [B, L, D] at the head's column offset, so no transposes
// surround the call, as on the TPU. The block loops over 64-key tiles of K
// and V staged in shared memory and keeps an online softmax (running max
// and sum in float32). bf16: 4 warps, each owning 16 query rows; S = Q K^T
// and P V run on the tensor cores through WMMA (mma.sync, bf16 in, f32
// accumulate); each lane holds half a row of the output accumulator in
// registers. float32 (for checking the algorithm at full precision): a
// scalar FMA kernel, one thread per query row. wgmma and TMA are not used
// yet.
//
// Head dim: a template parameter, instantiated for 16, 32, 64 and 128 (the
// launcher picks it from D / heads). The tiles' row pitch, the shared memory
// and the WMMA loops over the head dim scale with it; the 64-query and
// 64-key tiles do not. At head_dim 64 the code computes what it did when 64
// was built in. Shared memory per block, bf16: 3 * 64 * (hd + 8) * 2 +
// 4 * (16 * (max(64, hd) + 4) * 4 + 16 * 72 * 2) bytes (53 KB at 64, 93 KB
// at 128); float32: 2 * 64 * hd * 4 (32 KB at 64, 64 KB at 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per tile
constexpr int WARPS = 4;    // bf16 kernel: 16 query rows per warp
constexpr int LDP = BK + 8; // bf16 probability row pitch
constexpr float NEG_INF = -1e30f;

// the tile geometry of head dim HD
template <int HD>
struct Geo {
  static constexpr int LDT = HD + 8;  // bf16 tile row pitch (elements), breaks bank conflicts
  // float row pitch of the score tile and of the P V tile staged in it
  static constexpr int LDS = (HD > BK ? HD : BK) + 4;
  static constexpr size_t TILE_BYTES = BQ * LDT * sizeof(__nv_bfloat16);
  static constexpr size_t S_BYTES = 16 * LDS * sizeof(float);
  static constexpr size_t P_BYTES = 16 * LDP * sizeof(__nv_bfloat16);
  static constexpr size_t SMEM_BF16 = 3 * TILE_BYTES + WARPS * (S_BYTES + P_BYTES);
  static constexpr size_t SMEM_F32 = 2 * BK * HD * sizeof(float);
};

template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int D) {
  // 64 rows x HD bf16 in 16-byte chunks (4 per thread at HD 64)
  constexpr int CHUNKS = HD / 8;
  for (int i = threadIdx.x; i < BQ * CHUNKS; i += blockDim.x) {
    int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    *reinterpret_cast<uint4*>(dst + r * Geo<HD>::LDT + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(WARPS * 32)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int L, int D, float scale) {
  using G = Geo<HD>;
  constexpr int LDT = G::LDT, LDS = G::LDS;
  constexpr size_t TILE_BYTES = G::TILE_BYTES, S_BYTES = G::S_BYTES, P_BYTES = G::P_BYTES;
  constexpr int HALF = HD / 2;  // output columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + TILE_BYTES);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + 2 * TILE_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sS = reinterpret_cast<float*>(smem + 3 * TILE_BYTES + warp * S_BYTES);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(
      smem + 3 * TILE_BYTES + WARPS * S_BYTES + warp * P_BYTES);

  const size_t base = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * HD;
  const int q0 = blockIdx.x * BQ;
  load_tile<HD>(sQ, q + base + (size_t)q0 * D, D);

  // lane owns row r of the warp's 16, keys [half*32, half*32+32) of a score
  // tile and output columns [half*HD/2, (half+1)*HD/2)
  const int r = lane >> 1, half = lane & 1;
  float acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.0f;
  float m = NEG_INF, l = 0.0f;

  // the warp's 16 query rows stay in registers as four A fragments
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fq[HD / 16];
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], sQ + warp * 16 * LDT + kk * 16, LDT);

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fkt;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD>(sK, k + base + (size_t)k0 * D, D);
    load_tile<HD>(sV, v + base + (size_t)k0 * D, D);
    __syncthreads();

    // S = Q_w K^T (16 x 64): K row-major read as a column-major K^T
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fill_fragment(fc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::load_matrix_sync(fkt, sK + nt * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(fc, fq[kk], fkt, fc);
      }
      wmma::store_matrix_sync(sS + nt * 16, fc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on the lane's half row; P = exp(S - m) cast to bf16
    const float* srow = sS + r * LDS + half * 32;
    float s[32];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      s[c] = srow[c] * scale;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.0f;
    __nv_bfloat16* prow = sP + r * LDP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      float p0 = expf(s[c] - m_new), p1 = expf(s[c + 1] - m_new);
      sum += p0;
      sum += p1;
      *reinterpret_cast<__nv_bfloat162*>(prow + c) = __floats2bfloat162_rn(p0, p1);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();

    // O_tile = P V (16 x HD), staged through the score buffer
#pragma unroll
    for (int nt = 0; nt < HD / 16; ++nt) {
      wmma::fill_fragment(fc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::load_matrix_sync(fa, sP + kk * 16, LDP);
        wmma::load_matrix_sync(fv, sV + kk * 16 * LDT + nt * 16, LDT);
        wmma::mma_sync(fc, fa, fv, fc);
      }
      wmma::store_matrix_sync(sS + nt * 16, fc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
    const float* orow = sS + r * LDS + half * HALF;
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] = acc[c] * corr + orow[c];
    __syncwarp();
  }

  __nv_bfloat16* dst = o + base + (size_t)(q0 + warp * 16 + r) * D + half * HALF;
#pragma unroll
  for (int c = 0; c < HALF; c += 8) {
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      p2[t] = __floats2bfloat162_rn(acc[c + 2 * t] / l, acc[c + 2 * t + 1] / l);
    *reinterpret_cast<uint4*>(dst + c) = packed;
  }
  if (LSE && half == 0)
    lse[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * L + q0 + warp * 16 + r] =
        m + logf(l);
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(BQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int L, int D, float scale) {
  // K and V tiles [BK][HD] each, dynamic: 64 KB at head_dim 128
  extern __shared__ __align__(16) float smem32[];
  float (*sK)[HD] = reinterpret_cast<float (*)[HD]>(smem32);
  float (*sV)[HD] = reinterpret_cast<float (*)[HD]>(smem32 + BK * HD);
  const size_t base = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * HD;
  const int row = blockIdx.x * BQ + threadIdx.x;
  float qr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = q[base + (size_t)row * D + c];
    acc[c] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;
  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * HD; i += blockDim.x) {
      int j = i / HD, c = i % HD;
      sK[j][c] = k[base + (size_t)(k0 + j) * D + c];
      sV[j][c] = v[base + (size_t)(k0 + j) * D + c];
    }
    __syncthreads();
    float s[BK];
    float mx = NEG_INF;
    for (int j = 0; j < BK; ++j) {
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
    for (int j = 0; j < BK; ++j) {
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

template <int HD, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int L, int heads, int D, float scale, int dtype,
           cudaStream_t st) {
  dim3 grid(L / BQ, heads, B);
  if (dtype == 0) {
    constexpr size_t smem = Geo<HD>::SMEM_BF16;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<HD, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bf16_kernel<HD, LSE><<<grid, WARPS * 32, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, L, D, scale);
  } else if (dtype == 1) {
    constexpr size_t smem = Geo<HD>::SMEM_F32;
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<HD, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32_kernel<HD, LSE><<<grid, BQ, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, L,
        D, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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
  if (B <= 0 || L <= 0 || L % BQ != 0 || heads <= 0 || D % heads != 0 ||
      B > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = D / heads;
  if (lse == nullptr)
    return launch_hd<false>(hd, q, k, v, o, nullptr, B, L, heads, D, scale, dtype, st);
  return launch_hd<true>(hd, q, k, v, o, (float*)lse, B, L, heads, D, scale, dtype, st);
}
