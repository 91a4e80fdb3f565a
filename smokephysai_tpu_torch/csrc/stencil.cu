// Explicit-Euler diffusion of up to three float32 fields in one launch: one
// elementwise pass each with a replicate-padded 5-point Laplacian.
//
// Replaces: smokephysai_tpu/ops/pallas/stencil.py, diffuse_pallas
// (_diffuse_kernel): out = f + coef * (up + down + left + right - 4 f), the
// edge rows and columns standing in for their missing neighbours, coef =
// dt * viscosity formed in float32 by the caller. The JAX per-op step calls
// diffuse_pallas three times (u, v, density); the port's step updates the
// three fields in one launch of this kernel, all from the same state.
//
// What bounds it on an H100: bytes, and at the solver's sizes latency. Each
// cell is read once (its four neighbours come from the same rows, which the
// L1 and L2 caches hold) and written once, 8 bytes per cell against 7
// operations. A step's three 256^2 fields are ~1.6 MB in and out, ~0.5 us
// at the HBM rate, so one launch's fixed cost, and the host's cost of
// issuing it, weigh more than its bandwidth.
//
// Design: a CTA per (field, block of ROWS rows over the field's episodes),
// the three fields' blocks one after another in one grid; a warp per row,
// along it, four consecutive cells a thread by 16-byte loads and stores
// where the row is 16-byte aligned (w a multiple of 4: density and u at
// w = 256), one cell a thread elsewhere (v at w + 1 = 257). One divide per
// row (its episode), none per cell; the replicate clamp is taken once per
// row for the rows above and below, and for the columns only at the row's
// two ends.
//
// Rounding: built with -fmad=false and summed in the plain version's order
// ((((up + down) + left) + right) - 4 f), so it matches
// ops/stencil.py:diffuse_reference to the bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;     // rows per CTA, one warp each
constexpr int ROWS = WARPS;
constexpr int MAX_FIELDS = 3;

struct Field {
  const float* f;
  float* out;
  long rows;        // episodes * h
  int h, w;
  float coef;
  int first_block;  // the field's first CTA in the grid
  int vec;          // 16-byte loads and stores
};

struct Fields {
  Field f[MAX_FIELDS];
};

__device__ __forceinline__ float cell(float c, float up, float down, float left, float right,
                                      float coef) {
  const float lap = up + down + left + right - 4.0f * c;
  return c + coef * lap;
}

__global__ void __launch_bounds__(WARPS * 32) diffuse_kernel(Fields fs, int nfields) {
  const int b = blockIdx.x;
  Field F = fs.f[0];
  if (nfields > 1 && b >= fs.f[1].first_block) F = fs.f[1];
  if (nfields > 2 && b >= fs.f[2].first_block) F = fs.f[2];
  const int lane = threadIdx.x & 31;
  const long g = (long)(b - F.first_block) * ROWS + (threadIdx.x >> 5);
  if (g >= F.rows) return;
  const int h = F.h, w = F.w;
  const long e = g / h;  // the row's episode
  const int i = (int)(g - e * h);
  const float* base = F.f + e * h * (long)w;
  const float* mid = base + (long)i * w;
  const float* up = i > 0 ? mid - w : mid;
  const float* down = i < h - 1 ? mid + w : mid;
  float* o = F.out + e * h * (long)w + (long)i * w;
  const float coef = F.coef;
  if (F.vec) {
    for (int j = 4 * lane; j < w; j += 128) {
      const float4 m = __ldg(reinterpret_cast<const float4*>(mid + j));
      const float4 a = __ldg(reinterpret_cast<const float4*>(up + j));
      const float4 d = __ldg(reinterpret_cast<const float4*>(down + j));
      const float left = j > 0 ? __ldg(mid + j - 1) : m.x;
      const float right = j + 4 < w ? __ldg(mid + j + 4) : m.w;
      float4 r;
      r.x = cell(m.x, a.x, d.x, left, m.y, coef);
      r.y = cell(m.y, a.y, d.y, m.x, m.z, coef);
      r.z = cell(m.z, a.z, d.z, m.y, m.w, coef);
      r.w = cell(m.w, a.w, d.w, m.z, right, coef);
      *reinterpret_cast<float4*>(o + j) = r;
    }
  } else {
    for (int j = lane; j < w; j += 32) {
      const float c = __ldg(mid + j);
      const float left = j > 0 ? __ldg(mid + j - 1) : c;
      const float right = j < w - 1 ? __ldg(mid + j + 1) : c;
      o[j] = cell(c, __ldg(up + j), __ldg(down + j), left, right, coef);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// One diffusion update of each of `nfields` (1 to 3) fields, field k being
// `episodes_k` planes of h_k x w_k laid out one after another, from f_k
// into out_k (distinct buffers) with coefficient coef_k, in one launch.
// The unused fields' arguments are ignored.
extern "C" int diffuse_launch(int nfields,
                              const void* f0, void* out0, long episodes0, int h0, int w0,
                              float coef0,
                              const void* f1, void* out1, long episodes1, int h1, int w1,
                              float coef1,
                              const void* f2, void* out2, long episodes2, int h2, int w2,
                              float coef2, void* stream) {
  if (nfields < 1 || nfields > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  const void* fs_in[MAX_FIELDS] = {f0, f1, f2};
  void* fs_out[MAX_FIELDS] = {out0, out1, out2};
  const long eps[MAX_FIELDS] = {episodes0, episodes1, episodes2};
  const int hs[MAX_FIELDS] = {h0, h1, h2}, ws[MAX_FIELDS] = {w0, w1, w2};
  const float coefs[MAX_FIELDS] = {coef0, coef1, coef2};
  Fields fs = {};
  long blocks = 0;
  for (int k = 0; k < nfields; ++k) {
    if (eps[k] <= 0 || hs[k] < 1 || ws[k] < 1) return (int)cudaErrorInvalidValue;
    Field& F = fs.f[k];
    F.f = (const float*)fs_in[k];
    F.out = (float*)fs_out[k];
    F.rows = eps[k] * hs[k];
    F.h = hs[k];
    F.w = ws[k];
    F.coef = coefs[k];
    F.first_block = (int)blocks;
    F.vec = ws[k] % 4 == 0 && aligned16(fs_in[k]) && aligned16(fs_out[k]);
    blocks += (F.rows + ROWS - 1) / ROWS;
    if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  }
  diffuse_kernel<<<(unsigned)blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(fs, nfields);
  return (int)cudaGetLastError();
}
