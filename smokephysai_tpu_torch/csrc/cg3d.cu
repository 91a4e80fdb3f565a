// Fixed-iteration matrix-free conjugate-gradient pressure solve of the 3D
// solver, batched over episodes.
//
// Replaces: smokephysai_tpu/ops/pallas/cg3d.py, cg_pressure_pallas
// (_cg_kernel): CG on A p = b with A = -Laplacian (7-point, zero outside the
// domain: _neg_lap_dirichlet) and b = -div, warm-started from p0:
//   r = b - A p0, d = r, rs = sum r^2; then num_iters times
//   Ad = A d, denom = sum d.Ad, alpha = denom > 0 ? rs / (denom + 1e-30) : 0,
//   p += alpha d, r -= alpha Ad, rs' = sum r^2,
//   beta = rs > 0 ? rs' / (rs + 1e-30) : 0, d = r + beta d, rs = rs'.
// Alpha and beta belong to each episode (the JAX package vmaps the solve).
//
// What bounds it on an H100: operations, barely, and in practice latency.
// One solve reads p0 and div and writes p, 12 bytes a cell (25 MB at 128^3,
// 7.5 us at 3.35 TB/s), and does ~18 float32 operations a cell and
// iteration (0.017 ms for 30 iterations at 128^3 at 67 TFLOP/s). Every
// iteration holds two reductions over the whole volume that each later
// stage needs, so the iterations cannot overlap.
//
// Design: a few launches per iteration, no cooperative launch. Each block
// owns CELLS consecutive cells of one episode (grid = blocks per episode x
// episodes) and writes its partial sum of a dot product to a scratch array;
// the next launch reduces the episode's partials again in every block, in
// one fixed order, so every block holds the same alpha and beta and two runs
// agree to the bit, with no floating-point atomics. An episode's blocks,
// partials and sums do not depend on the other episodes, so an episode
// solved in a batch equals its solve alone, bit for bit. Per iteration:
//   direction: beta from the rs partials, d = r + beta d_old (d = r in the
//     first iteration), formed again at each of the 7 stencil taps from r and
//     d_old (the same operations at every cell, so the same bits as the
//     stored d), Ad = A d, partials of d.Ad; d goes to the other half of a
//     ping-pong pair, as other blocks still read d_old;
//   update: alpha from the d.Ad and rs partials, p += alpha d,
//     r -= alpha Ad, partials of r.r.
// One solve is 1 + 2 num_iters launches on the stream (61 at 30 iterations),
// made by one host call. The volumes r, d (two), Ad live in scratch memory
// that the wrapper allocates; at 128^3 they and p take 42 MB, inside the
// 50 MB L2.
//
// Rounding: built with -fmad=false; the stencil adds in the plain version's
// order (((((z-1 + z+1) + y-1) + y+1) + x-1) + x+1) - 6 c, negated. The sums
// are taken in another order than torch.sum's, so the kernel matches its
// plain version to float32 rounding, not to the bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int CELLS = THREADS * PER_THREAD;  // cells per block
constexpr int WARPS = THREADS / 32;

struct Vol {
  int d, h, w;
  long n;  // d * h * w
};

// Sum of v over the block, the same value in every thread; `red` holds
// WARPS + 1 floats of shared memory. Fixed order: a butterfly in each warp
// (both partners add the same two numbers), then the warps' sums in order.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < WARPS; ++i) s += red[i];
    red[WARPS] = s;
  }
  __syncthreads();
  const float s = red[WARPS];
  __syncthreads();  // red may be reused
  return s;
}

// The episode's nb partial sums, reduced in one fixed order.
__device__ float sum_partials(const float* part, int nb, float* red) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < nb; i += THREADS) s += part[i];
  return block_sum(s, red);
}

// A x at cell i = (z, y, x) of one episode: -(sum of the six taps - 6 c), a
// tap beyond the domain being 0. `val(j)` gives x at flat index j.
template <typename F>
__device__ float neg_lap(F val, long i, Vol v, float c) {
  const int x = (int)(i % v.w);
  const long t = i / v.w;
  const int y = (int)(t % v.h);
  const int z = (int)(t / v.h);
  const long hw = (long)v.h * v.w;
  const float zm = z > 0 ? val(i - hw) : 0.0f;
  const float zp = z < v.d - 1 ? val(i + hw) : 0.0f;
  const float ym = y > 0 ? val(i - v.w) : 0.0f;
  const float yp = y < v.h - 1 ? val(i + v.w) : 0.0f;
  const float xm = x > 0 ? val(i - 1) : 0.0f;
  const float xp = x < v.w - 1 ? val(i + 1) : 0.0f;
  return -(((((zm + zp) + ym) + yp) + xm) + xp - 6.0f * c);
}

// r = -div - A p0, p = p0, partials of r.r
__global__ void __launch_bounds__(THREADS)
cg_init(const float* __restrict__ p0, const float* __restrict__ div,
        float* __restrict__ p, float* __restrict__ r,
        float* __restrict__ rs_part, Vol v, int nb) {
  __shared__ float red[WARPS + 1];
  const long base = (long)blockIdx.y * v.n;
  const float* pe = p0 + base;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const long i = (long)blockIdx.x * CELLS + j * THREADS + threadIdx.x;
    if (i < v.n) {
      const float c = pe[i];
      const float ap = neg_lap([&](long k) { return pe[k]; }, i, v, c);
      const float ri = -div[base + i] - ap;
      r[base + i] = ri;
      p[base + i] = c;
      acc += ri * ri;
    }
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) rs_part[(long)blockIdx.y * nb + blockIdx.x] = s;
}

// d = r + beta d_old (d = r when first), Ad = A d, partials of d.Ad
__global__ void __launch_bounds__(THREADS)
cg_direction(const float* __restrict__ r, const float* __restrict__ d_old,
             float* __restrict__ d_new, float* __restrict__ ad,
             const float* __restrict__ rs_new_part,
             const float* __restrict__ rs_old_part,
             float* __restrict__ dot_part, Vol v, int nb, int first) {
  __shared__ float red[WARPS + 1];
  const long base = (long)blockIdx.y * v.n;
  const long poff = (long)blockIdx.y * nb;
  float beta = 0.0f;
  if (!first) {
    const float rs_new = sum_partials(rs_new_part + poff, nb, red);
    const float rs_old = sum_partials(rs_old_part + poff, nb, red);
    beta = rs_old > 0.0f ? rs_new / (rs_old + 1e-30f) : 0.0f;
  }
  const float* re = r + base;
  const float* de = d_old + base;
  auto dval = [&](long k) { return first ? re[k] : re[k] + beta * de[k]; };
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const long i = (long)blockIdx.x * CELLS + j * THREADS + threadIdx.x;
    if (i < v.n) {
      const float c = dval(i);
      const float a = neg_lap(dval, i, v, c);
      d_new[base + i] = c;
      ad[base + i] = a;
      acc += c * a;
    }
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) dot_part[poff + blockIdx.x] = s;
}

// alpha from the d.Ad and r.r partials; p += alpha d, r -= alpha Ad,
// partials of the new r.r
__global__ void __launch_bounds__(THREADS)
cg_update(float* __restrict__ p, float* __restrict__ r,
          const float* __restrict__ d, const float* __restrict__ ad,
          const float* __restrict__ dot_part,
          const float* __restrict__ rs_part,
          float* __restrict__ rs_next_part, Vol v, int nb) {
  __shared__ float red[WARPS + 1];
  const long base = (long)blockIdx.y * v.n;
  const long poff = (long)blockIdx.y * nb;
  const float denom = sum_partials(dot_part + poff, nb, red);
  const float rs = sum_partials(rs_part + poff, nb, red);
  const float alpha = denom > 0.0f ? rs / (denom + 1e-30f) : 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const long i = (long)blockIdx.x * CELLS + j * THREADS + threadIdx.x;
    if (i < v.n) {
      const long g = base + i;
      p[g] = p[g] + alpha * d[g];
      const float ri = r[g] - alpha * ad[g];
      r[g] = ri;
      acc += ri * ri;
    }
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) rs_next_part[poff + blockIdx.x] = s;
}

}  // namespace

// Blocks per episode of a d x h x w volume: the length of each episode's
// row of partial sums in the scratch array of cg3d_launch.
extern "C" int cg3d_blocks(int d, int h, int w) {
  const long n = (long)d * h * w;
  return (int)((n + CELLS - 1) / CELLS);
}

// `iters` CG iterations on `episodes` volumes of d x h x w float32 laid out
// one after another: p0, div -> p. `vols` is scratch for four volume sets (r,
// the two halves of d, Ad), `partials` for 3 * episodes * cg3d_blocks(d, h,
// w) floats. p0 and div are only read.
extern "C" int cg3d_launch(const void* p0, const void* div, void* p, void* vols,
                           void* partials, long episodes, int d, int h, int w,
                           int iters, void* stream) {
  if (episodes <= 0 || episodes > 65535 || d < 1 || h < 1 || w < 1 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const Vol v{d, h, w, (long)d * h * w};
  const int nb = cg3d_blocks(d, h, w);
  const long set = episodes * v.n;
  float* r = (float*)vols;
  float* dbuf[2] = {r + set, r + 2 * set};
  float* ad = r + 3 * set;
  float* rs_part[2] = {(float*)partials, (float*)partials + episodes * nb};
  float* dot_part = (float*)partials + 2 * episodes * nb;
  const dim3 grid((unsigned)nb, (unsigned)episodes);
  cudaStream_t st = (cudaStream_t)stream;

  cg_init<<<grid, THREADS, 0, st>>>((const float*)p0, (const float*)div,
                                    (float*)p, r, rs_part[0], v, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // rs_part[i & 1] holds the sums of r.r entering iteration i
  for (int i = 0; i < iters; ++i) {
    float* dn = dbuf[i & 1];
    const float* dold = dbuf[(i + 1) & 1];
    cg_direction<<<grid, THREADS, 0, st>>>(r, dold, dn, ad, rs_part[i & 1],
                                           rs_part[(i + 1) & 1], dot_part, v,
                                           nb, i == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cg_update<<<grid, THREADS, 0, st>>>((float*)p, r, dn, ad, dot_part,
                                        rs_part[i & 1], rs_part[(i + 1) & 1],
                                        v, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
