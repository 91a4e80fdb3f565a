// Warm-started zero-Dirichlet Jacobi sweeps of the pressure Poisson equation,
// all sweeps of a call in one launch, tiled over the grid and the episodes.
//
// Replaces: smokephysai_tpu/ops/pallas/jacobi.py, jacobi_pressure_pallas, in
// both its forms: the whole grid in VMEM (_jacobi_kernel) and the row stripes
// padded by num_iters halo rows (_jacobi_tiled_kernel). Each sweep sets
// p <- (up + down + left + right - div) / 4 on the interior and 0 on the edge
// cells; taps beyond the grid are 0.
//
// What bounds it on an H100: latency. One call moves 3 planes (p and div in,
// p out: 768 KB at 256^2) and does ~5 operations per cell and sweep (6.6
// MFLOP for 20 sweeps), ~0.2 us of bytes at the HBM rate, while the sweeps
// are 20 dependent steps. The three 256^2 planes do not fit one SM's 227 KB
// of shared memory, and the serving path simulates one episode, so one block
// per episode would leave 131 of the 132 SMs idle.
//
// Design: the TPU kernel's tiled scheme, in two dimensions. A sweep moves
// information one cell, so a tile padded by k halo cells on each side
// computes its own cells exactly after k sweeps with no communication
// between blocks. Each block owns a TILE x TILE tile of one episode
// (gridDim = (tiles per episode, episodes)), loads the tile and its halo
// (clipped to the grid, where the zero taps are the true ones) of p and div
// into shared memory, sweeps there with the interior mask taken in global
// coordinates, and writes back only its own cells. The cells it sweeps shrink
// by one on each cut side per sweep: beyond that they are not needed. At
// TILE 32 and 20 sweeps a block holds 72 x 72 cells three times (62 KB),
// and a 256^2 episode is 64 blocks. A call with more than MAX_HALO sweeps runs
// them in passes of at most MAX_HALO, ping-ponging between the output and a
// scratch plane so that the last pass lands in the output.
//
// Rounding: built with -fmad=false and summed in the plain version's order
// ((((up + down) + left) + right) - div) * 0.25, so it matches
// ops/jacobi.py:jacobi_pressure_reference to the bit.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;      // owned cells per block: TILE x TILE
constexpr int MAX_HALO = 32;  // sweeps per pass (halo depth)
constexpr int BX = 32, BY = 8;

__global__ void __launch_bounds__(BX * BY)
jacobi_kernel(const float* __restrict__ p_in, const float* __restrict__ div_in,
              float* __restrict__ p_out, int h, int w, int tiles_x, int k) {
  extern __shared__ float smem[];
  const long plane = (long)h * w;
  const long e = blockIdx.y;
  const float* pe = p_in + e * plane;
  const float* de = div_in + e * plane;
  float* oe = p_out + e * plane;

  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int i0 = ty * TILE, j0 = tx * TILE;                // owned tile
  const int i1 = min(i0 + TILE, h), j1 = min(j0 + TILE, w);
  const int r0 = max(i0 - k, 0), r1 = min(i1 + k, h);      // with its halo
  const int c0 = max(j0 - k, 0), c1 = min(j1 + k, w);
  const int rh = r1 - r0, rw = c1 - c0;
  float* a = smem;
  float* b = a + rh * rw;
  float* d = b + rh * rw;

  for (int r = threadIdx.y; r < rh; r += BY)
    for (int c = threadIdx.x; c < rw; c += BX) {
      const long g = (long)(r0 + r) * w + c0 + c;
      a[r * rw + c] = pe[g];
      d[r * rw + c] = de[g];
    }
  __syncthreads();

  // a side cut by the halo (not the grid's edge) loses one exact cell per
  // sweep; an interior cell's four taps always lie inside the region
  const bool cut_top = r0 > 0, cut_bot = r1 < h;
  const bool cut_left = c0 > 0, cut_right = c1 < w;
  for (int s = 1; s <= k; ++s) {
    const int lo_r = cut_top ? s : 0, hi_r = rh - (cut_bot ? s : 0);
    const int lo_c = cut_left ? s : 0, hi_c = rw - (cut_right ? s : 0);
    for (int r = lo_r + threadIdx.y; r < hi_r; r += BY) {
      const int gi = r0 + r;
      const bool row_in = gi > 0 && gi < h - 1;
      for (int c = lo_c + threadIdx.x; c < hi_c; c += BX) {
        const int gj = c0 + c;
        const int at = r * rw + c;
        float val = 0.0f;
        if (row_in && gj > 0 && gj < w - 1)
          val = (a[at - rw] + a[at + rw] + a[at - 1] + a[at + 1] - d[at]) * 0.25f;
        b[at] = val;
      }
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }

  for (int r = i0 - r0 + threadIdx.y; r < i1 - r0; r += BY)
    for (int c = j0 - c0 + threadIdx.x; c < j1 - c0; c += BX)
      oe[(long)(r0 + r) * w + c0 + c] = a[r * rw + c];
}

}  // namespace

// `iters` sweeps of `episodes` planes of h x w laid out one after another:
// p, div -> out. With more than MAX_HALO sweeps the passes alternate between
// out and scratch (another plane set of the same size), ending in out; with
// fewer, scratch may be out. p and div are only read.
extern "C" int jacobi_launch(const void* p, const void* div, void* out,
                             void* scratch, long episodes, int h, int w,
                             int iters, void* stream) {
  if (episodes <= 0 || episodes > 65535 || h < 2 || w < 2 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_y = (h + TILE - 1) / TILE, tiles_x = (w + TILE - 1) / TILE;
  const dim3 grid((unsigned)(tiles_y * tiles_x), (unsigned)episodes);
  const dim3 block(BX, BY);
  cudaStream_t st = (cudaStream_t)stream;
  const int passes = iters == 0 ? 1 : (iters + MAX_HALO - 1) / MAX_HALO;
  const int side = TILE + 2 * (iters < MAX_HALO ? iters : MAX_HALO);
  const int smem = 3 * side * side * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float* src = (const float*)p;
  int left = iters;
  for (int pass = 0; pass < passes; ++pass) {
    const int k = left < MAX_HALO ? left : MAX_HALO;
    float* dst = ((passes - 1 - pass) & 1) == 0 ? (float*)out : (float*)scratch;
    const int bytes = 3 * (TILE + 2 * k) * (TILE + 2 * k) * (int)sizeof(float);
    jacobi_kernel<<<grid, block, bytes, st>>>(src, (const float*)div, dst, h, w,
                                              tiles_x, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
    left -= k;
  }
  return (int)cudaSuccess;
}
