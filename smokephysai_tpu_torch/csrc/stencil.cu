// Explicit-Euler diffusion of one float32 field: one elementwise pass with a
// replicate-padded 5-point Laplacian.
//
// Replaces: smokephysai_tpu/ops/pallas/stencil.py, diffuse_pallas
// (_diffuse_kernel): out = f + coef * (up + down + left + right - 4 f), the
// edge rows and columns standing in for their missing neighbours, coef =
// dt * viscosity formed in float32 by the caller.
//
// What bounds it on an H100: bytes. Each cell is read once (its four
// neighbours come from the same rows, which the L1 and L2 caches hold) and
// written once, 8 bytes per cell against 7 operations. At the solver's 256^2
// fields that is ~0.5 MB, so a launch is short enough for its latency to
// matter more than its bandwidth.
//
// Design: one thread per output cell over a flat [episodes, h, w] index,
// neighbours read through the read-only cache. The solver calls it once per
// field (u, v, density: three launches per step), as the JAX package calls
// diffuse_pallas three times.
//
// Rounding: built with -fmad=false and summed in the plain version's order
// ((((up + down) + left) + right) - 4 f), so it matches
// ops/stencil.py:diffuse_reference to the bit.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
diffuse_kernel(const float* __restrict__ f, float* __restrict__ out,
               long total, int h, int w, float coef) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long plane = (long)h * w;
  const long base = (idx / plane) * plane;
  const int cell = (int)(idx - base);
  const int i = cell / w, j = cell - (cell / w) * w;
  const float* e = f + base;
  const float c = __ldg(e + cell);
  const float up = __ldg(e + (i > 0 ? i - 1 : 0) * w + j);
  const float down = __ldg(e + (i < h - 1 ? i + 1 : h - 1) * w + j);
  const float left = __ldg(e + i * w + (j > 0 ? j - 1 : 0));
  const float right = __ldg(e + i * w + (j < w - 1 ? j + 1 : w - 1));
  const float lap = up + down + left + right - 4.0f * c;
  out[idx] = c + coef * lap;
}

}  // namespace

// One diffusion update of `episodes` fields of h x w laid out one after
// another, from f into out (distinct buffers).
extern "C" int diffuse_launch(const void* f, void* out, long episodes, int h,
                              int w, float coef, void* stream) {
  if (episodes <= 0 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const long total = episodes * (long)h * w;
  const int threads = 256;
  const long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  diffuse_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)f, (float*)out, total, h, w, coef);
  return (int)cudaGetLastError();
}
