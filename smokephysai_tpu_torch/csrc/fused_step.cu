// One whole smoke-solver step in one kernel launch, and a whole episode of
// steps in one launch.
//
// Replaces: smokephysai_tpu/ops/pallas/fused_step.py, fused_step_pallas
// (_fused_step_kernel -> _step_vals) and fused_multi_step_pallas
// (_fused_multi_step_kernel, vmapped over episodes by the dataset
// generator): buoyancy on v[:, :-1], replicate-pad
// diffusion of u, v and density, divergence, warm-started zero-Dirichlet
// Jacobi sweeps, interior velocity correction, sequential tent-shift
// advection (u, then v with the new u, then density with both) and the
// density decay.
//
// What bounds it on an H100: latency, not bytes or operations. At 128^2 the
// four fields are ~263 KB in and out and a step is ~6 MFLOP, but it is ~26
// dependent stages (20 of them Jacobi sweeps), each of which must see the
// whole previous stage. The TPU kernel kept the state in VMEM; here the
// fields do not fit one block's 227 KB of shared memory, so they live in
// global memory, where at this size they stay resident in the 50 MB L2.
//
// Design: one block of 1024 threads per episode (gridDim.x = episodes), so a
// batch of episodes fills more SMs with no change to the code. Each stage is
// a block-strided loop over the cells, then __syncthreads(). Stages never
// read a buffer they write: the wrapper passes ping-pong scratch for the
// diffused fields, the divergence and the Jacobi iterate, and each
// advection writes straight into its output. Buffers written inside the
// kernel are read with plain loads (no __ldg / restrict), so a thread sees
// what other threads of its block wrote before the barrier.
//
// The multi-step kernel loops the same step body over `steps` inside one
// launch (one block per episode again, so a 64-episode chunk fills 64 of
// the 132 SMs) and copies each step's density to traj[episode, t]: the
// [N, T, H, W] layout of the vmapped JAX call. Its state ping-pongs between
// the output tensors and a second set in scratch, so the inputs are never
// written and the last step lands in the outputs.
//
// Rounding: built with -fmad=false and with the operations in the order
// the TPU kernel writes them, so each stage rounds as the plain PyTorch
// version (ops/fused_step.py, fused_step_reference) does.
#include <cuda_runtime.h>

namespace {

struct Fields {
  int h, w;
  float dt, buoy, coef_uv, coef_d;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// f + coef * (up + down + left + right - 4 f) with replicate padding, where
// f(i, j) = a[i, j] + (j < add_cols ? add_coef * b[i, j] : 0) (the buoyancy
// term of v, folded into the read; add_cols = 0 for a plain field).
__device__ void diffuse(const float* a, const float* b, float add_coef,
                        int add_cols, int bw, int fh, int fw, float coef,
                        float* out) {
  auto at = [&](int i, int j) -> float {
    float x = a[i * fw + j];
    if (j < add_cols) x = x + add_coef * b[i * bw + j];
    return x;
  };
  for (int idx = threadIdx.x; idx < fh * fw; idx += blockDim.x) {
    int i = idx / fw, j = idx - (idx / fw) * fw;
    float f = at(i, j);
    float up = at(clampi(i - 1, 0, fh - 1), j);
    float down = at(clampi(i + 1, 0, fh - 1), j);
    float left = at(i, clampi(j - 1, 0, fw - 1));
    float right = at(i, clampi(j + 1, 0, fw - 1));
    float lap = up + down + left + right - 4.0f * f;
    out[idx] = f + coef * lap;
  }
}

// Tent-shift bilinear advection of `field` (fh, fw) by the 2-tap centred
// velocities of u (uh, uw) and v (vh, vw), D taps each way, exact-edge
// zeroing, times `scale`.
template <int D>
__device__ void advect(const float* field, int fh, int fw, const float* u,
                       int uw, const float* v, int vh, int vw, float dt,
                       float scale, float* out) {
  const int ucols = min(fw, uw - 1);
  const int vrows = min(fh, vh - 1);
  for (int idx = threadIdx.x; idx < fh * fw; idx += blockDim.x) {
    int i = idx / fw, j = idx - (idx / fw) * fw;
    float ui = j < ucols ? 0.5f * (u[i * uw + j] + u[i * uw + j + 1]) : 0.0f;
    float vi = i < vrows ? 0.5f * (v[i * vw + j] + v[(i + 1) * vw + j]) : 0.0f;
    float px = fminf(fmaxf((float)j - dt * ui, 0.0f), (float)(fw - 1));
    float py = fminf(fmaxf((float)i - dt * vi, 0.0f), (float)(fh - 1));
    float acc = 0.0f;
#pragma unroll
    for (int di = -D; di <= D; ++di) {
      int ii = i + di;
      float wy = fmaxf(0.0f, 1.0f - fabsf(py - (float)ii));
#pragma unroll
      for (int dj = -D; dj <= D; ++dj) {
        int jj = j + dj;
        float wx = fmaxf(0.0f, 1.0f - fabsf(px - (float)jj));
        float tap = (ii >= 0 && ii < fh && jj >= 0 && jj < fw)
                        ? field[ii * fw + jj] : 0.0f;
        acc = acc + wy * wx * tap;
      }
    }
    bool keep = (px < (float)(fw - 1)) && (py < (float)(fh - 1));
    out[idx] = (keep ? acc : 0.0f) * scale;
  }
}

// One whole step of one episode, by the whole block: reads (u0, v0, p0,
// d0), writes (uo, vo, po, dout), which must not alias the inputs, and uses
// `step_scratch` ((h+1)w + h(w+1) + 3hw floats). Ends without a barrier.
template <int D>
__device__ void step_body(const float* u0, const float* v0, const float* p0,
                          const float* d0, float* uo, float* vo, float* po,
                          float* dout, float* step_scratch, const Fields& s,
                          int iters) {
  const int h = s.h, w = s.w;
  const int nu = (h + 1) * w, nv = h * (w + 1), nc = h * w;
  float* su = step_scratch;
  float* sv = su + nu;
  float* sd = sv + nv;
  float* div = sd + nc;
  float* sp = div + nc;

  // 1-2. buoyancy (folded into v's reads) and diffusion
  diffuse(u0, nullptr, 0.0f, 0, 0, h + 1, w, s.coef_uv, su);
  diffuse(v0, d0, s.buoy, w, w, h, w + 1, s.coef_uv, sv);
  diffuse(d0, nullptr, 0.0f, 0, 0, h, w, s.coef_d, sd);
  __syncthreads();

  // 3a. divergence
  for (int idx = threadIdx.x; idx < nc; idx += blockDim.x) {
    int i = idx / w, j = idx - (idx / w) * w;
    float dv = su[(i + 1) * w + j] - su[i * w + j] + sv[i * (w + 1) + j + 1]
               - sv[i * (w + 1) + j];
    div[idx] = dv / s.dt;
  }
  __syncthreads();

  // 3b. Jacobi sweeps, zero-Dirichlet boundary re-imposed each sweep; the
  // iterate ping-pongs between sp and po so the last sweep lands in po
  // whatever the parity of `iters`.
  const float* src = p0;
  for (int it = 0; it < iters; ++it) {
    float* dst = ((iters - it) & 1) ? po : sp;
    for (int idx = threadIdx.x; idx < nc; idx += blockDim.x) {
      int i = idx / w, j = idx - (idx / w) * w;
      float r = 0.0f;
      if (i > 0 && i < h - 1 && j > 0 && j < w - 1) {
        r = 0.25f * (src[idx - w] + src[idx + w] + src[idx - 1] + src[idx + 1]
                     - div[idx]);
      }
      dst[idx] = r;
    }
    __syncthreads();
    src = dst;
  }
  if (iters == 0) {
    for (int idx = threadIdx.x; idx < nc; idx += blockDim.x) po[idx] = p0[idx];
    __syncthreads();
  }

  // 3c. interior velocity correction, in place (each cell reads only itself)
  for (int idx = threadIdx.x; idx < nu; idx += blockDim.x) {
    int i = idx / w, j = idx - (idx / w) * w;
    if (i > 0 && i < h) su[idx] = su[idx] - s.dt * (po[i * w + j] - po[(i - 1) * w + j]);
  }
  for (int idx = threadIdx.x; idx < nv; idx += blockDim.x) {
    int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    if (j > 0 && j < w) sv[idx] = sv[idx] - s.dt * (po[i * w + j] - po[i * w + j - 1]);
  }
  __syncthreads();

  // 4. sequential advection: u by (u, v); v by (new u, v); d by (new u, new v)
  advect<D>(su, h + 1, w, su, w, sv, h, w + 1, s.dt, 1.0f, uo);
  __syncthreads();
  advect<D>(sv, h, w + 1, uo, w, sv, h, w + 1, s.dt, 1.0f, vo);
  __syncthreads();
  // 5. density decay folded into the last advection
  advect<D>(sd, h, w, uo, w, vo, h, w + 1, s.dt, 0.995f, dout);
}

__host__ __device__ inline long step_scratch_floats(int h, int w) {
  return (long)(h + 1) * w + (long)h * (w + 1) + 3L * h * w;
}

template <int D>
__global__ void __launch_bounds__(1024)
fused_step_kernel(const float* __restrict__ u_in, const float* __restrict__ v_in,
                  const float* __restrict__ p_in, const float* __restrict__ d_in,
                  float* u_out, float* v_out, float* p_out, float* d_out,
                  float* scratch, Fields s, int iters) {
  const int h = s.h, w = s.w;
  const long nu = (h + 1) * w, nv = h * (w + 1), nc = h * w;
  const long e = blockIdx.x;
  step_body<D>(u_in + e * nu, v_in + e * nv, p_in + e * nc, d_in + e * nc,
               u_out + e * nu, v_out + e * nv, p_out + e * nc, d_out + e * nc,
               scratch + e * step_scratch_floats(h, w), s, iters);
}

// `steps` whole steps of one episode per block (fused_multi_step_pallas).
// The state ping-pongs between the outputs and a second set in scratch,
// chosen so that the last step writes the outputs; the inputs are only
// read. After each step the density goes to traj[e, t].
template <int D>
__global__ void __launch_bounds__(1024)
fused_multi_step_kernel(const float* u_in, const float* v_in, const float* p_in,
                        const float* d_in, float* u_out, float* v_out,
                        float* p_out, float* d_out, float* traj, float* scratch,
                        Fields s, int iters, int steps) {
  const int h = s.h, w = s.w;
  const long nu = (h + 1) * w, nv = h * (w + 1), nc = h * w;
  const long e = blockIdx.x;
  float* step_scratch = scratch + e * (step_scratch_floats(h, w) + nu + nv + 2 * nc);
  float* ua = step_scratch + step_scratch_floats(h, w);
  float* va = ua + nu;
  float* pa = va + nv;
  float* da = pa + nc;
  float* uo = u_out + e * nu;
  float* vo = v_out + e * nv;
  float* po = p_out + e * nc;
  float* dout = d_out + e * nc;
  const float* cu = u_in + e * nu;
  const float* cv = v_in + e * nv;
  const float* cp = p_in + e * nc;
  const float* cd = d_in + e * nc;
  for (int t = 0; t < steps; ++t) {
    const bool to_out = ((steps - 1 - t) & 1) == 0;
    float* nu_ = to_out ? uo : ua;
    float* nv_ = to_out ? vo : va;
    float* np_ = to_out ? po : pa;
    float* nd_ = to_out ? dout : da;
    step_body<D>(cu, cv, cp, cd, nu_, nv_, np_, nd_, step_scratch, s, iters);
    __syncthreads();
    float* tr = traj + (e * steps + t) * nc;
    for (long idx = threadIdx.x; idx < nc; idx += blockDim.x) tr[idx] = nd_[idx];
    cu = nu_;
    cv = nv_;
    cp = np_;
    cd = nd_;
  }
}

}  // namespace

// Launch one solver step for `episodes` independent states laid out one
// after another. scratch holds episodes * ((h+1)w + h(w+1) + 3hw) floats.
extern "C" int fused_step_launch(const void* u, const void* v, const void* p,
                                 const void* d, void* u_out, void* v_out,
                                 void* p_out, void* d_out, void* scratch,
                                 int episodes, int h, int w, int iters,
                                 int max_disp, float dt, float buoy,
                                 float coef_uv, float coef_d, void* stream) {
  if (episodes <= 0 || h < 2 || w < 2 || iters < 0) return (int)cudaErrorInvalidValue;
  Fields s{h, w, dt, buoy, coef_uv, coef_d};
  cudaStream_t st = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    kernel<<<episodes, 1024, 0, st>>>(
        (const float*)u, (const float*)v, (const float*)p, (const float*)d,
        (float*)u_out, (float*)v_out, (float*)p_out, (float*)d_out,
        (float*)scratch, s, iters);
  };
  switch (max_disp) {
    case 1: args(fused_step_kernel<1>); break;
    case 2: args(fused_step_kernel<2>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launch `steps` solver steps for `episodes` states in one kernel; traj is
// [episodes, steps, h, w]. scratch holds episodes * (2(h+1)w + 2h(w+1) + 5hw)
// floats (a step's scratch plus the second state set).
extern "C" int fused_multi_step_launch(
    const void* u, const void* v, const void* p, const void* d, void* u_out,
    void* v_out, void* p_out, void* d_out, void* traj, void* scratch,
    int episodes, int h, int w, int iters, int max_disp, int steps, float dt,
    float buoy, float coef_uv, float coef_d, void* stream) {
  if (episodes <= 0 || h < 2 || w < 2 || iters < 0 || steps < 1)
    return (int)cudaErrorInvalidValue;
  Fields s{h, w, dt, buoy, coef_uv, coef_d};
  cudaStream_t st = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    kernel<<<episodes, 1024, 0, st>>>(
        (const float*)u, (const float*)v, (const float*)p, (const float*)d,
        (float*)u_out, (float*)v_out, (float*)p_out, (float*)d_out,
        (float*)traj, (float*)scratch, s, iters, steps);
  };
  switch (max_disp) {
    case 1: args(fused_multi_step_kernel<1>); break;
    case 2: args(fused_multi_step_kernel<2>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
