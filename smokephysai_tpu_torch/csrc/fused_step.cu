// One whole smoke-solver step in one kernel launch, and a whole episode of
// steps in one launch, each episode on one thread-block cluster.
//
// Replaces: smokephysai_tpu/ops/pallas/fused_step.py, fused_step_pallas
// (_fused_step_kernel -> _step_vals) and fused_multi_step_pallas
// (_fused_multi_step_kernel, vmapped over episodes by the dataset
// generator): buoyancy on v[:, :-1], replicate-pad diffusion of u, v and
// density, divergence, warm-started zero-Dirichlet Jacobi sweeps, interior
// velocity correction, sequential tent-shift advection (u, then v with the
// new u, then density with both) with any tap radius D, and the density
// decay. The TPU kernel keeps the whole state in VMEM for all its steps.
//
// What bounds it on an H100: latency, not bytes or operations. At 128^2 the
// four fields are ~263 KB in and out and a step is ~6 MFLOP, but a step is
// a chain of dependent stages (iters + 5: 25 at 20 Jacobi sweeps), each of
// which must see its neighbours' results of the stage before. At batch 1 (a
// served scene) one block per episode reaches 1 of the 132 SMs, and a state
// that does not fit one SM's 227 KB of shared memory goes through L2 at
// every stage. A cluster barrier's release costs a MEMBAR.ALL.GPU, ~0.5 us,
// which the shared mode's mbarrier handshake does without.
//
// Design: one thread-block cluster of up to 16 CTAs per episode. The grid
// is cut into row stripes of `rows` rows, one per CTA (the last CTA also
// owns u's extra row h). A stage is a loop over the CTA's own rows by 2D
// thread coordinates (a warp along a row, warps across rows; no divide per
// cell). The stages: (1) buoyancy and the diffusion of u and v; (2) the
// Jacobi sweeps, the first computing the divergence on the fly, the others
// four cells a thread by 16-byte loads where w is a multiple of 4; (3) the
// velocity correction, with the diffusion of the density, which no stage
// needs before; (4-6) the advection of u, v and the density (with the
// decay). The state and its intermediates live in 6 planes per episode,
// whose roles rotate from stage to stage and step to step so that no stage
// reads a plane that it writes.
//
// Two modes, one template. SHARED (every grid whose planes fit 227 KB per
// CTA at some cluster size, up to ~320^2): each CTA keeps its stripe of the
// 6 planes, (rows + 2 halo) x (w + 1) floats each with halo = max(D, 1),
// in dynamic shared memory, and every read is local (the diffusion's, the
// Jacobi sweep's and the correction's +-1 rows, the divergence's u row
// below, the advection's +-D taps and v row below); rows >= D + 2, so a
// neighbour's halo is all a tap ever reaches. A stage ends with a halo
// exchange instead of a cluster barrier: the CTA's threads meet, the rows
// within `halo` of the stripe's edges go into the neighbours' halos by
// st.async (distributed shared memory), which completes on the receiver's
// mbarrier, and each CTA waits for its own halos (end_stage). The global
// mode (512^2, 1024^2): the same stages and cluster, whole planes in
// global scratch (one set per launched cluster, L2-resident up to ~1024^2),
// no halos, and a cluster barrier (barrier.cluster arrive.release /
// wait.acquire) after each stage. The launch plan (ops/fused_step.py,
// plan_launch) picks the mode, the cluster size, the rows and the threads
// per CTA, and launches at most as many clusters as fit the card at once;
// each takes episodes in turn. The multi-step kernel keeps the state in
// place for all `steps` steps, reading it once and writing it once, and
// writes each step's density to traj[e, t] from the advection itself.
// Loads of planes written inside the kernel are plain loads (no __ldg /
// restrict), ordered by the barriers' release/acquire.
//
// Rounding: built with -fmad=false and with the operations in the order
// the TPU kernel writes them, so each stage rounds as the plain PyTorch
// version (ops/fused_step.py, fused_step_reference) does; the multi-step
// kernel runs the same code as the single-step one, so T steps in one
// launch equal T single launches to the bit, whatever the plans.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;
constexpr int kSlots = 6;
constexpr int kBarBytes = 16;  // shared mode: two mbarriers

struct Params {
  const float* u;
  const float* v;
  const float* p;
  const float* d;
  float* uo;
  float* vo;
  float* po;
  float* dout;
  float* traj;     // [episodes, steps, h, w], or null
  float* scratch;  // global mode: kSlots planes per launched cluster
  int episodes, h, w, iters, steps, max_disp;
  float dt, buoy, coef_uv, coef_d;
  int rows;  // rows per CTA (the last CTA may have fewer)
};

// Floats of one slot: a CTA's stripe with its halos (shared mode), or a
// whole plane (global mode); u (h + 1, w) and v (h, w + 1) both fit. A
// multiple of 4, so that every slot starts 16-byte aligned.
__host__ __device__ inline long slot_floats(int shared, int rows, int halo,
                                            int h, int w) {
  const long f =
      shared ? (long)(rows + 2 * halo) * (w + 1) : (long)(h + 1) * (w + 1);
  return (f + 3) & ~3L;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// This CTA's place in its episode and its threads.
struct Ctx {
  int h;
  int r0;    // first grid row of the stripe
  int n;     // cell rows of the stripe
  int nu;    // u rows of the stripe: n, and row h on the last CTA
  int rows;  // rows per CTA
  int halo;  // halo rows above and below each stripe (shared mode)
  unsigned rank, csize;
  int tx, ty, bx, by;
};

// One plane in one slot. row(li) is the address of grid row r0 + li; in
// the shared mode li lies in [-halo, n + halo) (the halos hold copies of
// the neighbours' rows), in the global mode anywhere in the grid.
template <bool SHARED>
struct Plane {
  float* base;  // shared: the slot in this CTA; global: the plane's row 0
  int stride;
  __device__ __forceinline__ float* row(const Ctx& c, int li) const {
    if constexpr (SHARED) return base + (li + c.halo) * stride;
    return base + (long)(c.r0 + li) * stride;
  }
};

// A plane a stage wrote: its row width, and whether it is u-shaped (the
// last CTA also owns row h).
template <bool S>
struct Written {
  Plane<S> pl;
  int fw;
  bool u_rows;
};

// The end of a stage. Global mode: a cluster barrier. Shared mode: the
// CTA's threads meet (its own rows are written and every read of the
// stage is done); each written plane's rows within `halo` of the stripe's
// edge go into the neighbours' halos by st.async, which completes on the
// receiver's mbarrier for the stage's parity; then each CTA waits until
// its own halos have come in. A CTA sends stage k's rows only once all its
// reads up to stage k are done, and a neighbour writes stage k + 1's rows
// only after it has them, so no halo is overwritten while it is read.
// The mbarrier wait acquires at cluster scope; no MEMBAR.ALL.GPU is
// needed, as a cluster barrier's release would be.
template <bool S>
__device__ void end_stage(const Ctx& c, Halos& hx, const Written<S>* w,
                          int nw) {
  if constexpr (!S) {
    cluster_barrier();
  } else {
    __syncthreads();
    const uint32_t bar = halo_bar(hx);
    const bool has_prev = c.rank > 0, has_next = c.rank + 1 < c.csize;
    uint32_t bytes = 0;
    for (int q = 0; q < nw; ++q) {
      const Plane<S> pl = w[q].pl;
      const int fw = w[q].fw;
      const int mine = c.n + (w[q].u_rows && !has_next ? 1 : 0);
      // rows [0, top) to the previous CTA's rows [rows, rows + top);
      // rows [n - halo, n) to the next CTA's rows [-halo, 0)
      const int top = has_prev ? min(c.halo, mine) : 0;
      const int bot = has_next ? c.halo : 0;
      const uint32_t bar_prev = has_prev ? map_u32(bar, c.rank - 1) : 0;
      const uint32_t bar_next = has_next ? map_u32(bar, c.rank + 1) : 0;
      for (int r = c.ty; r < top + bot; r += c.by) {
        const bool up = r < top;
        const int li = up ? r : c.n - c.halo + (r - top);
        const int to = up ? li + c.rows : li - c.n;
        const float* src = pl.row(c, li);
        const uint32_t dst = map_u32(smem_u32(pl.row(c, to)), up ? c.rank - 1 : c.rank + 1);
        const uint32_t rb = up ? bar_prev : bar_next;
        for (int j = c.tx; j < fw; j += c.bx) st_async_f32(dst + 4 * j, src[j], rb);
      }
      // what the neighbours send: halo rows from the previous CTA, and
      // from the next what it has of them (u's row h on the last)
      int in = has_prev ? c.halo : 0;
      if (has_next) {
        const int r0n = c.r0 + c.rows;
        const int nn = min(c.rows, c.h - r0n) + (w[q].u_rows && c.rank + 2 == c.csize ? 1 : 0);
        in += min(c.halo, nn);
      }
      bytes += 4u * in * fw;
    }
    halo_wait(hx, bytes);
  }
}

// f + coef * (up + down + left + right - 4 f) with replicate padding over
// the stripe's `nrows` rows of an (fh, fw) field, where f(i, j) = a[i, j]
// + (j < add_cols ? add_coef * b[i, j] : 0) (the buoyancy term of v, folded
// into the read; add_cols = 0 for a plain field).
template <bool S>
__device__ void diffuse(const Ctx& c, Plane<S> a, Plane<S> b, float add_coef,
                        int add_cols, int fh, int fw, int nrows, float coef,
                        Plane<S> out) {
  for (int li = c.ty; li < nrows; li += c.by) {
    const int i = c.r0 + li;
    const int lu = clampi(i - 1, 0, fh - 1) - c.r0;
    const int ld = clampi(i + 1, 0, fh - 1) - c.r0;
    const float* am = a.row(c, li);
    const float* au = a.row(c, lu);
    const float* ad = a.row(c, ld);
    const float* bm = b.row(c, li);
    const float* bu = b.row(c, lu);
    const float* bd = b.row(c, ld);
    auto at = [&](const float* ar, const float* br, int j) -> float {
      float x = ar[j];
      if (j < add_cols) x = x + add_coef * br[j];
      return x;
    };
    float* o = out.row(c, li);
    for (int j = c.tx; j < fw; j += c.bx) {
      float f = at(am, bm, j);
      float up = at(au, bu, j);
      float down = at(ad, bd, j);
      float left = at(am, bm, clampi(j - 1, 0, fw - 1));
      float right = at(am, bm, clampi(j + 1, 0, fw - 1));
      float lap = up + down + left + right - 4.0f * f;
      o[j] = f + coef * lap;
    }
  }
}

// One cell of the tent-shift bilinear advection: the (2D+1)^2 taps of
// `field` around (i, j) for the back-traced point (py, px), with
// exact-edge zeroing, times `scale`. tap_row(di) is the field's row
// i + di (null beyond the grid).
template <int D, typename TapRow>
__device__ __forceinline__ float advect_cell(int i, int j, int fh, int fw,
                                             float px, float py, int rad,
                                             float scale, TapRow tap_row) {
  const int R = D > 0 ? D : rad;
  float acc = 0.0f;
#pragma unroll
  for (int di = -R; di <= R; ++di) {
    const int ii = i + di;
    const float wy = fmaxf(0.0f, 1.0f - fabsf(py - (float)ii));
    const float* fr = tap_row(di);
#pragma unroll
    for (int dj = -R; dj <= R; ++dj) {
      const int jj = j + dj;
      const float wx = fmaxf(0.0f, 1.0f - fabsf(px - (float)jj));
      const float tap = (fr != nullptr && jj >= 0 && jj < fw) ? fr[jj] : 0.0f;
      acc = acc + wy * wx * tap;
    }
  }
  const bool keep = (px < (float)(fw - 1)) && (py < (float)(fh - 1));
  return (keep ? acc : 0.0f) * scale;
}

// Tent-shift advection of the stripe's `nrows` rows of `field` (fh, fw) by
// the 2-tap centred velocities of u (row width uw) and v (vh rows), D taps
// each way (D = 0: the runtime radius `rad`), times `scale`, into `out`
// and, where given, into `traj` (a whole (fh, fw) plane in global memory).
template <int D, bool S>
__device__ void advect(const Ctx& c, int rad, Plane<S> field, int fh, int fw,
                       int nrows, Plane<S> u, int uw, Plane<S> v, int vh,
                       float dt, float scale, Plane<S> out, float* traj) {
  const int ucols = min(fw, uw - 1);
  const int vrows = min(fh, vh - 1);
  for (int li = c.ty; li < nrows; li += c.by) {
    const int i = c.r0 + li;
    const float* ur = u.row(c, li);
    const float* vr0 = v.row(c, li);
    const float* vr1 = v.row(c, li + 1);  // read only where i < vrows
    float* o = out.row(c, li);
    float* tr = traj != nullptr ? traj + (long)i * fw : nullptr;
    // the tap rows: looked up once per row for a compiled radius, per tap
    // for the runtime one
    const float* taps[D > 0 ? 2 * D + 1 : 1];
    auto tap_row = [&](int di) -> const float* {
      const int ii = i + di;
      return (ii >= 0 && ii < fh) ? field.row(c, ii - c.r0) : nullptr;
    };
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < 2 * D + 1; ++k) taps[k] = tap_row(k - D);
    }
    for (int j = c.tx; j < fw; j += c.bx) {
      float ui = j < ucols ? 0.5f * (ur[j] + ur[j + 1]) : 0.0f;
      float vi = i < vrows ? 0.5f * (vr0[j] + vr1[j]) : 0.0f;
      float px = fminf(fmaxf((float)j - dt * ui, 0.0f), (float)(fw - 1));
      float py = fminf(fmaxf((float)i - dt * vi, 0.0f), (float)(fh - 1));
      float r;
      if constexpr (D > 0) {
        r = advect_cell<D>(i, j, fh, fw, px, py, rad, scale,
                           [&](int di) { return taps[di + D]; });
      } else {
        r = advect_cell<D>(i, j, fh, fw, px, py, rad, scale, tap_row);
      }
      o[j] = r;
      if (tr != nullptr) tr[j] = r;
    }
  }
}

// Copies rows [lo, hi) (stripe-local) between a global (., fw) plane `g`
// and a plane of the state.
template <bool S>
__device__ void copy_rows(const Ctx& c, float* g, int fw, int lo, int hi,
                          Plane<S> pl, bool to_global) {
  for (int li = lo + c.ty; li < hi; li += c.by) {
    float* gr = g + (long)(c.r0 + li) * fw;
    float* pr = pl.row(c, li);
    for (int j = c.tx; j < fw; j += c.bx) {
      if (to_global)
        gr[j] = pr[j];
      else
        pr[j] = gr[j];
    }
  }
}

// A Jacobi sweep (after the first) where w is a multiple of 4: four cells
// of a row per thread, by 16-byte loads and stores, each cell summed as the
// one-cell loop sums it. Rows are 16-byte aligned: slots start so, and the
// planes of a sweep are w wide.
template <bool S>
__device__ void jacobi_sweep4(const Ctx& c, Plane<S> src, Plane<S> div,
                              Plane<S> dst) {
  const int h = c.h, w = src.stride;
  for (int li = c.ty; li < c.n; li += c.by) {
    const int i = c.r0 + li;
    float4* o = reinterpret_cast<float4*>(dst.row(c, li));
    if (!(i > 0 && i < h - 1)) {
      for (int j = 4 * c.tx; j < w; j += 4 * c.bx)
        o[j / 4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float* up = src.row(c, li - 1);
    const float* mid = src.row(c, li);
    const float* down = src.row(c, li + 1);
    const float* dv = div.row(c, li);
    for (int j = 4 * c.tx; j < w; j += 4 * c.bx) {
      const float4 a = *reinterpret_cast<const float4*>(up + j);
      const float4 b = *reinterpret_cast<const float4*>(down + j);
      const float4 m = *reinterpret_cast<const float4*>(mid + j);
      const float4 d = *reinterpret_cast<const float4*>(dv + j);
      // mid[j - 1] and mid[j + 4] are the neighbours' rows' ends at the
      // grid's edges, where the cell is 0 anyway
      const float left = mid[j - 1], right = mid[j + 4];
      float4 r;
      r.x = j > 0 ? 0.25f * (a.x + b.x + left + m.y - d.x) : 0.0f;
      r.y = 0.25f * (a.y + b.y + m.x + m.z - d.y);
      r.z = 0.25f * (a.z + b.z + m.y + m.w - d.z);
      r.w = j + 3 < w - 1 ? 0.25f * (a.w + b.w + m.z + right - d.w) : 0.0f;
      o[j / 4] = r;
    }
  }
}

// The slots of the state's roles; f1 and f2 are free between steps.
struct Roles {
  float *u, *v, *p, *d, *f1, *f2;
};

// One whole step of the cluster's episode, each stage ending in
// end_stage. Rotates the roles so that on return they hold the new state.
template <int D, bool S>
__device__ void step(const Ctx& c, const Params& p, Roles& sl, Halos& hx,
                     float* traj) {
  const int h = p.h, w = p.w;
  const Plane<S> u{sl.u, w}, v{sl.v, w + 1}, d{sl.d, w};
  const Plane<S> su{sl.f1, w}, sv{sl.f2, w + 1};

  // 1. buoyancy (folded into v's reads) and the diffusion of u and v
  diffuse<S>(c, u, u, 0.0f, 0, h + 1, w, c.nu, p.coef_uv, su);
  diffuse<S>(c, v, d, p.buoy, w, h, w + 1, c.n, p.coef_uv, sv);
  const Written<S> w1[2] = {{su, w, true}, {sv, w + 1, false}};
  end_stage<S>(c, hx, w1, 2);

  // 2. Jacobi sweeps, zero-Dirichlet boundary re-imposed each sweep, the
  // iterate ping-ponging between p's slot and v's (v is read no more); the
  // first sweep forms the divergence, kept in u's slot for the others
  const Plane<S> div{sl.u, w};
  Plane<S> src{sl.p, w}, dst{sl.v, w};
  for (int it = 0; it < p.iters; ++it) {
    if (it > 0 && w % 4 == 0) {
      jacobi_sweep4<S>(c, src, div, dst);
      const Written<S> w2{dst, w, false};
      end_stage<S>(c, hx, &w2, 1);
      const Plane<S> t = src;
      src = dst;
      dst = t;
      continue;
    }
    for (int li = c.ty; li < c.n; li += c.by) {
      const int i = c.r0 + li;
      const bool inner_row = i > 0 && i < h - 1;
      const float* up = src.row(c, li - 1);  // read only on inner rows
      const float* mid = src.row(c, li);
      const float* down = src.row(c, li + 1);
      const float* s0 = su.row(c, li);
      const float* s1 = su.row(c, li + 1);
      const float* v0 = sv.row(c, li);
      float* dv = div.row(c, li);
      float* o = dst.row(c, li);
      for (int j = c.tx; j < w; j += c.bx) {
        float dvj;
        if (it == 0) {
          dvj = (s1[j] - s0[j] + v0[j + 1] - v0[j]) / p.dt;
          dv[j] = dvj;
        } else {
          dvj = dv[j];
        }
        float r = 0.0f;
        if (inner_row && j > 0 && j < w - 1)
          r = 0.25f * (up[j] + down[j] + mid[j - 1] + mid[j + 1] - dvj);
        o[j] = r;
      }
    }
    const Written<S> w2{dst, w, false};
    end_stage<S>(c, hx, &w2, 1);
    const Plane<S> t = src;
    src = dst;
    dst = t;
  }
  float* const p_new = src.base;  // the final p
  float* const spare = dst.base;  // the other of p's and v's slots

  // 3. interior velocity correction, in place (each cell reads only itself
  // of su and sv), and the diffusion of the density into u's slot (the
  // divergence is read no more)
  const Plane<S> pf{p_new, w};
  for (int li = c.ty; li < c.nu; li += c.by) {
    const int i = c.r0 + li;
    if (i > 0 && i < h) {
      const float* pm = pf.row(c, li);
      const float* pu = pf.row(c, li - 1);
      float* s = su.row(c, li);
      for (int j = c.tx; j < w; j += c.bx) s[j] = s[j] - p.dt * (pm[j] - pu[j]);
    }
  }
  for (int li = c.ty; li < c.n; li += c.by) {
    const float* pm = pf.row(c, li);
    float* s = sv.row(c, li);
    for (int j = c.tx; j < w + 1; j += c.bx)
      if (j > 0 && j < w) s[j] = s[j] - p.dt * (pm[j] - pm[j - 1]);
  }
  const Plane<S> sd{sl.u, w};
  diffuse<S>(c, d, d, 0.0f, 0, h, w, c.n, p.coef_d, sd);
  const Written<S> w3[3] = {{su, w, true}, {sv, w + 1, false}, {sd, w, false}};
  end_stage<S>(c, hx, w3, 3);

  // 4. sequential advection: u by (u, v) into d's slot; v by (new u, v)
  // into the spare; d by (new u, new v) into su's slot, with 5. the density
  // decay
  const Plane<S> un{sl.d, w}, vn{spare, w + 1}, dn{sl.f1, w};
  advect<D, S>(c, p.max_disp, su, h + 1, w, c.nu, su, w, sv, h, p.dt, 1.0f,
               un, nullptr);
  const Written<S> w4{un, w, true};
  end_stage<S>(c, hx, &w4, 1);
  advect<D, S>(c, p.max_disp, sv, h, w + 1, c.n, un, w, sv, h, p.dt, 1.0f,
               vn, nullptr);
  const Written<S> w5{vn, w + 1, false};
  end_stage<S>(c, hx, &w5, 1);
  advect<D, S>(c, p.max_disp, sd, h, w, c.n, un, w, vn, h, p.dt, 0.995f, dn,
               traj);
  const Written<S> w6{dn, w, false};
  end_stage<S>(c, hx, &w6, 1);

  sl = Roles{sl.d, spare, p_new, sl.f1, sl.f2, sl.u};
}

// Each cluster takes episodes cluster_id, + clusters, ...: loads its state
// (and, in the shared mode, the halo rows), runs `steps` steps (traj[e, t]
// written after each when traj is given), writes the final state.
template <int D, bool S>
__device__ void run(const Params& p) {
  extern __shared__ float smem[];
  const int h = p.h, w = p.w;
  Ctx c;
  c.h = h;
  c.rows = p.rows;
  c.halo = S ? max(p.max_disp, 1) : 0;
  c.rank = cluster_ctarank();
  c.csize = cluster_nctarank();
  c.r0 = (int)c.rank * p.rows;
  c.n = min(p.rows, h - c.r0);
  c.nu = c.n + (c.rank + 1 == c.csize ? 1 : 0);
  c.tx = threadIdx.x;
  c.ty = threadIdx.y;
  c.bx = blockDim.x;
  c.by = blockDim.y;

  // shared mode: two mbarriers at the start of dynamic shared memory (the
  // halos of even and odd stages), the slots after them
  Halos hx{smem_u32(smem), 0};
  if (S && threadIdx.x == 0 && threadIdx.y == 0) halo_init(hx.bar);
  const long slot = slot_floats(S, p.rows, c.halo, h, w);
  float* b = S ? smem + kBarBytes / 4
               : p.scratch + (long)cluster_id() * kSlots * slot;
  Roles sl{b, b + slot, b + 2 * slot, b + 3 * slot, b + 4 * slot,
           b + 5 * slot};

  // stripe-local rows to load: the own rows and, shared, the halos
  const int top = max(-c.halo, -c.r0);
  const int ubot = min(c.nu + c.halo, h + 1 - c.r0);
  const int cbot = min(c.n + c.halo, h - c.r0);
  const long nu = (long)(h + 1) * w, nv = (long)h * (w + 1), nc = (long)h * w;
  cluster_barrier();  // every CTA of the cluster runs, its mbarriers set up
  for (long e = cluster_id(); e < p.episodes; e += cluster_count()) {
    copy_rows<S>(c, const_cast<float*>(p.u) + e * nu, w, top, ubot,
                 Plane<S>{sl.u, w}, false);
    copy_rows<S>(c, const_cast<float*>(p.v) + e * nv, w + 1, top, cbot,
                 Plane<S>{sl.v, w + 1}, false);
    copy_rows<S>(c, const_cast<float*>(p.p) + e * nc, w, top, cbot,
                 Plane<S>{sl.p, w}, false);
    copy_rows<S>(c, const_cast<float*>(p.d) + e * nc, w, top, cbot,
                 Plane<S>{sl.d, w}, false);
    if constexpr (S)
      __syncthreads();  // the halos came from global memory too
    else
      cluster_barrier();
    for (int t = 0; t < p.steps; ++t)
      step<D, S>(c, p, sl, hx,
                 p.traj != nullptr ? p.traj + (e * p.steps + t) * nc : nullptr);
    copy_rows<S>(c, p.uo + e * nu, w, 0, c.nu, Plane<S>{sl.u, w}, true);
    copy_rows<S>(c, p.vo + e * nv, w + 1, 0, c.n, Plane<S>{sl.v, w + 1}, true);
    copy_rows<S>(c, p.po + e * nc, w, 0, c.n, Plane<S>{sl.p, w}, true);
    copy_rows<S>(c, p.dout + e * nc, w, 0, c.n, Plane<S>{sl.d, w}, true);
  }
  if constexpr (S) cluster_barrier();  // no CTA leaves while others may store into it
}

template <int D, bool S>
__global__ void __launch_bounds__(kMaxThreads, 1) fused_step_kernel(Params p) {
  run<D, S>(p);
}

// The same body over `steps` steps (fused_multi_step_pallas).
template <int D, bool S>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_multi_step_kernel(Params p) {
  run<D, S>(p);
}

using KernelFn = void (*)(Params);

using Instance = ClusterKernel<KernelFn>;

// Tap radii 1 and 2 are compiled in; any other takes the runtime radius.
Instance& instance_for(int multi, int shared, int max_disp) {
  static Instance table[2][2][3] = {
      {{{fused_step_kernel<1, false>}, {fused_step_kernel<2, false>},
        {fused_step_kernel<0, false>}},
       {{fused_step_kernel<1, true>}, {fused_step_kernel<2, true>},
        {fused_step_kernel<0, true>}}},
      {{{fused_multi_step_kernel<1, false>},
        {fused_multi_step_kernel<2, false>},
        {fused_multi_step_kernel<0, false>}},
       {{fused_multi_step_kernel<1, true>}, {fused_multi_step_kernel<2, true>},
        {fused_multi_step_kernel<0, true>}}},
  };
  const int k = max_disp == 1 ? 0 : (max_disp == 2 ? 1 : 2);
  return table[multi != 0][shared != 0][k];
}

bool plan_ok(int h, int w, int max_disp, int cluster, int rows, int bx, int by,
             int smem, int shared) {
  if (cluster < 1 || cluster > kMaxCluster || rows < 1) return false;
  if (bx < 32 || bx % 32 != 0 || by < 1 || bx * by > kMaxThreads) return false;
  // the stripes cover the grid exactly, none empty
  if ((long)rows * cluster < h || (long)rows * (cluster - 1) >= h) return false;
  // a tap reaches no further than the neighbouring stripe
  if (cluster > 1 && rows < max_disp + 2) return false;
  if (shared)
    return smem >= kBarBytes + kSlots * slot_floats(1, rows, max(max_disp, 1), h, w) * 4 &&
           smem <= kMaxSmem;
  return smem == 0;
}

int launch(int multi, const Params& prm, int cluster, int clusters, int bx,
           int by, int smem, int shared, void* stream) {
  if (prm.episodes <= 0 || prm.h < 2 || prm.w < 2 || prm.iters < 0 ||
      prm.steps < 1 || prm.max_disp < 1 || clusters < 1 ||
      !plan_ok(prm.h, prm.w, prm.max_disp, cluster, prm.rows, bx, by, smem,
               shared) ||
      (!shared && prm.scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Instance& k = instance_for(multi, shared, prm.max_disp);
  cudaError_t e = configure(k, smem, cluster);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(attr, cluster, clusters, bx, by, smem,
                                         (cudaStream_t)stream);
  Params p = prm;
  void* args[] = {&p};
  e = cudaLaunchKernelExC(&cfg, (const void*)k.fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// How many clusters of this shape fit the card at once, into *out. A
// failed query is cleared, so that it does not surface at a later launch.
extern "C" int fused_step_max_active_clusters(int multi, int shared,
                                              int max_disp, int cluster,
                                              int bx, int by, int smem,
                                              int* out) {
  Instance& k = instance_for(multi, shared, max_disp);
  cudaError_t e = configure(k, smem, cluster);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = launch_config(attr, cluster, 1, bx, by, smem, 0);
    e = cudaOccupancyMaxActiveClusters(out, (const void*)k.fn, &cfg);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// One solver step for `episodes` independent states laid out one after
// another, by the plan's clusters (ops/fused_step.py, plan_launch). scratch:
// null in the shared mode, else clusters * 6 (h + 1)(w + 1) floats.
extern "C" int fused_step_launch(const void* u, const void* v, const void* p,
                                 const void* d, void* u_out, void* v_out,
                                 void* p_out, void* d_out, void* scratch,
                                 int episodes, int h, int w, int iters,
                                 int max_disp, float dt, float buoy,
                                 float coef_uv, float coef_d, int cluster,
                                 int clusters, int rows, int bx, int by,
                                 int smem, int shared, void* stream) {
  Params prm{(const float*)u, (const float*)v, (const float*)p,
             (const float*)d, (float*)u_out, (float*)v_out, (float*)p_out,
             (float*)d_out, nullptr, (float*)scratch, episodes, h, w, iters,
             1, max_disp, dt, buoy, coef_uv, coef_d, rows};
  return launch(0, prm, cluster, clusters, bx, by, smem, shared, stream);
}

// `steps` solver steps for `episodes` states in one kernel; traj is
// [episodes, steps, h, w]. The inputs are only read.
extern "C" int fused_multi_step_launch(
    const void* u, const void* v, const void* p, const void* d, void* u_out,
    void* v_out, void* p_out, void* d_out, void* traj, void* scratch,
    int episodes, int h, int w, int iters, int max_disp, int steps, float dt,
    float buoy, float coef_uv, float coef_d, int cluster, int clusters,
    int rows, int bx, int by, int smem, int shared, void* stream) {
  if (traj == nullptr) return (int)cudaErrorInvalidValue;
  Params prm{(const float*)u, (const float*)v, (const float*)p,
             (const float*)d, (float*)u_out, (float*)v_out, (float*)p_out,
             (float*)d_out, (float*)traj, (float*)scratch, episodes, h, w,
             iters, steps, max_disp, dt, buoy, coef_uv, coef_d, rows};
  return launch(1, prm, cluster, clusters, bx, by, smem, shared, stream);
}
