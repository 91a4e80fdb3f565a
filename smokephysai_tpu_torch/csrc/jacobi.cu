// Warm-started zero-Dirichlet Jacobi sweeps of the pressure Poisson equation:
// one thread-block cluster per episode with the episode in shared memory
// where it fits (all sweeps in one launch), else one cluster per band of
// rows padded by halo rows (one launch per pass of up to `halo` sweeps).
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
// are 20 dependent steps, each of which must see its neighbours' cells of
// the sweep before. The three 256^2 planes do not fit one SM's 227 KB of
// shared memory, and the serving path simulates one episode, so one block
// per episode would leave 131 of the 132 SMs idle.
//
// Cluster mode (every grid whose stripes fit 227 KB a CTA at some cluster
// size of at most 16: 256^2 at 4 CTAs or more, 512^2 at 15 or 16, not
// 1024^2): one cluster per episode (one band of the whole grid), a row stripe of `rows` rows per CTA
// (the last CTA what is left). Each CTA keeps two planes of p, (rows + 2)
// x w floats with a halo row above and below, for all the sweeps: HBM is
// read once for p and div and written once for p, whatever the number of
// sweeps. Where w is a multiple of 4 (the solver's grids), a thread owns
// one column of four cells in `strip` consecutive rows and keeps their p
// and div in registers (episode_strips): a sweep walks the strip down with
// the rows above and below from registers, the cells beside by warp
// shuffles, and shared memory read only at the strip's and the warp's
// ends. Elsewhere one cell a thread, div in shared memory too
// (episode_cells). A thread that computes one of the stripe's edge rows
// stores it also into the neighbour's halo by st.async, straight from
// registers; the CTA's threads meet (__syncthreads) and wait for their own
// halos on the sweep's mbarrier (csrc/cluster.cuh). No cluster barrier per
// sweep. A neighbour writes sweep k's rows into the plane this CTA read in
// sweep k - 1 only after it has this CTA's sweep k - 1 rows, each of which
// the thread that read the halo cells beside it sends after that read, so
// no halo is overwritten while it is read. The launch plan (ops/jacobi.py,
// plan_launch) picks the cluster size, the rows, the threads and the
// strip, and launches at most as many clusters as fit the card at once;
// each takes episodes in turn.
//
// Band mode (grids past one cluster's shared memory: 1024^2, 2048^2): the
// TPU kernel's tiled scheme (row stripes padded by the pass's sweep count
// in halo rows) at the cluster mode's scale. A sweep moves information one
// row, so a band of `own` rows padded by `halo` rows on each cut side
// computes its own rows exactly after up to `halo` sweeps with no
// communication between clusters. Each cluster takes (episode, band) items
// in turn; the `span` = own + 2 halo rows of a band (shifted inside the
// grid at its top and bottom, so that every item has the same stripes) are
// cut into the cluster's CTA stripes and swept by the cluster mode's
// machinery as they stand: the stripes' halo rows between CTAs by st.async,
// the rows just outside the span (where the band is cut, not at the grid's
// edge) read from global memory once. The rows near a cut go stale one row
// a sweep and never reach the owned rows; sweeping them all the same costs
// nothing, as a sweep waits for the CTA with the most rows anyway. Only
// owned rows are written back. A call with more sweeps than `halo` runs
// them in passes, one launch each, ping-ponging between the output and a
// scratch plane so that the last pass lands in the output. HBM is read
// once a pass; at 2048^2 x 20 sweeps 16 CTAs of 8 rows carry 128 rows, 88
// of them owned: 1.45 cells swept per owned cell, against 5.06 for the
// 32 x 32 tiles this mode replaced.
//
// Rounding: built with -fmad=false and summed in the plain version's order
// ((((up + down) + left) + right) - div) * 0.25, so every plan matches
// ops/jacobi.py:jacobi_pressure_reference to the bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

// ---------------------------------------------------------------- cluster mode

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;
constexpr int kBarBytes = 16;  // the two halo mbarriers

struct ClusterParams {
  const float* p;
  const float* div;
  float* out;
  int episodes, h, w, iters;
  int rows;  // rows per CTA of a band's span (the last CTA may have fewer)
  // a band: `own` rows of the grid, swept as `span` rows that pad them by
  // `halo` rows on each cut side; `bands` per episode (the cluster mode:
  // one band of span = own = h)
  int span, own, halo, bands;
};

// Where a CTA's stripe of one (episode, band) item lies: `at` its first
// cell, from grid row r0, n rows; whether the rows just above and below it
// exist in the grid (loaded as its halo); its rows [wlo, whi) the band owns.
struct Stripe {
  long at;
  int r0, n;
  bool above, below;
  int wlo, whi;
};

// Floats of one p plane of a CTA: its rows and a halo row above and below,
// rounded up to a multiple of 4 so that the next plane starts 16-byte
// aligned.
__host__ __device__ inline long plane_floats(int rows, int w) {
  return ((long)(rows + 2) * w + 3) & ~3L;
}

__host__ __device__ inline long cluster_smem(int rows, int w) {
  return kBarBytes + 4 * (2 * plane_floats(rows, w) + (((long)rows * w + 3) & ~3L));
}

// Rows [lo, hi) of a (., w) global plane `g` (from grid row r0) into the
// stripe-local rows of `s` (row li at s + (li + off) * w), one cell a
// thread.
__device__ __forceinline__ void load_rows(const float* g, float* s, int off, int lo, int hi,
                                          int w) {
  for (int li = lo + (int)threadIdx.y; li < hi; li += (int)blockDim.y)
    for (int j = threadIdx.x; j < w; j += blockDim.x)
      s[(long)(li + off) * w + j] = __ldg(g + (long)li * w + j);
}

// Where a sweep's edge rows go: with `to_prev`, row 0 to CTA rank - 1's
// halo below (its row `rows`) at up_to; with `to_next`, row n - 1 to CTA
// rank + 1's halo above at down_to. Both are shared::cluster addresses of
// the row in the counterpart of this sweep's destination plane there,
// counted on that CTA's mbarrier of the sweep (bar_up, bar_down).
struct Sends {
  bool to_prev, to_next;
  uint32_t up_to, bar_up, down_to, bar_down;
};

__device__ __forceinline__ Sends sends_of(const float* dst, int rows, int w, bool has_prev,
                                          bool has_next, unsigned rank, const Halos& hx) {
  Sends s{has_prev, has_next, 0, 0, 0, 0};
  if (has_prev) {
    s.up_to = map_u32(smem_u32(dst + (long)(rows + 1) * w), rank - 1);
    s.bar_up = map_u32(halo_bar(hx), rank - 1);
  }
  if (has_next) {
    s.down_to = map_u32(smem_u32(dst), rank + 1);
    s.bar_down = map_u32(halo_bar(hx), rank + 1);
  }
  return s;
}

// The CTA's threads meet (the own rows of the sweep's destination are
// written, its source read no more), then wait for their halo rows.
__device__ __forceinline__ void end_sweep(Halos& hx, uint32_t in_bytes, unsigned csize) {
  __syncthreads();
  if (csize > 1) halo_wait(hx, in_bytes);
}

// One cell a thread (any w; R = 0): the stripe's p, with its halo rows, and
// div in shared memory; each sweep a loop over the stripe's rows by 2D
// thread coordinates, from plane `a` into plane `b` and back.
__device__ void episode_cells(const ClusterParams& prm, const Stripe& sp, float* a, float* b,
                              float* dv, bool has_prev, bool has_next, unsigned rank,
                              unsigned csize, Halos& hx, uint32_t in_bytes) {
  const int h = prm.h, w = prm.w, r0 = sp.r0, n = sp.n;
  const long at = sp.at;
  load_rows(prm.p + at, a, 1, sp.above ? -1 : 0, sp.below ? n + 1 : n, w);
  load_rows(prm.div + at, dv, 0, 0, n, w);
  __syncthreads();
  float* src = a;
  float* dst = b;
  for (int it = 0; it < prm.iters; ++it) {
    const Sends s = sends_of(dst, prm.rows, w, has_prev, has_next, rank, hx);
    for (int li = threadIdx.y; li < n; li += (int)blockDim.y) {
      const int i = r0 + li;
      const bool inner_row = i > 0 && i < h - 1;
      const float* up = src + (long)li * w;
      const float* mid = up + w;
      const float* down = mid + w;
      const float* d = dv + (long)li * w;
      float* o = dst + (long)(li + 1) * w;
      const bool send_up = s.to_prev && li == 0;
      const bool send_down = s.to_next && li == n - 1;
      for (int j = threadIdx.x; j < w; j += blockDim.x) {
        float r = 0.0f;
        if (inner_row && j > 0 && j < w - 1)
          r = 0.25f * (up[j] + down[j] + mid[j - 1] + mid[j + 1] - d[j]);
        o[j] = r;
        if (send_up) st_async_f32(s.up_to + 4 * j, r, s.bar_up);
        if (send_down) st_async_f32(s.down_to + 4 * j, r, s.bar_down);
      }
    }
    end_sweep(hx, in_bytes, csize);
    float* t = src;
    src = dst;
    dst = t;
  }
  float* out = prm.out + at;
  for (int li = sp.wlo + (int)threadIdx.y; li < sp.whi; li += (int)blockDim.y)
    for (int j = threadIdx.x; j < w; j += blockDim.x)
      out[(long)li * w + j] = src[(long)(li + 1) * w + j];
}

// Register strips (w a multiple of 4, every plane 16-byte aligned; R = 1,
// 2 or 4): thread (tx, ty) owns the four cells of quad column tx in the
// stripe's rows ty R ... ty R + R - 1, and keeps their p and div in
// registers for all the sweeps. A sweep walks the strip down, the row above
// and the row below the cell's own coming from the registers, and from the
// source plane only at the strip's two ends; the cells left and right of
// the quad by warp shuffles, and from the source plane at a warp's two
// ends. Each new quad goes to the destination plane by one 16-byte store
// (what the neighbouring threads read in the next sweep) and, on the
// stripe's edge rows, into the neighbour CTA's halo. Shared-memory traffic
// per quad and sweep: ~24 B at R = 4 against 88 for a cell-a-thread sweep.
template <int R>
__device__ void episode_strips(const ClusterParams& prm, const Stripe& sp, float* a, float* b,
                               bool has_prev, bool has_next, unsigned rank, unsigned csize,
                               Halos& hx, uint32_t in_bytes) {
  const int h = prm.h, w = prm.w, r0 = sp.r0, n = sp.n;
  const long at = sp.at;
  const int q = threadIdx.x, j = 4 * q;
  const bool col = j < w;
  const int lane = threadIdx.x & 31;
  const int l0 = threadIdx.y * R;  // the strip's first row
  const float* pe = prm.p + at;
  const float* de = prm.div + at;
  float4 p[R], d[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    p[k] = d[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int li = l0 + k;
    if (li < n && col) {
      p[k] = __ldg(reinterpret_cast<const float4*>(pe + (long)li * w + j));
      d[k] = __ldg(reinterpret_cast<const float4*>(de + (long)li * w + j));
      *reinterpret_cast<float4*>(a + (long)(li + 1) * w + j) = p[k];
    }
  }
  if (threadIdx.y == 0 && col) {  // the halo rows, from global memory too
    if (sp.above)
      *reinterpret_cast<float4*>(a + j) = __ldg(reinterpret_cast<const float4*>(pe - w + j));
    if (sp.below)
      *reinterpret_cast<float4*>(a + (long)(n + 1) * w + j) =
          __ldg(reinterpret_cast<const float4*>(pe + (long)n * w + j));
  }
  __syncthreads();
  float* src = a;
  float* dst = b;
  for (int it = 0; it < prm.iters; ++it) {
    const Sends s = sends_of(dst, prm.rows, w, has_prev, has_next, rank, hx);
    if (l0 < n) {  // the same for all the warp's lanes, as every branch below on li
      // the row above the strip: another thread's, or the halo
      float4 up = *reinterpret_cast<const float4*>(src + (long)l0 * w + (col ? j : 0));
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int li = l0 + k;
        if (li >= n) break;
        const float* mid = src + (long)(li + 1) * w;
        const float4 m = p[k];
        const float4 down = k + 1 < R && li + 1 < n
                                ? p[k + 1 < R ? k + 1 : k]
                                : *reinterpret_cast<const float4*>(mid + w + (col ? j : 0));
        float left = __shfl_up_sync(0xffffffffu, m.w, 1);
        float right = __shfl_down_sync(0xffffffffu, m.x, 1);
        if (lane == 0 && col && j > 0) left = mid[j - 1];
        if (lane == 31 && j + 4 < w) right = mid[j + 4];
        const int i = r0 + li;
        float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i > 0 && i < h - 1) {
          r.x = j > 0 ? 0.25f * (up.x + down.x + left + m.y - d[k].x) : 0.0f;
          r.y = 0.25f * (up.y + down.y + m.x + m.z - d[k].y);
          r.z = 0.25f * (up.z + down.z + m.y + m.w - d[k].z);
          r.w = j + 3 < w - 1 ? 0.25f * (up.w + down.w + m.z + right - d[k].w) : 0.0f;
        }
        if (col) {
          *reinterpret_cast<float4*>(dst + (long)(li + 1) * w + j) = r;
          if (s.to_prev && li == 0) st_async_f32x4(s.up_to + 4 * j, r, s.bar_up);
          if (s.to_next && li == n - 1) st_async_f32x4(s.down_to + 4 * j, r, s.bar_down);
        }
        up = m;
        p[k] = r;
      }
    }
    end_sweep(hx, in_bytes, csize);
    float* t = src;
    src = dst;
    dst = t;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int li = l0 + k;
    if (li >= sp.wlo && li < sp.whi && col)
      *reinterpret_cast<float4*>(prm.out + at + (long)li * w + j) = p[k];
  }
}

// Each cluster takes (episode, band) items cluster_id, + clusters, ...:
// loads its stripe of the band's span of p (with the halo rows) and of div,
// sweeps `iters` times, writes the band's own rows of p. R: the rows of a
// thread's register strip (0: one cell a thread, p and div in shared
// memory).
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
jacobi_cluster_kernel(ClusterParams prm) {
  extern __shared__ __align__(16) float smem[];
  const int h = prm.h, w = prm.w, rows = prm.rows;
  const unsigned rank = cluster_ctarank(), csize = cluster_nctarank();
  const int lr0 = (int)rank * rows;  // the stripe's first row in the span
  const int n = min(rows, prm.span - lr0);
  const bool has_prev = rank > 0, has_next = rank + 1 < csize;
  const long pf = plane_floats(rows, w);
  float* const pa = smem + kBarBytes / 4;
  float* const pb = pa + pf;
  float* const dv = pb + pf;
  Halos hx{smem_u32(smem), 0};
  if (threadIdx.x == 0 && threadIdx.y == 0) halo_init(hx.bar);
  cluster_barrier();  // every CTA of the cluster runs, its mbarriers set up
  // the halo rows that come in each sweep: the previous CTA's last row and
  // the next CTA's first
  const uint32_t in_bytes = 4u * (uint32_t)w * ((has_prev ? 1u : 0u) + (has_next ? 1u : 0u));
  const long plane = (long)h * w;
  const long items = (long)prm.episodes * prm.bands;
  for (long item = cluster_id(); item < items; item += cluster_count()) {
    const long e = item / prm.bands;
    const int band = (int)(item - e * prm.bands);
    // the band's own rows [o0, o1) and its span from s0, shifted inside the grid
    const int o0 = band * prm.own, o1 = min(o0 + prm.own, h);
    const int s0 = min(max(o0 - prm.halo, 0), h - prm.span);
    const int r0 = s0 + lr0;
    const Stripe sp{e * plane + (long)r0 * w, r0, n, r0 > 0, r0 + n < h,
                    max(o0 - r0, 0), min(o1 - r0, n)};
    if constexpr (R == 0)
      episode_cells(prm, sp, pa, pb, dv, has_prev, has_next, rank, csize, hx, in_bytes);
    else
      episode_strips<R>(prm, sp, pa, pb, has_prev, has_next, rank, csize, hx, in_bytes);
    __syncthreads();  // the planes are read before the next item loads into them
  }
  cluster_barrier();  // no CTA leaves while others may store into it
}

bool cluster_plan_ok(int h, int w, int cluster, int rows, int bx, int by, int smem,
                     int strip) {
  if (cluster < 1 || cluster > kMaxCluster || rows < 1) return false;
  if (bx < 32 || bx % 32 != 0 || by < 1 || bx * by > kMaxThreads) return false;
  // the stripes cover the grid exactly, none empty
  if ((long)rows * cluster < h || (long)rows * (cluster - 1) >= h) return false;
  // a register strip: a quad column a thread, the strips cover the stripe
  if (strip != 0 && ((strip != 1 && strip != 2 && strip != 4) || w % 4 != 0 ||
                     4 * bx < w || (long)by * strip < rows))
    return false;
  return smem >= cluster_smem(rows, w) && smem <= kMaxSmem;
}

using ClusterFn = void (*)(ClusterParams);

using Instance = ClusterKernel<ClusterFn>;

Instance& instance_for(int strip) {
  static Instance table[4] = {{jacobi_cluster_kernel<0>}, {jacobi_cluster_kernel<1>},
                              {jacobi_cluster_kernel<2>}, {jacobi_cluster_kernel<4>}};
  return table[strip == 4 ? 3 : strip];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// How many clusters of this shape fit the card at once, into *out. A
// failed query is cleared, so that it does not surface at a later launch.
extern "C" int jacobi_max_active_clusters(int strip, int cluster, int bx, int by, int smem,
                                          int* out) {
  if (strip != 0 && strip != 1 && strip != 2 && strip != 4) return (int)cudaErrorInvalidValue;
  Instance& k = instance_for(strip);
  cudaError_t e = configure(k, smem, cluster);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = launch_config(attr, cluster, 1, bx, by, smem, 0);
    e = cudaOccupancyMaxActiveClusters(out, (const void*)k.fn, &cfg);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// `iters` sweeps of `episodes` planes of h x w laid out one after another,
// p, div -> out, in launches of `clusters` clusters of `cluster` CTAs
// (ops/jacobi.py, plan_launch), with register strips of `strip` rows a
// thread (0: one cell a thread). A band of `own` rows of the grid is swept
// as `span` rows (`rows` a CTA), padded by `halo` rows on each cut side:
// the cluster mode is the one band own = span = h, all sweeps in one
// launch; with own < h the sweeps run in passes of at most `halo`, one
// launch each, alternating between out and scratch (another plane set of
// the same size) so that the last lands in out (with one pass, scratch may
// be out). p and div are only read. A plane that is not 16-byte aligned
// takes one cell a thread whatever the plan's strip: the same bits.
extern "C" int jacobi_cluster_launch(const void* p, const void* div, void* out, void* scratch,
                                     int episodes, int h, int w, int iters, int cluster,
                                     int clusters, int rows, int bx, int by, int smem,
                                     int strip, int span, int own, int halo, void* stream) {
  if (episodes <= 0 || h < 2 || w < 2 || iters < 0 || clusters < 1 || span > h ||
      own < 1 || halo < 0 || !cluster_plan_ok(span, w, cluster, rows, bx, by, smem, strip))
    return (int)cudaErrorInvalidValue;
  const bool banded = own < h;
  // one band covers the grid as its span; bands leave halo rows on each cut side
  if (banded ? (own + 2 * halo > span || (iters > 0 && halo == 0)) : span != h)
    return (int)cudaErrorInvalidValue;
  const int bands = (h + own - 1) / own;
  if ((long)episodes * bands > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(p) && aligned16(div) && aligned16(out) && aligned16(scratch);
  Instance& k = instance_for(aligned ? strip : 0);
  cudaError_t e = configure(k, smem, cluster);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      launch_config(attr, cluster, clusters, bx, by, smem, (cudaStream_t)stream);
  const int passes = banded && iters > 0 ? (iters + halo - 1) / halo : 1;
  const float* src = (const float*)p;
  int left = iters;
  for (int pass = 0; pass < passes; ++pass) {
    const int sweeps = banded && left > halo ? halo : left;
    float* dst = ((passes - 1 - pass) & 1) == 0 ? (float*)out : (float*)scratch;
    ClusterParams prm{src, (const float*)div, dst, episodes, h, w, sweeps, rows,
                      span, own, halo, bands};
    void* args[] = {&prm};
    e = cudaLaunchKernelExC(&cfg, (const void*)k.fn, args);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
    left -= sweeps;
  }
  return (int)cudaSuccess;
}
