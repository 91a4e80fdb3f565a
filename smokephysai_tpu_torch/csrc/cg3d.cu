// Fixed-iteration matrix-free conjugate-gradient pressure solve of the 3D
// solver, batched over episodes, in one persistent launch per solve.
//
// Replaces: smokephysai_tpu/ops/pallas/cg3d.py, cg_pressure_pallas
// (_cg_kernel): CG on A p = b with A = -Laplacian (7-point, zero outside the
// domain: _neg_lap_dirichlet) and b = -div, warm-started from p0:
//   r = b - A p0, d = r, rs = sum r^2; then num_iters times
//   Ad = A d, denom = sum d.Ad, alpha = denom > 0 ? rs / (denom + 1e-30) : 0,
//   p += alpha d, r -= alpha Ad, rs' = sum r^2,
//   beta = rs > 0 ? rs' / (rs + 1e-30) : 0, d = r + beta d, rs = rs'.
// Alpha and beta belong to each episode (the JAX package vmaps the solve).
// The TPU kernel keeps the whole solve in VMEM as one program.
//
// What bounds it on an H100: operations, barely, and in practice latency.
// One solve reads p0 and div and writes p, 12 bytes a cell (25 MB at 128^3,
// 7.5 us at 3.35 TB/s), and does ~18 float32 operations a cell and
// iteration (0.017 ms for 30 iterations at 128^3 at 67 TFLOP/s). Every
// iteration holds two reductions over the whole volume that each later
// stage needs, so the iterations cannot overlap, and the four live volumes
// (p, r, d, Ad: 33.6 MB at 128^3) do not fit one SM.
//
// Design: one cooperative launch per solve; every CTA stays resident for
// the whole solve. An iteration is two phases:
//   A: beta from the r.r partials, d = r + beta d (d = r the first time),
//      Ad = A d, partials of d.Ad;
//   B: alpha from the d.Ad partials, p += alpha d, r -= alpha Ad, partials
//      of r.r (the last iteration writes p instead).
// Reduction granules: an episode is cut into granules of min(16, h) rows of
// 32 columns in one plane, a function of (d, h, w) alone. A warp owns a
// granule, lane i its column i: lane i sums its rows in order, then the
// warp adds its 32 lanes by a butterfly; the episode's total is taken from
// its granules' partials, in granule order, by the same butterfly over
// chunks of 32, repeated on the chunk sums until one is left
// (episode_sum). Every CTA reduces the partials itself, in that one order,
// so all hold the same alpha and beta; no floating-point atomics. No sum
// depends on the batch, the mode, the CTA count or the thread count, so
// every plan gives the same bits, and an episode solved in a batch equals
// its solve alone.
// The barrier: every episode has a flag per CTA that works on it. After a
// phase's stores (partials and faces) a CTA raises its flag to the phase's
// tag with release semantics; before summing, a CTA waits until the flags
// of all the CTAs of its episode are at or past the tag (a thread a flag,
// relaxed polls, then an acquire fence), then reads the partials in one
// pass: an episode-wide barrier that, at one episode, spans the whole grid,
// with one flag a CTA to poll (every thread polling the 4096 partials of a
// 128^3 episode took ~5 us a wait on an H100). Tags only grow: the wrapper
// gives each launch tags past every flag's value (ops/cg3d.py, _flags). A
// CTA may run one phase ahead of another of its episode, so a flag may
// already carry the next tag when it is polled; it cannot run two ahead (it
// needs that one's flag of the phase between), so one set of partials per
// kind of sum is enough. A wait over 4 s traps instead of hanging: all
// CTAs are resident (a cooperative launch), so only a fault can get there.
//
// Two modes (ops/cg3d.py, plan_launch, picks one and the cut):
//   ON-CHIP, where one episode's bricks fit the card at once: each CTA
//   owns one brick of whole granules (bz planes x kgy granule rows x kgx
//   granule columns, a warp per granule) for the whole solve of an
//   episode, and the launch's CTAs take the episodes in waves (2 x 128^3:
//   two waves of one episode, the global mode's traffic saved). d lives in
//   shared memory with a one-cell shell around the brick, r and p in shared
//   memory; Ad is formed in phase A for d.Ad and again in phase B from the
//   same d (the same bits), which leaves no per-thread arrays to spill
//   (at 128^3 the 64 registers of a 1024-thread CTA cannot hold 16 cells of
//   two vectors and the addresses of an unrolled column). Halos ride on
//   the partials: in phase B a CTA stores the r and d of its cells on a
//   face that a neighbouring brick reads into global exchange volumes,
//   double-buffered by iteration parity, before the partials that release
//   them; after its wait the neighbour forms d = r + beta d from them for
//   its shell, the same operations as the owner, so the same bits. The
//   residual's stencil reads p0 from global memory, so no exchange
//   precedes it.
//   GLOBAL, otherwise (an episode past ~2.4M cells, e.g. 160^3): r and two
//   halves of d (ping-pong, as other CTAs read d_old while d is written)
//   live in global scratch and p in the output; every CTA takes the
//   episodes one at a time, walking an even share of each one's granules.
//   In phase A d is formed at each of the 7 taps from r and d_old (the
//   same operations at every cell, so the same bits as the stored d); in
//   phase B Ad is formed again from the stored d, as on chip.
// A lane walks its rows carrying the y neighbours in registers; a warp
// loads a row of a face. Data written inside the kernel is read with plain
// or .cg loads (no __ldg, no const restrict), ordered by the waits.
//
// Rounding: built with -fmad=false; the stencil adds in the plain version's
// order (((((z-1 + z+1) + y-1) + y+1) + x-1) + x+1) - 6 c, negated. The sums
// are taken in another order than torch.sum's, so the kernel matches its
// plain version to float32 rounding, not to the bit.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;     // granule columns: one a lane
constexpr int kMaxRows = 16;  // granule rows: min(kMaxRows, h)
constexpr int kBatch = 4;     // partials whose loads go together
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;
constexpr unsigned long long kTimeoutNs = 4000000000ull;

struct Geo {
  int d, h, w;
  long n;        // cells per episode
  int rows;      // rows per granule
  int ngy, ngx;  // granules along y and x
  int g;         // granules per episode: d * ngy * ngx
};

Geo make_geo(int d, int h, int w) {
  Geo G;
  G.d = d;
  G.h = h;
  G.w = w;
  G.n = (long)d * h * w;
  G.rows = h < kMaxRows ? h : kMaxRows;
  G.ngy = (h + G.rows - 1) / G.rows;
  G.ngx = (w + kCols - 1) / kCols;
  G.g = d * G.ngy * G.ngx;
  return G;
}

// Floats of the episode_sum buffers for n partials: the level sums of
// chunks of 32 (ping-pong between the first two levels' sizes) and the
// total.
int tree_floats(int n) {
  const int n1 = (n + 31) / 32;
  return n1 + (n1 + 31) / 32 + 1;
}

struct Params {
  const float* p0;
  const float* div;
  float* out;
  float* vec;     // 4 volume sets of episodes * n floats
  float* part;    // 2 sets of episodes * g partials: d.Ad and r.r
  unsigned* flags;  // a flag a CTA of each episode
  long episodes;
  Geo geo;
  int iters;
  unsigned tag;       // the tag of the residual's partials; phase k's is tag + k
  int bz, kgy, kgx;   // on-chip brick: planes, granule rows, granule columns
  int nbz, nby, nbx;  // on-chip bricks along z, y, x
  int tree;           // floats of the sums' buffers
};

// phase tags: the residual's q.tag; iteration i: A q.tag + 2i + 1, B + 2i + 2
__device__ __forceinline__ unsigned tag_a(const Params& q, int it) { return q.tag + 2 * it + 1; }
__device__ __forceinline__ unsigned tag_b(const Params& q, int it) { return q.tag + 2 * it + 2; }

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: both partners add the same two numbers, so every lane ends
  // with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned load_flag(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The CTA's flag for a phase, raised after every thread's stores of the
// phase (its partials and faces): a release, so that whoever sees the tag
// sees them too.
__device__ __forceinline__ void raise_flag(unsigned* flag, unsigned tag) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(flag), "r"(tag) : "memory");
}

// Waits until the n flags at `flags` are at or past `tag` (a thread a
// flag, relaxed polls, then an acquire fence), after which every thread of
// the CTA sees what their CTAs stored before raising them. At or past: a
// CTA may already have raised its next phase's tag over this one. A wait
// over kTimeoutNs traps.
__device__ __forceinline__ void wait_flags(const unsigned* flags, int n, unsigned tag) {
  if (threadIdx.x < n) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      if (load_flag(flags + k) < tag) {
        const unsigned long long t0 = global_ns();
        while (load_flag(flags + k) < tag)
          if (global_ns() - t0 > kTimeoutNs) __trap();  // fail, do not hang
      }
    }
    asm volatile("fence.acq_rel.gpu;" ::: "memory");  // acquire what was seen
  }
  __syncthreads();
}

// The sum of the n partials at `part` in the one fixed order: chunks of 32
// consecutive values, each by warp_sum (zero-padded), repeated on the chunk
// sums until one is left. Every thread of the CTA calls it and gets the
// total; the CTA's warps take the first level, warp 0 the rest. `buf`
// holds tree_floats(n) floats of shared memory, the total in its last.
__device__ float episode_sum(const float* part, int n, float* buf) {
  const int lane = threadIdx.x & 31, nt = blockDim.x;
  int m = (n + 31) >> 5;
  float* in = buf;
  float* out = buf + m;
  float* total = buf + m + ((m + 31) >> 5);
  // thread t reads partials t, t + nt, ...: lane i of chunk k / 32
  for (int k0 = threadIdx.x; k0 < (m << 5); k0 += kBatch * nt) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * nt;
      v[u] = k < n ? __ldcg(part + k) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * nt;
      if (k < (m << 5)) {  // the same for the whole warp
        const float c = warp_sum(v[u]);
        if (lane == 0) in[k >> 5] = c;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    while (m > 1) {
      const int len = m;
      m = (m + 31) >> 5;
      for (int c = 0; c < m; ++c) {
        const int k = (c << 5) + lane;
        const float v = warp_sum(k < len ? in[k] : 0.0f);
        if (lane == 0) out[c] = v;
      }
      __syncwarp();
      float* t = in;
      in = out;
      out = t;
    }
    if (lane == 0) *total = in[0];
  }
  __syncthreads();
  return *total;
}

// A lane's column of a granule of an episode: plane z, first row y0,
// column x; `rows` cells (0 for a lane beyond w); cell0 the flat index in
// the episode of its first cell.
struct Column {
  int cell0, z, y0, x, rows;
};

__device__ __forceinline__ Column column_of(const Geo& G, int t, int lane) {
  Column c;
  c.z = t / (G.ngy * G.ngx);
  t -= c.z * G.ngy * G.ngx;
  const int gy = t / G.ngx;
  const int gx = t - gy * G.ngx;
  c.y0 = gy * G.rows;
  c.x = gx * kCols + lane;
  const int rows = G.h - c.y0 < G.rows ? G.h - c.y0 : G.rows;
  c.rows = c.x < G.w ? rows : 0;
  c.cell0 = (c.z * G.h + c.y0) * G.w + c.x;
  return c;
}

// Walks a lane's column, calling body(j, i, c, a) at row j, cell i, with
// c = val(i) and a = -Lap val there: -(sum of the six taps - 6 c), a tap
// beyond the domain being 0, added in the plain version's order. The y
// taps ride along the column in registers.
template <typename F, typename B>
__device__ __forceinline__ void walk_column(F val, const Column& c, const Geo& G, B body) {
  if (c.rows == 0) return;
  const int hw = G.h * G.w;
  float cm = c.y0 > 0 ? val(c.cell0 - G.w) : 0.0f;
  float cc = val(c.cell0);
  for (int j = 0, i = c.cell0; j < c.rows; ++j, i += G.w) {
    const float cn = c.y0 + j < G.h - 1 ? val(i + G.w) : 0.0f;
    const float zm = c.z > 0 ? val(i - hw) : 0.0f;
    const float zp = c.z < G.d - 1 ? val(i + hw) : 0.0f;
    const float xm = c.x > 0 ? val(i - 1) : 0.0f;
    const float xp = c.x < G.w - 1 ? val(i + 1) : 0.0f;
    body(j, i, cc, -(((((zm + zp) + cm) + cn) + xm) + xp - 6.0f * cc));
    cm = cc;
    cc = cn;
  }
}

// ------------------------------------------------------------ on-chip mode

// One row of the lane's column: -Lap d at shared index s from the shelled d,
// the row's y neighbours cm (above) and cn (below) given; c the row's d.
__device__ __forceinline__ float lap_row(const float* ds, int s, int sy, int sz, float cm,
                                         float c, float cn) {
  return -(((((ds[s - sz] + ds[s + sz]) + cm) + cn) + ds[s - 1]) + ds[s + 1] - 6.0f * c);
}

// A face row of the shell: `count` cells from flat index gi into shared
// index si, d = r + beta d from the published r and d (d = r the first
// time); a warp a row, a lane a cell.
__device__ __forceinline__ void load_row(float* ds, int si, const float* rp, const float* dp,
                                         long gi, int count, bool first, float beta) {
#pragma unroll 4
  for (int c = threadIdx.x & 31; c < count; c += 32) {
    const float r = __ldcg(rp + gi + c);
    ds[si + c] = first ? r : r + beta * __ldcg(dp + gi + c);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1) cg_chip_kernel(Params q) {
  extern __shared__ float smem[];
  const Geo G = q.geo;
  const int bz = q.bz, by = q.kgy * G.rows, bx = q.kgx * kCols;
  const int sy = bx + 2, sz = (by + 2) * sy;  // strides of the shelled d
  const int shell = (bz + 2) * sz, brick = bz * by * bx;
  float* ds = smem;              // d, (bz + 2) x (by + 2) x (bx + 2)
  float* rsm = smem + shell;     // r, bz x by x bx
  float* psm = rsm + brick;      // p, bz x by x bx
  float* tree = psm + brick;     // episode_sum's buffers
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int i = tid; i < shell + 2 * brick; i += nt) smem[i] = 0.0f;

  // this CTA's brick, the same in every episode it takes
  const int per_episode = q.nbz * q.nby * q.nbx;
  int b = blockIdx.x % per_episode;
  const int bzi = b / (q.nby * q.nbx);
  b -= bzi * q.nby * q.nbx;
  const int byi = b / q.nbx, bxi = b - byi * q.nbx;
  const int z0 = bzi * bz, y0 = byi * by, x0 = bxi * bx;
  const int hw = G.h * G.w;
  const bool zlo = z0 > 0, zhi = z0 + bz < G.d;
  const bool ylo = y0 > 0, yhi = y0 + by < G.h;
  const bool xlo = x0 > 0, xhi = x0 + bx < G.w;
  const int zn = (z0 + bz < G.d ? bz : G.d - z0);  // planes, rows and columns
  const int yn = (y0 + by < G.h ? by : G.h - y0);  // of the brick inside the
  const int xn = (x0 + bx < G.w ? bx : G.w - x0);  // volume

  // this warp's granule and this lane's column of it
  const int per_plane = q.kgy * q.kgx;
  const int zl = warp / per_plane;
  const int gyl = (warp - zl * per_plane) / q.kgx;
  const int gxl = warp - zl * per_plane - gyl * q.kgx;
  const int gy = byi * q.kgy + gyl, gx = bxi * q.kgx + gxl;
  const int z = z0 + zl;
  const bool valid = z < G.d && gy < G.ngy && gx < G.ngx;
  const int gidx = (z * G.ngy + gy) * G.ngx + gx;
  const int yl0 = gyl * G.rows, xl = gxl * kCols + lane;
  const int x = x0 + xl, ybase = y0 + yl0;
  int rows = 0;
  if (valid && x < G.w) rows = G.h - ybase < G.rows ? G.h - ybase : G.rows;
  const int cell0 = (z * G.h + ybase) * G.w + x;  // in the episode
  const int s0 = ((zl + 1) * (by + 2) + yl0 + 1) * sy + xl + 1;
  const int k0 = (zl * by + yl0) * bx + xl;
  // the lane's rows that a neighbouring brick reads (bit j: row j): on a
  // face of the brick with a brick beyond it
  unsigned face = 0;
  if ((zl == 0 && zlo) || (zl == bz - 1 && zhi) || (xl == 0 && xlo) || (xl == bx - 1 && xhi))
    face = 0xffffu;
  if (yl0 == 0 && ylo) face |= 1u;
  if (yl0 + G.rows == by && yhi) face |= 1u << (G.rows - 1);

  const long set = q.episodes * G.n;       // floats of one volume set
  const long pset = q.episodes * G.g;      // partials of one kind
  __syncthreads();
  // the CTAs take the episodes in waves of gridDim.x / per_episode
  for (long e = blockIdx.x / per_episode; e < q.episodes; e += gridDim.x / per_episode) {
    const long ebase = e * G.n;
    float* rpub = q.vec + ebase;             // r exchanged, [parity]
    float* dpub = q.vec + 2 * set + ebase;   // d exchanged, [parity]
    float* dad_part = q.part + e * G.g;     // this episode's d.Ad partials
    float* rr_part = q.part + pset + e * G.g;  // and r.r partials
    unsigned* eflags = q.flags + e * per_episode;  // and its bricks' flags
    unsigned* flag = eflags + blockIdx.x % per_episode;

    // r = -div - A p0 (p0's taps from global memory), p = p0
    {
      const float* pe0 = q.p0 + ebase;
      const float* de = q.div + ebase;
      float acc = 0.0f;
      walk_column([&](int k) { return __ldg(pe0 + k); }, Column{cell0, z, ybase, x, rows}, G,
                  [&](int j, int i, float c, float ap) {
                    const float r = -__ldg(de + i) - ap;
                    psm[k0 + j * bx] = c;
                    rsm[k0 + j * bx] = r;
                    acc += r * r;
                    if (face >> j & 1u) __stcg(rpub + i, r);
                  });
      acc = warp_sum(acc);
      if (valid && lane == 0) __stcg(rr_part + gidx, acc);
      raise_flag(flag, q.tag);
    }

    float rs = 0.0f;
    for (int it = 0; it < q.iters; ++it) {
      const int par = it & 1;
      const bool first = it == 0;
      // ---- phase A: beta; d = r + beta d here and on the shell; d.Ad
      wait_flags(eflags, per_episode, first ? q.tag : tag_b(q, it - 1));
      const float rs_new = episode_sum(rr_part, G.g, tree);
      const float beta = first ? 0.0f : (rs > 0.0f ? rs_new / (rs + 1e-30f) : 0.0f);
      rs = rs_new;
      for (int j = 0, sd = s0, sk = k0; j < rows; ++j, sd += sy, sk += bx)
        ds[sd] = first ? rsm[sk] : rsm[sk] + beta * ds[sd];
      {
        const float* rp = rpub + par * set;
        const float* dp = dpub + par * set;
        // z faces: planes z0 - 1 and z0 + bz, a warp a row
        for (int row = warp; row < (zlo + zhi) * yn; row += nw) {
          const bool lo = zlo && row < yn;
          const int yl = lo || !zlo ? row : row - yn;
          const int zz = lo ? z0 - 1 : z0 + bz;
          load_row(ds, (lo ? 0 : (bz + 1) * sz) + (yl + 1) * sy + 1, rp, dp,
                   (long)zz * hw + (y0 + yl) * G.w + x0, xn, first, beta);
        }
        // y faces: rows y0 - 1 and y0 + by
        for (int row = warp; row < (ylo + yhi) * zn; row += nw) {
          const bool lo = ylo && row < zn;
          const int zs = lo || !ylo ? row : row - zn;
          const int yy = lo ? y0 - 1 : y0 + by;
          load_row(ds, (zs + 1) * sz + (lo ? 0 : (by + 1) * sy) + 1, rp, dp,
                   (long)(z0 + zs) * hw + yy * G.w + x0, xn, first, beta);
        }
        // x faces: columns x0 - 1 and x0 + bx, a warp a column of a plane
        for (int col = warp; col < (xlo + xhi) * zn; col += nw) {
          const bool lo = xlo && col < zn;
          const int zs = lo || !xlo ? col : col - zn;
          const int xx = lo ? x0 - 1 : x0 + bx;
          for (int ys = lane; ys < yn; ys += 32) {
            const long gi = (long)(z0 + zs) * hw + (y0 + ys) * G.w + xx;
            const float r = __ldcg(rp + gi);
            ds[(zs + 1) * sz + (ys + 1) * sy + (lo ? 0 : bx + 1)] =
                first ? r : r + beta * __ldcg(dp + gi);
          }
        }
      }
      __syncthreads();
      float acc = 0.0f;
      {
        float cm = ds[s0 - sy], c = ds[s0];
        for (int j = 0, sd = s0; j < rows; ++j, sd += sy) {
          const float cn = ds[sd + sy];
          acc += c * lap_row(ds, sd, sy, sz, cm, c, cn);
          cm = c;
          c = cn;
        }
      }
      acc = warp_sum(acc);
      if (valid && lane == 0) __stcg(dad_part + gidx, acc);
      raise_flag(flag, tag_a(q, it));

      // ---- phase B: alpha; p += alpha d, r -= alpha Ad (Ad formed again from
      // the same d, so the same bits); publish the faces
      wait_flags(eflags, per_episode, tag_a(q, it));
      const float den = episode_sum(dad_part, G.g, tree);
      const float alpha = den > 0.0f ? rs / (den + 1e-30f) : 0.0f;
      const bool last = it == q.iters - 1;
      float* rq = rpub + (par ^ 1) * set;
      float* dq = dpub + (par ^ 1) * set;
      acc = 0.0f;
      if (last) {
        for (int j = 0, sd = s0, sk = k0; j < rows; ++j, sd += sy, sk += bx)
          psm[sk] = psm[sk] + alpha * ds[sd];
        break;
      }
      {
        float cm = ds[s0 - sy], c = ds[s0];
        for (int j = 0, sd = s0, sk = k0; j < rows; ++j, sd += sy, sk += bx) {
          const float cn = ds[sd + sy];
          const float a = lap_row(ds, sd, sy, sz, cm, c, cn);
          psm[sk] = psm[sk] + alpha * c;
          const float r = rsm[sk] - alpha * a;
          rsm[sk] = r;
          acc += r * r;
          if (face >> j & 1u) {
            const int i = cell0 + j * G.w;
            __stcg(rq + i, r);
            __stcg(dq + i, c);
          }
          cm = c;
          c = cn;
        }
      }
      acc = warp_sum(acc);
      if (valid && lane == 0) __stcg(rr_part + gidx, acc);
      raise_flag(flag, tag_b(q, it));
    }
    float* oe = q.out + ebase;
    for (int j = 0; j < rows; ++j) oe[cell0 + j * G.w] = psm[k0 + j * bx];
  }
}

// ------------------------------------------------------------- global mode

__global__ void __launch_bounds__(kMaxThreads, 1) cg_global_kernel(Params q) {
  extern __shared__ float tree[];  // episode_sum's buffers
  const Geo G = q.geo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  // this CTA's granules, the same in every episode
  const int t0 = (int)((long)G.g * blockIdx.x / gridDim.x);
  const int t1 = (int)((long)G.g * (blockIdx.x + 1) / gridDim.x);
  const long set = q.episodes * G.n;
  for (long e = 0; e < q.episodes; ++e) {
    const long eb = e * G.n;
    float* dad_part = q.part + e * G.g;
    float* rr_part = q.part + q.episodes * G.g + e * G.g;
    unsigned* eflags = q.flags + e * gridDim.x;
    unsigned* flag = eflags + blockIdx.x;
    float* __restrict__ R = q.vec + eb;
    float* __restrict__ P = q.out + eb;

    // r = -div - A p0, p = p0
    {
      const float* pe0 = q.p0 + eb;
      for (int t = t0 + warp; t < t1; t += nw) {
        float acc = 0.0f;
        walk_column([&](int k) { return __ldg(pe0 + k); }, column_of(G, t, lane), G,
                    [&](int, int i, float pv, float ap) {
                      const float r = -__ldg(q.div + eb + i) - ap;
                      R[i] = r;
                      P[i] = pv;
                      acc += r * r;
                    });
        acc = warp_sum(acc);
        if (lane == 0) __stcg(rr_part + t, acc);
      }
      raise_flag(flag, q.tag);
    }

    float rs = 0.0f;
    for (int it = 0; it < q.iters; ++it) {
      const int par = it & 1;
      const bool first = it == 0;
      // ---- phase A: d = r + beta d_old, formed at each tap; d.Ad
      wait_flags(eflags, gridDim.x, first ? q.tag : tag_b(q, it - 1));
      const float rs_new = episode_sum(rr_part, G.g, tree);
      const float beta = first ? 0.0f : (rs > 0.0f ? rs_new / (rs + 1e-30f) : 0.0f);
      rs = rs_new;
      float* __restrict__ dold = q.vec + (2 - par) * set + eb;  // not const: no .nc loads
      float* __restrict__ dnew = q.vec + (1 + par) * set + eb;
      auto dval = [&](int m) { return first ? R[m] : R[m] + beta * dold[m]; };
      for (int t = t0 + warp; t < t1; t += nw) {
        float acc = 0.0f;
        walk_column(dval, column_of(G, t, lane), G, [&](int, int i, float dv, float a) {
          dnew[i] = dv;
          acc += dv * a;
        });
        acc = warp_sum(acc);
        if (lane == 0) __stcg(dad_part + t, acc);
      }
      raise_flag(flag, tag_a(q, it));

      // ---- phase B: p += alpha d, r -= alpha Ad, Ad formed again from the
      // stored d (the same bits as phase A's)
      wait_flags(eflags, gridDim.x, tag_a(q, it));
      const float den = episode_sum(dad_part, G.g, tree);
      const float alpha = den > 0.0f ? rs / (den + 1e-30f) : 0.0f;
      const bool last = it == q.iters - 1;
      for (int t = t0 + warp; t < t1; t += nw) {
        const Column c = column_of(G, t, lane);
        if (last) {
          for (int j = 0, i = c.cell0; j < c.rows; ++j, i += G.w) P[i] = P[i] + alpha * dnew[i];
          continue;
        }
        float acc = 0.0f;
        walk_column([&](int k) { return dnew[k]; }, c, G, [&](int, int i, float dv, float a) {
          P[i] = P[i] + alpha * dv;
          const float r = R[i] - alpha * a;
          R[i] = r;
          acc += r * r;
        });
        acc = warp_sum(acc);
        if (lane == 0) __stcg(rr_part + t, acc);
      }
      if (!last) raise_flag(flag, tag_b(q, it));
    }
  }
}

const void* kernel_of(int chip) {
  return chip ? (const void*)cg_chip_kernel : (const void*)cg_global_kernel;
}

cudaError_t allow_smem(int chip) {
  return cudaFuncSetAttribute(kernel_of(chip),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

}  // namespace

// How many CTAs of `threads` threads and `smem` bytes of dynamic shared
// memory one SM holds at once for the mode's kernel (chip 1: on-chip, 0:
// global), into *per_sm, and the card's SM count into *sms. A failed query
// is cleared, so that it does not surface at a later launch.
extern "C" int cg3d_occupancy(int chip, int threads, int smem, int* per_sm,
                              int* sms) {
  int dev = 0;
  cudaError_t e = allow_smem(chip);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel_of(chip),
                                                      threads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// `iters` CG iterations on `episodes` volumes of d x h x w float32 laid out
// one after another: p0, div -> p, in one cooperative launch cut as the
// plan says (ops/cg3d.py, plan_launch): chip 1, `ctas` CTAs of `threads`
// threads, each one brick of bz planes x kgy granule rows x kgx granule
// columns of an episode, a whole number of episodes a wave; chip 0, `ctas`
// CTAs, each walking an even share of every episode's granules, the
// episodes one at a time. `vec` is scratch for 4 * episodes * d * h * w
// floats, `part` for 2 * episodes * granules; `flags` holds a flag a brick
// (chip 1) or a CTA (chip 0) of each episode, each below `tag` (zeroed
// once, then tags that only grow keep them so). `smem` must be the plan's
// dynamic shared memory. p0 and div are only read.
extern "C" int cg3d_launch(const void* p0, const void* div, void* p, void* vec,
                           void* part, void* flags, unsigned tag, long episodes, int d,
                           int h, int w, int iters, int chip, int ctas, int threads,
                           int bz, int kgy, int kgx, int smem, void* stream) {
  if (episodes < 1 || d < 1 || h < 1 || w < 1 || iters < 0 || ctas < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || smem < 0 ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Geo G = make_geo(d, h, w);
  if (G.n > 2147483647L) return (int)cudaErrorInvalidValue;  // 32-bit cell indices
  Params q{(const float*)p0, (const float*)div, (float*)p, (float*)vec,
           (float*)part, (unsigned*)flags, episodes, G, iters, tag,
           bz, kgy, kgx, 0, 0, 0, tree_floats(G.g)};
  long need;
  if (chip) {
    if (bz < 1 || kgy < 1 || kgx < 1 || threads != 32 * bz * kgy * kgx)
      return (int)cudaErrorInvalidValue;
    q.nbz = (d + bz - 1) / bz;
    q.nby = (G.ngy + kgy - 1) / kgy;
    q.nbx = (G.ngx + kgx - 1) / kgx;
    const int per_episode = q.nbz * q.nby * q.nbx;
    if (ctas % per_episode != 0 || ctas / per_episode > episodes)
      return (int)cudaErrorInvalidValue;
    const long by = (long)kgy * G.rows, bx = 32L * kgx;
    need = 4 * ((bz + 2) * (by + 2) * (bx + 2) + 2 * bz * by * bx + q.tree);
  } else {
    if (ctas > G.g) return (int)cudaErrorInvalidValue;
    need = 4L * q.tree;
  }
  if (need != smem) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(chip);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&q};
  e = cudaLaunchKernelExC(&cfg, kernel_of(chip), args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
