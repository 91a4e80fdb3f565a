"""Jacobi pressure kernel (csrc/jacobi.cu) and its plain version.

`jacobi_pressure(p, div, num_iters)` runs `num_iters` zero-Dirichlet Jacobi
sweeps p <- (up + down + left + right - div) / 4 on the interior (0 on the
edge), warm-started from p, over the last two dims of float32 fields (a
leading batch of episodes is allowed): the kernel for CUDA tensors,
`jacobi_pressure_reference` for CPU tensors. Counterpart of the JAX
package's `jacobi_pressure_pallas` in both its whole-grid and its tiled
forms; the kernel adds in the plain version's order and is built without
FMA contraction, so the two agree to the bit.

The kernel has two modes, chosen by `plan_launch` (pure Python) from the
shape and the card's count of the clusters that fit at once: "cluster"
keeps each episode in one thread-block cluster's shared memory for all the
sweeps (one launch per call); "band" covers grids whose stripes do not fit
it (1024^2 and up) with bands of rows padded by halo rows, one cluster a
band, the JAX kernel's tiled stripes (one launch per pass of up to
MAX_DEPTH sweeps). `launch_plan` is the plan a CUDA call takes.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable

import torch

from . import _build
from .stencil import shift

Tensor = torch.Tensor

SOURCE = "jacobi.cu"
FLAGS = ("-fmad=false",)
MAX_DEPTH = 32  # sweeps of one band-mode pass (its halo rows); more take further passes

SMEM_MAX = 232_448  # dynamic shared memory one CTA can have on an H100
SMS = 132           # an H100 SXM's SMs (a call on the card passes the card's count)
MAX_CLUSTER = 16    # CTAs per cluster (the non-portable size)
MAX_THREADS = 1024  # threads per CTA (the cluster kernel's launch bound)
ROW_THREADS = (32, 64, 128)  # threads along a row, one cell each: one warp to four
STRIPS = (1, 2, 4)  # rows of a thread's register strip, four cells each
BAR_BYTES = 16      # the two halo mbarriers
# threads a CTA that the plan prefers: at [1,256^2] x 20 sweeps, strips of
# 2 rows (512 threads) took 0.0163 ms of device time against 0.0178 for 1
# row (1024) and 0.0196 for 4 (256) (H100 80GB HBM3 at 700 W,
# scripts/stencil_probe.py --plans)
BEST_THREADS = 512

# read by chip_smoke.py: kernel launches (1 per call, or 1 per band pass),
# and the cells the kernel swept and the grid's cells, each times the sweeps
LAUNCHES = 0
SWEPT_CELLS = 0
GRID_CELLS = 0


def jacobi_pressure_reference(p: Tensor, div: Tensor, num_iters: int) -> Tensor:
    """Plain version: each sweep (((up + down) + left) + right - div) * 0.25
    with zero taps beyond the grid, then 0 on the edge cells."""
    h, w = div.shape[-2], div.shape[-1]
    row = torch.arange(h, device=p.device)[:, None]
    col = torch.arange(w, device=p.device)[None, :]
    interior = (row > 0) & (row < h - 1) & (col > 0) & (col < w - 1)
    for _ in range(num_iters):
        val = 0.25 * (
            shift(p, -1, 0, "zero") + shift(p, 1, 0, "zero")
            + shift(p, 0, -1, "zero") + shift(p, 0, 1, "zero") - div
        )
        p = torch.where(interior, val, torch.zeros_like(val))
    return p


# ---------------------------------------------------------------- launch plan


def _round4(floats: int) -> int:
    """Floats rounded up so that the next plane starts 16-byte aligned."""
    return -(-floats // 4) * 4


def stripe_bytes(rows: int, w: int) -> int:
    """Dynamic shared memory of one CTA (either mode): the two halo
    mbarriers, two planes of p of rows + 2 rows (a halo row above and
    below) and the stripe's rows of div, each w wide."""
    return BAR_BYTES + 4 * (2 * _round4((rows + 2) * w) + _round4(rows * w))


def pass_depth(num_iters: int) -> int:
    """Sweeps of each band-mode pass of a call of `num_iters` sweeps (the
    band's halo rows): the passes as few as MAX_DEPTH allows, and as even
    as they can be (45 sweeps: 23 + 22)."""
    passes = max(1, -(-num_iters // MAX_DEPTH))
    return -(-num_iters // passes)


@dataclass(frozen=True)
class LaunchPlan:
    """How one call of the Jacobi kernel is cut. `cluster` CTAs per
    cluster, each owning `rows` rows of the rows it sweeps (the last CTA
    what is left); `clusters` clusters launched, each taking its items
    (episodes, or bands of episodes) in turn; `bx` x `by` threads per CTA;
    `smem_bytes` of dynamic shared memory per CTA; `strip` rows of a
    thread's register strip (one quad column of four cells a thread, w a
    multiple of 4), or 0 for one cell a thread with div in shared memory.
    "cluster" mode: one cluster per episode, the whole grid its stripes
    (the band fields 0). "band" mode: each episode cut into `bands` bands of
    `band` rows (the last what is left), each swept as `span` = cluster *
    rows rows that pad it by `halo` rows on each cut side (shifted inside
    the grid at its edges); the items in `waves` rounds of the clusters;
    up to `halo` sweeps a launch."""

    mode: str
    cluster: int = 0
    clusters: int = 0
    rows: int = 0
    bx: int = 0
    by: int = 0
    smem_bytes: int = 0
    strip: int = 0
    span: int = 0
    band: int = 0
    halo: int = 0
    bands: int = 0
    waves: int = 0
    swept: float = 1.0  # cells swept per cell of the grid (1 in the cluster mode)

    @property
    def threads(self) -> int:
        return self.bx * self.by

    @property
    def ctas(self) -> int:
        return self.cluster * self.clusters

    def launches(self, num_iters: int) -> int:
        """Kernel launches of one call of `num_iters` sweeps."""
        if self.mode == "cluster" or num_iters == 0:
            return 1
        return -(-num_iters // self.halo)

    def describe(self) -> str:
        cells = (f"strips of {self.strip} rows x 4 cells a thread" if self.strip else
                 "one cell a thread")
        shape = (f"cluster {self.cluster} x {self.clusters} clusters = {self.ctas} CTAs of "
                 f"{self.bx}x{self.by} threads ({cells}), {self.rows} rows per CTA, "
                 f"{self.smem_bytes} B shared memory per CTA")
        if self.mode == "cluster":
            return f"cluster mode, {shape}"
        return (f"band mode, {shape}; bands of {self.band} owned rows swept as {self.span} "
                f"(halo {self.halo}, up to {self.halo} sweeps a launch), {self.bands} bands "
                f"an episode in {self.waves} waves, {self.swept:.3f} cells swept per owned "
                f"cell")


# (cluster, bx, by, smem_bytes, strip) -> clusters that fit the card at once
ActiveCount = Callable[[int, int, int, int, int], int]


def row_threads(rows: int, by_max: int):
    """Thread rows per CTA to try: each a count that splits the stripe's
    rows into equal passes, from the most threads to one row (at most
    by_max). Shared with the fused kernels' plan."""
    out, passes = [], -(-rows // by_max)
    while True:
        by = -(-rows // passes)
        if not out or by < out[-1]:
            out.append(by)
        if by == 1:
            return out
        passes *= 2


def plan_candidates(episodes: int, h: int, w: int, max_active_clusters: ActiveCount,
                    smem_max: int = SMEM_MAX):
    """Every cluster-mode plan the card can launch: each cluster size that
    cuts the grid into its own stripes of at most `smem_max` bytes, with as
    many clusters as fit at once (`max_active_clusters`), at most one per
    episode. Where w is a multiple of 4, threads of register strips: a
    thread a quad column (bx = w / 4 rounded up to a warp) and each strip
    depth of STRIPS that keeps the CTA within MAX_THREADS. Elsewhere one
    cell a thread: each row width of ROW_THREADS up to the first that
    covers a row, and each count of thread rows."""
    for cluster in range(MAX_CLUSTER, 0, -1):
        rows = -(-h // cluster)
        if -(-h // rows) != cluster:  # a smaller cluster cuts the same stripes
            continue
        smem = stripe_bytes(rows, w)
        if smem > smem_max:
            continue
        if w % 4 == 0:
            bx = -(-w // 128) * 32
            shapes = []
            for strip in STRIPS:
                by = -(-rows // strip)
                if bx * by <= MAX_THREADS and all(by != other for _, other, _ in shapes):
                    shapes.append((bx, by, strip))
        else:
            shapes = [(bx, by, 0) for bx in ROW_THREADS if bx == 32 or bx // 2 < w
                      for by in row_threads(rows, MAX_THREADS // bx)]
        for bx, by, strip in shapes:
            active = max_active_clusters(cluster, bx, by, smem, strip)
            if active < 1:
                continue
            yield LaunchPlan(mode="cluster", cluster=cluster,
                             clusters=min(episodes, active), rows=rows, bx=bx, by=by,
                             smem_bytes=smem, strip=strip)


def _max_rows(w: int, smem_max: int) -> int:
    """The most rows a CTA's stripe can have within `smem_max` bytes."""
    rows = 0
    while stripe_bytes(rows + 1, w) <= smem_max:
        rows += 1
    return rows


def band_candidates(episodes: int, h: int, w: int, num_iters: int,
                    max_active_clusters: ActiveCount, smem_max: int = SMEM_MAX):
    """Every band-mode plan the card can launch for calls of `num_iters`
    sweeps: each cluster size and thread shape whose `span` = cluster *
    rows rows (at most `smem_max` bytes a CTA, fewer than h) leave at least
    one owned row inside a halo of `pass_depth(num_iters)` rows on each
    side, with as many clusters as fit at once (`max_active_clusters`), at
    most one per item (episode and band). Where w is a multiple of 4,
    register strips (a quad column a thread, each strip depth of STRIPS and
    each count of thread rows within MAX_THREADS); elsewhere one cell a
    thread, each row width of ROW_THREADS and each count of thread rows, at
    the most rows that fit."""
    halo = pass_depth(num_iters)
    top = _max_rows(w, smem_max)
    for cluster in range(MAX_CLUSTER, 0, -1):
        if w % 4 == 0:
            bx = -(-w // 128) * 32
            shapes = [(bx, by, strip, min(by * strip, top)) for strip in STRIPS
                      for by in range(1, MAX_THREADS // bx + 1)
                      if (by - 1) * strip < top]
        else:
            shapes = [(bx, by, 0, top) for bx in ROW_THREADS if bx == 32 or bx // 2 < w
                      for by in row_threads(top, MAX_THREADS // bx)] if top else []
        for bx, by, strip, rows in shapes:
            span = cluster * rows
            own = span - 2 * halo
            if span >= h or own < 1:
                continue
            smem = stripe_bytes(rows, w)
            active = max_active_clusters(cluster, bx, by, smem, strip)
            if active < 1:
                continue
            bands = -(-h // own)
            items = episodes * bands
            clusters = min(items, active)
            yield LaunchPlan(mode="band", cluster=cluster, clusters=clusters, rows=rows,
                             bx=bx, by=by, smem_bytes=smem, strip=strip, span=span,
                             band=own, halo=halo, bands=bands, waves=-(-items // clusters),
                             swept=bands * span / h)


def plan_launch(episodes: int, h: int, w: int, max_active_clusters: ActiveCount,
                num_iters: int = 20, smem_max: int = SMEM_MAX,
                sms: int = SMS) -> LaunchPlan:
    """The launch plan of the Jacobi kernel for `episodes` planes of an
    h x w grid and calls of `num_iters` sweeps.

    `max_active_clusters(cluster, bx, by, smem_bytes, strip)` says how many
    clusters of that shape fit the card at once (on the card,
    cudaOccupancyMaxActiveClusters). The cluster mode is taken wherever
    some cluster size gives stripes of at most `smem_max` bytes a CTA that
    the card can run. Among the cluster candidates (`plan_candidates`), the plan
    takes the fewest waves of clusters over the episodes, then the largest
    cluster, then the count of threads nearest BEST_THREADS (then the fewer
    threads, then the narrower rows of threads); at most as many clusters
    are launched as fit at once, each taking episodes in turn. Otherwise
    the band mode (`band_candidates`): a wave of CTAs that fits the card's
    `sms` SMs one CTA each, then the fewest waves, then the fewest rows a
    CTA (a sweep waits for the SM with the most rows to sweep), then the
    largest cluster, then the threads as above. At [1,1024^2] x 20 on an
    H100 80GB HBM3 at 700 W, 16 x 7 CTAs of 12 rows took 0.0334 ms a call
    of a CUDA graph against 0.0413 for 16 x 5 CTAs of 16 rows and 0.0722 for
    16 x 21 CTAs of 4 rows, three a SM (scripts/stencil_probe.py --plans)."""
    if episodes < 1 or h < 2 or w < 2:
        raise ValueError(f"plan_launch: need episodes >= 1 and a grid of at least 2x2, "
                         f"got {episodes} of {h}x{w}")
    if num_iters < 0:
        raise ValueError("plan_launch: num_iters must be >= 0")
    plans = list(plan_candidates(episodes, h, w, max_active_clusters, smem_max))
    if plans:
        return min(plans, key=lambda pl: (-(-episodes // pl.clusters), -pl.cluster,
                                          abs(pl.threads - BEST_THREADS), pl.threads, pl.bx))
    plans = list(band_candidates(episodes, h, w, num_iters, max_active_clusters, smem_max))
    if not plans:
        raise ValueError(f"plan_launch: no cluster of the card sweeps a {h}x{w} grid")
    return min(plans, key=lambda pl: (pl.ctas > sms, pl.waves, pl.rows, -pl.cluster,
                                      abs(pl.threads - BEST_THREADS), pl.threads, pl.bx))


def band_rows(plan: LaunchPlan, h: int):
    """(span start, owned start, owned end) of each band of an h-row grid,
    as the kernel places them: the owned rows padded by `halo` rows, the
    span shifted inside the grid at its edges. The cluster mode is one band
    of the whole grid."""
    if plan.mode == "cluster":
        return [(0, 0, h)]
    return [(min(max(o0 - plan.halo, 0), h - plan.span), o0, min(o0 + plan.band, h))
            for o0 in range(0, h, plan.band)]


def jacobi_pressure_bands(p: Tensor, div: Tensor, num_iters: int,
                          plan: LaunchPlan) -> Tensor:
    """A plain model of the band mode's decomposition: each pass of up to
    `halo` sweeps runs the plain sweep on each band's span alone (the rows
    just outside it held at their values of the pass's start) and keeps
    only the band's owned rows. Bit-equal to `jacobi_pressure_reference`
    wherever the halo covers the pass (the tests hold it so)."""
    h = p.shape[-2]
    passes = plan.launches(num_iters)
    left = num_iters
    for _ in range(passes):
        sweeps = min(left, plan.halo) if plan.mode == "band" else left
        out = torch.empty_like(p)
        for s0, o0, o1 in band_rows(plan, h):
            lo, hi = max(s0 - 1, 0), min(s0 + (plan.span or h) + 1, h)
            sub = _sweep_rows(p[..., lo:hi, :], div[..., lo:hi, :], sweeps, lo, h, s0 - lo,
                              hi - (s0 + (plan.span or h)))
            out[..., o0:o1, :] = sub[..., o0 - lo:o1 - lo, :]
        p, left = out, left - sweeps
    return p


def _sweep_rows(p: Tensor, div: Tensor, sweeps: int, first: int, h: int, fixed_top: int,
                fixed_bottom: int) -> Tensor:
    """`sweeps` plain sweeps of the rows [first, first + p.shape[-2]) of an
    h-row grid with zero taps past those rows, the interior taken in the
    grid's coordinates; the first `fixed_top` and last `fixed_bottom` rows
    (a span's outer halo) keep their values."""
    n, w = p.shape[-2], p.shape[-1]
    row = torch.arange(first, first + n, device=p.device)[:, None]
    col = torch.arange(w, device=p.device)[None, :]
    interior = (row > 0) & (row < h - 1) & (col > 0) & (col < w - 1)
    swept = (row >= first + fixed_top) & (row < first + n - fixed_bottom)
    for _ in range(sweeps):
        val = 0.25 * (
            shift(p, -1, 0, "zero") + shift(p, 1, 0, "zero")
            + shift(p, 0, -1, "zero") + shift(p, 0, 1, "zero") - div
        )
        p = torch.where(swept, torch.where(interior, val, torch.zeros_like(val)), p)
    return p


# ---------------------------------------------------------------- the kernel


def _lib():
    return _build.load(SOURCE, FLAGS, {
        "jacobi_cluster_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
        + [ctypes.c_void_p],
        "jacobi_max_active_clusters": [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)],
    })


def card_active_clusters(index: int) -> ActiveCount:
    """`max_active_clusters` for `plan_launch` on card `index`: the cluster
    kernel's cudaOccupancyMaxActiveClusters (the C entry
    jacobi_max_active_clusters), each shape asked once."""
    lib = _lib()
    queried = {}

    def count(cluster, bx, by, smem_bytes, strip):
        q = (cluster, bx, by, smem_bytes, strip)
        if q not in queried:
            out = ctypes.c_int(0)
            with torch.cuda.device(index):
                rc = lib.jacobi_max_active_clusters(strip, cluster, bx, by, smem_bytes,
                                                    ctypes.byref(out))
            queried[q] = out.value if rc == 0 else 0
        return queried[q]

    return count


_PLANS = {}  # (device index, episodes, h, w, pass depth) -> LaunchPlan


def launch_plan(episodes: int, h: int, w: int, device=None,
                num_iters: int = 20) -> LaunchPlan:
    """The plan a CUDA call of `jacobi_pressure` of `num_iters` sweeps takes
    on `device` (default: the current card), with the card's count of the
    clusters that fit at once."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, episodes, h, w, pass_depth(num_iters))
    plan = _PLANS.get(key)
    if plan is None:
        plan = plan_launch(episodes, h, w, card_active_clusters(index), num_iters,
                           sms=torch.cuda.get_device_properties(index).multi_processor_count)
        _PLANS[key] = plan
    return plan


def _launch(p: Tensor, div: Tensor, num_iters: int, plan: LaunchPlan) -> Tensor:
    """Runs the kernel as `plan` cuts it on checked CUDA tensors; returns
    the new p."""
    h, w = p.shape[-2], p.shape[-1]
    episodes = p.numel() // (h * w)
    if plan.mode == "band" and num_iters > 0 and plan.halo == 0:
        raise ValueError("jacobi_pressure: a band plan of 0 halo rows runs no sweep")
    out = torch.empty_like(p)
    # passes ping-pong between out and scratch so that the last lands in out
    scratch = torch.empty_like(p) if plan.launches(num_iters) > 1 else out
    span, own = (plan.span, plan.band) if plan.mode == "band" else (h, h)
    rc = _lib().jacobi_cluster_launch(
        p.data_ptr(), div.data_ptr(), out.data_ptr(), scratch.data_ptr(), episodes, h, w,
        num_iters, plan.cluster, plan.clusters, plan.rows, plan.bx, plan.by,
        plan.smem_bytes, plan.strip, span, own, plan.halo,
        torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jacobi_pressure kernel launch failed: cudaError {rc} "
                           f"({plan.describe()})")
    return out


def jacobi_pressure(p: Tensor, div: Tensor, num_iters: int = 20) -> Tensor:
    """`num_iters` Jacobi sweeps of float32 p, div [..., H, W] (H, W >= 2).
    CUDA tensors launch the kernel as `launch_plan` cuts it (one launch in
    the cluster mode; one a pass of up to `pass_depth(num_iters)` sweeps in
    the band mode); CPU tensors take `jacobi_pressure_reference`. The
    inputs are not modified."""
    global LAUNCHES, SWEPT_CELLS, GRID_CELLS
    for name, t in (("p", p), ("div", div)):
        if t.dtype != torch.float32:
            raise TypeError(f"jacobi_pressure: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"jacobi_pressure: {name} must be contiguous")
    if p.shape != div.shape or p.dim() < 2:
        raise ValueError(f"jacobi_pressure: p {tuple(p.shape)} and div "
                         f"{tuple(div.shape)} must be one [..., H, W] shape")
    if p.device != div.device:
        raise ValueError("jacobi_pressure: p and div must be on one device")
    h, w = p.shape[-2], p.shape[-1]
    if h < 2 or w < 2:
        raise ValueError("jacobi_pressure: grid must be at least 2x2")
    if num_iters < 0:
        raise ValueError("jacobi_pressure: num_iters must be >= 0")
    if p.device.type == "cpu":
        return jacobi_pressure_reference(p, div, num_iters)
    if p.device.type != "cuda":
        raise ValueError(f"jacobi_pressure: unsupported device {p.device}")
    episodes = p.numel() // (h * w)
    if episodes == 0:
        raise ValueError("jacobi_pressure: empty batch")
    plan = launch_plan(episodes, h, w, device=p.device, num_iters=num_iters)
    out = _launch(p, div, num_iters, plan)
    LAUNCHES += plan.launches(num_iters)
    rows = plan.bands * plan.span if plan.mode == "band" else h
    SWEPT_CELLS += episodes * rows * w * num_iters
    GRID_CELLS += episodes * h * w * num_iters
    return out
