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
sweeps (one launch per call), "tiled" covers grids whose stripes do not fit
it (1024^2 and up) with overlapping-halo tiles (one launch per MAX_HALO
sweeps). `launch_plan` is the plan a CUDA call takes.
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
MAX_HALO = 32  # sweeps one tiled launch runs (csrc/jacobi.cu); more take further launches
TILE = 32      # owned cells per block of the tiled mode: TILE x TILE

SMEM_MAX = 232_448  # dynamic shared memory one CTA can have on an H100
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

LAUNCHES = 0  # kernel launches (read by chip_smoke.py): 1 per call, or 1 per tiled pass


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
    """Dynamic shared memory of one CTA in the cluster mode: the two halo
    mbarriers, two planes of p of rows + 2 rows (a halo row above and
    below) and the stripe's rows of div, each w wide."""
    return BAR_BYTES + 4 * (2 * _round4((rows + 2) * w) + _round4(rows * w))


@dataclass(frozen=True)
class LaunchPlan:
    """How one call of the Jacobi kernel is cut. "cluster" mode: `cluster`
    CTAs per episode, each owning `rows` rows of the grid (the last CTA
    what is left); `clusters` clusters launched, each taking episodes in
    turn; `bx` x `by` threads per CTA; `smem_bytes` of dynamic shared
    memory per CTA; `strip` rows of a thread's register strip (one quad
    column of four cells a thread, w a multiple of 4), or 0 for one cell a
    thread with div in shared memory. "tiled" mode: TILE x TILE tiles of BX x BY = 32 x 8
    threads, one block per tile and episode, up to MAX_HALO sweeps per
    launch (the other fields 0)."""

    mode: str
    cluster: int = 0
    clusters: int = 0
    rows: int = 0
    bx: int = 0
    by: int = 0
    smem_bytes: int = 0
    strip: int = 0

    @property
    def threads(self) -> int:
        return self.bx * self.by

    @property
    def ctas(self) -> int:
        return self.cluster * self.clusters

    def launches(self, num_iters: int) -> int:
        """Kernel launches of one call of `num_iters` sweeps."""
        if self.mode == "cluster":
            return 1
        return max(1, -(-num_iters // MAX_HALO))

    def describe(self) -> str:
        if self.mode == "tiled":
            return (f"tiled mode, {TILE}x{TILE} tiles of 32x8 threads, halo of up to "
                    f"{MAX_HALO} sweeps per launch")
        cells = (f"strips of {self.strip} rows x 4 cells a thread" if self.strip else
                 "one cell a thread")
        return (f"cluster mode, cluster {self.cluster} x {self.clusters} clusters = "
                f"{self.ctas} CTAs of {self.bx}x{self.by} threads ({cells}), {self.rows} "
                f"rows per CTA, {self.smem_bytes} B shared memory per CTA")


TILED = LaunchPlan(mode="tiled")

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


def plan_candidates(episodes: int, h: int, w: int, max_active_clusters: ActiveCount):
    """Every cluster-mode plan the card can launch: each cluster size that
    cuts the grid into its own stripes of at most SMEM_MAX bytes, with as
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
        if smem > SMEM_MAX:
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


def plan_launch(episodes: int, h: int, w: int,
                max_active_clusters: ActiveCount) -> LaunchPlan:
    """The launch plan of the Jacobi kernel for `episodes` planes of an
    h x w grid.

    `max_active_clusters(cluster, bx, by, smem_bytes, strip)` says how many
    clusters of that shape fit the card at once (on the card,
    cudaOccupancyMaxActiveClusters). The cluster mode is taken wherever
    some cluster size gives stripes of at most SMEM_MAX bytes that the card
    can run; otherwise the tiled mode. Among the cluster candidates
    (`plan_candidates`), the plan takes the fewest waves of clusters over
    the episodes, then the largest cluster, then the count of threads
    nearest BEST_THREADS (then the fewer threads, then the narrower rows of
    threads); at most as many clusters are launched as fit at once, each
    taking episodes in turn."""
    if episodes < 1 or h < 2 or w < 2:
        raise ValueError(f"plan_launch: need episodes >= 1 and a grid of at least 2x2, "
                         f"got {episodes} of {h}x{w}")
    plans = list(plan_candidates(episodes, h, w, max_active_clusters))
    if not plans:
        return TILED
    return min(plans, key=lambda pl: (-(-episodes // pl.clusters), -pl.cluster,
                                      abs(pl.threads - BEST_THREADS), pl.threads, pl.bx))


# ---------------------------------------------------------------- the kernel


def _lib():
    return _build.load(SOURCE, FLAGS, {
        "jacobi_launch": [ctypes.c_void_p] * 4 + [ctypes.c_long]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "jacobi_cluster_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
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


_PLANS = {}  # (device index, episodes, h, w) -> LaunchPlan


def launch_plan(episodes: int, h: int, w: int, device=None) -> LaunchPlan:
    """The plan a CUDA call of `jacobi_pressure` takes on `device` (default:
    the current card), with the card's count of the clusters that fit at
    once."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, episodes, h, w)
    plan = _PLANS.get(key)
    if plan is None:
        plan = plan_launch(episodes, h, w, card_active_clusters(index))
        _PLANS[key] = plan
    return plan


def _launch(p: Tensor, div: Tensor, num_iters: int, plan: LaunchPlan) -> Tensor:
    """Runs the kernel as `plan` cuts it on checked CUDA tensors; returns
    the new p."""
    h, w = p.shape[-2], p.shape[-1]
    episodes = p.numel() // (h * w)
    out = torch.empty_like(p)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    if plan.mode == "cluster":
        rc = _lib().jacobi_cluster_launch(
            p.data_ptr(), div.data_ptr(), out.data_ptr(), episodes, h, w, num_iters,
            plan.cluster, plan.clusters, plan.rows, plan.bx, plan.by, plan.smem_bytes,
            plan.strip, stream)
    else:
        # passes ping-pong between out and scratch so that the last lands in out
        scratch = torch.empty_like(p) if plan.launches(num_iters) > 1 else out
        rc = _lib().jacobi_launch(p.data_ptr(), div.data_ptr(), out.data_ptr(),
                                  scratch.data_ptr(), episodes, h, w, num_iters, stream)
    if rc != 0:
        raise RuntimeError(f"jacobi_pressure kernel launch failed: cudaError {rc} "
                           f"({plan.describe()})")
    return out


def jacobi_pressure(p: Tensor, div: Tensor, num_iters: int = 20) -> Tensor:
    """`num_iters` Jacobi sweeps of float32 p, div [..., H, W] (H, W >= 2).
    CUDA tensors launch the kernel as `launch_plan` cuts it (one launch in
    the cluster mode; ceil(num_iters / MAX_HALO) in the tiled mode); CPU
    tensors take `jacobi_pressure_reference`. The inputs are not
    modified."""
    global LAUNCHES
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
    plan = launch_plan(episodes, h, w, device=p.device)
    out = _launch(p, div, num_iters, plan)
    LAUNCHES += plan.launches(num_iters)
    return out
