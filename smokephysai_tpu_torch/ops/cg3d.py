"""Conjugate-gradient pressure kernel of the 3D solver (csrc/cg3d.cu) and its
plain version.

`cg_pressure(p0, div, num_iters)` runs `num_iters` iterations of matrix-free
CG on -Lap(p) = -div with the zero-Dirichlet 7-point Laplacian, warm-started
from p0, over the last three dims of float32 volumes (a leading batch of
episodes is allowed, each with its own alpha and beta): one cooperative
launch of the kernel for CUDA tensors, `cg_pressure_reference` for CPU
tensors. Counterpart of the JAX package's `cg_pressure_pallas`; the kernel
reduces its dot products in a fixed order of its own, so it matches the
plain version to float32 rounding, and itself (and each episode's solve
alone, and every launch plan) to the bit.

The kernel sums over reduction granules, a cut of each episode that depends
on (D, H, W) alone (`Granules`): min(16, H) rows of 32 columns in one
plane. `plan_launch` (pure Python) cuts a call into CTAs of whole
granules: the "chip" mode gives each CTA one brick of granules whose d, r
and p stay in its shared memory for the whole solve, where one episode's
bricks fit the card at once (a batch takes waves of episodes); the
"global" mode keeps the vectors in global scratch, every CTA taking the
episodes one at a time. `launch_plan` is the plan a CUDA call takes, with
the card's own occupancy. Each CTA raises its flag of an episode to a
phase's tag when its partials of the phase are stored (`_flags`); waiting
for an episode's flags is the kernel's barrier. The tags are launch
arguments from a host counter, so a call cannot be captured into a CUDA
graph (a replay would reuse spent tags): `cg_pressure` refuses capture.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import torch

from . import _build

Tensor = torch.Tensor

SOURCE = "cg3d.cu"
# no FMA contraction: the stencil and the updates round as the plain
# version's separate PyTorch operations do
FLAGS = ("-fmad=false",)

LAUNCHES = 0  # solves run by the kernel (read by chip_smoke.py)


def launches_per_solve(num_iters: int) -> int:
    """Kernel launches one solve makes on the stream: one cooperative launch
    for the residual and all the iterations (csrc/cg3d.cu)."""
    return 1


def laplacian_dirichlet(p: Tensor) -> Tensor:
    """7-point Laplacian over the last three dims with p = 0 beyond the
    volume: (((((z-1 + z+1) + y-1) + y+1) + x-1) + x+1) - 6 p."""
    z = torch.nn.functional.pad(p, (1, 1, 1, 1, 1, 1))
    return (
        z[..., :-2, 1:-1, 1:-1]
        + z[..., 2:, 1:-1, 1:-1]
        + z[..., 1:-1, :-2, 1:-1]
        + z[..., 1:-1, 2:, 1:-1]
        + z[..., 1:-1, 1:-1, :-2]
        + z[..., 1:-1, 1:-1, 2:]
        - 6.0 * p
    )


def cg_pressure_reference(p0: Tensor, div: Tensor, num_iters: int = 30) -> Tensor:
    """Plain version (the JAX package's `solver3d.cg_pressure`): CG on
    A p = -div with A = -Lap, alpha = rs / (denom + 1e-30) where denom > 0
    (else 0), beta = rs' / (rs + 1e-30) where rs > 0 (else 0); the sums and
    both guards are per episode of a leading batch."""
    dims = (-3, -2, -1)

    def A(x):
        return -laplacian_dirichlet(x)

    def total(x):
        return torch.sum(x, dim=dims, keepdim=True)

    r = -div - A(p0)
    d = r
    rs = total(r * r)
    p = p0
    zero = torch.zeros((), dtype=p0.dtype, device=p0.device)
    for _ in range(num_iters):
        ad = A(d)
        denom = total(d * ad)
        alpha = torch.where(denom > 0, rs / (denom + 1e-30), zero)
        p = p + alpha * d
        r = r - alpha * ad
        rs_new = total(r * r)
        beta = torch.where(rs > 0, rs_new / (rs + 1e-30), zero)
        d = r + beta * d
        rs = rs_new
    return p


# ---------------------------------------------------------------- launch plan

GRANULE_COLS = 32   # a warp's lanes: one column each
GRANULE_ROWS = 16   # rows of a granule (fewer where the volume has fewer)
MAX_THREADS = 1024  # threads per CTA (the kernels' launch bound)
MAX_GRANULES = MAX_THREADS // 32  # granules per on-chip brick: one a warp
MIN_WARPS = 8  # the per-SM load below which the plan looks at halos only
SMEM_MAX = 232_448  # dynamic shared memory one CTA can have on an H100
SECTOR_FLOATS = 8   # floats of a 32-byte memory sector
MAX_INT = 2 ** 31 - 1  # the kernel indexes an episode's cells with 32-bit ints


@dataclass(frozen=True)
class Granules:
    """The reduction granules of a d x h x w episode: `rows` rows of 32
    columns in one plane, `ngy` x `ngx` of them a plane, numbered (z, y, x)
    row-major. A function of (d, h, w) alone, so every plan sums the same
    granules in the same order."""

    d: int
    h: int
    w: int

    @property
    def rows(self) -> int:
        return min(GRANULE_ROWS, self.h)

    @property
    def ngy(self) -> int:
        return -(-self.h // self.rows)

    @property
    def ngx(self) -> int:
        return -(-self.w // GRANULE_COLS)

    @property
    def count(self) -> int:
        return self.d * self.ngy * self.ngx

    def box(self, index: int) -> Tuple[int, int, int, int, int]:
        """(z, y0, y1, x0, x1): the cells of granule `index`, plane z, rows
        y0:y1 and columns x0:x1."""
        z, rest = divmod(index, self.ngy * self.ngx)
        gy, gx = divmod(rest, self.ngx)
        y0, x0 = gy * self.rows, gx * GRANULE_COLS
        return z, y0, min(y0 + self.rows, self.h), x0, min(x0 + GRANULE_COLS, self.w)


def tree_floats(n: int) -> int:
    """Floats of the kernel's buffers for summing n partials (its first two
    levels of chunk sums, and the total)."""
    n1 = -(-n // 32)
    return n1 + -(-n1 // 32) + 1


@dataclass(frozen=True)
class CGPlan:
    """How one call of the CG kernel is cut. "chip" mode: `ctas` CTAs, each
    one brick of `brick` = (planes, granule rows, granule columns) of an
    episode, 32 threads a granule, taking the episodes in `waves` (a whole
    number of episodes a wave); "global" mode: `ctas` CTAs of `threads`
    threads, each walking an even share of every episode's granules, the
    episodes one at a time (`brick` (0, 0, 0), one wave). `smem_bytes` of dynamic shared memory
    per CTA."""

    mode: str
    ctas: int
    threads: int
    brick: Tuple[int, int, int]
    smem_bytes: int
    waves: int = 1

    @property
    def args(self):
        """The launcher's plan arguments."""
        return (int(self.mode == "chip"), self.ctas, self.threads, *self.brick,
                self.smem_bytes)

    def describe(self) -> str:
        if self.mode == "chip":
            bz, kgy, kgx = self.brick
            return (f"chip mode, {self.ctas} CTAs of {self.threads} threads, a brick of "
                    f"{bz} planes x {kgy} x {kgx} granules each, {self.smem_bytes} B "
                    f"shared memory per CTA, {self.waves} wave{'s' * (self.waves > 1)}")
        return (f"global mode, {self.ctas} CTAs of {self.threads} threads, "
                f"{self.smem_bytes} B shared memory per CTA")


# (mode, threads, smem_bytes) -> CTAs of that shape one SM holds at once
CTAsPerSM = Callable[[str, int, int], int]


def brick_dims(gr: Granules, brick) -> Tuple[int, int, int]:
    """Cells of a brick along z, y, x."""
    bz, kgy, kgx = brick
    return bz, kgy * gr.rows, kgx * GRANULE_COLS


def bricks(gr: Granules, brick) -> Tuple[int, int, int]:
    """Bricks of an episode along z, y, x."""
    bz, kgy, kgx = brick
    return -(-gr.d // bz), -(-gr.ngy // kgy), -(-gr.ngx // kgx)


def chip_smem_bytes(gr: Granules, brick) -> int:
    """Shared memory of an on-chip CTA: d with a one-cell shell, r, p and
    the sums' buffers."""
    bz, by, bx = brick_dims(gr, brick)
    return 4 * ((bz + 2) * (by + 2) * (bx + 2) + 2 * bz * by * bx + tree_floats(gr.count))


def halo_sectors(gr: Granules, brick) -> int:
    """32-byte sectors of one vector that an inner brick publishes for its
    neighbours (and reads of theirs), on the faces of the directions that
    the cut splits: a row of a z or y face is contiguous, a cell of an x
    face a sector of its own."""
    bz, by, bx = brick_dims(gr, brick)
    nbz, nby, nbx = bricks(gr, brick)
    row = -(-bx // SECTOR_FLOATS)
    return ((nbz > 1) * 2 * by * row + (nby > 1) * 2 * bz * row
            + (nbx > 1) * 2 * bz * by)


def global_smem_bytes(gr: Granules) -> int:
    """Shared memory of a global-mode CTA: the sums' buffers."""
    return 4 * tree_floats(gr.count)


def _cuts(n: int, most: int):
    """Sizes of a cut of n units into equal blocks of at most `most`, each
    the smallest size that gives its count of blocks."""
    return sorted({-(-n // k) for k in range(1, n + 1) if -(-n // k) <= most})


def plan_candidates(episodes: int, d: int, h: int, w: int, sms: int,
                    ctas_per_sm: CTAsPerSM) -> Iterator[CGPlan]:
    """Every on-chip plan the card can hold at once: each brick of whole
    granules (at most MAX_GRANULES, one a warp) whose shared memory fits
    SMEM_MAX, with at least one episode's bricks resident together (at
    most `ctas_per_sm` x `sms` CTAs); the episodes in as few waves as fit,
    spread evenly over them."""
    gr = Granules(d, h, w)
    for bz in _cuts(d, MAX_GRANULES):
        for kgy in _cuts(gr.ngy, MAX_GRANULES // bz):
            for kgx in _cuts(gr.ngx, MAX_GRANULES // (bz * kgy)):
                brick = (bz, kgy, kgx)
                smem = chip_smem_bytes(gr, brick)
                if smem > SMEM_MAX:
                    continue
                per_episode = math.prod(bricks(gr, brick))
                threads = 32 * bz * kgy * kgx
                most = ctas_per_sm("chip", threads, smem) * sms // per_episode
                if most < 1:
                    continue
                waves = -(-episodes // most)
                yield CGPlan("chip", -(-episodes // waves) * per_episode, threads, brick, smem,
                             waves)


def global_plan(episodes: int, d: int, h: int, w: int, sms: int,
                ctas_per_sm: CTAsPerSM) -> CGPlan:
    """The global mode's plan: 32 warps a CTA (fewer where an episode has
    fewer granules), as many CTAs as fit at once, at most one warp a granule
    of an episode; the same for any number of episodes."""
    gr = Granules(d, h, w)
    threads = 32 * min(MAX_GRANULES, gr.count)
    smem = global_smem_bytes(gr)
    fit = ctas_per_sm("global", threads, smem) * sms
    if fit < 1:
        raise ValueError(f"plan_launch: the global mode's CTA of {threads} threads "
                         f"and {smem} B does not fit the card")
    return CGPlan("global", min(-(-gr.count // (threads // 32)), fit), threads, (0, 0, 0),
                  smem)


def plan_key(plan: CGPlan, gr: Granules, sms: int):
    """What the plan is chosen by: the waves times the granules of the
    busiest SM in a wave (no fewer than MIN_WARPS: an SM with fewer warps
    waits on its loads of partials and faces alone), then the halo sectors
    each warp loads, then the fewest CTAs."""
    warps = plan.threads // 32
    return (plan.waves * max(-(-plan.ctas // sms) * warps, MIN_WARPS),
            halo_sectors(gr, plan.brick) / warps, plan.ctas, plan.brick)


def plan_launch(episodes: int, d: int, h: int, w: int, sms: int, ctas_per_sm: CTAsPerSM,
                mode: Optional[str] = None) -> CGPlan:
    """The launch plan of the CG kernel for `episodes` volumes of d x h x w.

    `sms` is the card's SM count and `ctas_per_sm(mode, threads,
    smem_bytes)` how many CTAs of that shape one SM holds at once (on the
    card, cudaOccupancyMaxActiveBlocksPerMultiprocessor). The "chip" mode is
    taken where some brick cut fits one episode's bricks on the card at
    once (`plan_candidates`): the one with the fewest waves times granules
    of the busiest SM (any load under MIN_WARPS counting as MIN_WARPS),
    then the fewest halo sectors a warp, then the fewest CTAs. Otherwise
    the "global" mode (`global_plan`). `mode="global"` forces the global
    mode; every plan gives the same bits."""
    if episodes < 1 or min(d, h, w) < 1:
        raise ValueError(f"plan_launch: need episodes >= 1 and a volume of at least "
                         f"1x1x1, got {episodes} of {d}x{h}x{w}")
    if mode not in (None, "global"):
        raise ValueError(f"plan_launch: mode must be None or 'global', got {mode!r}")
    gr = Granules(d, h, w)
    if d * h * w > MAX_INT or episodes > MAX_INT:
        raise ValueError(f"plan_launch: {episodes} of {d}x{h}x{w} is past the kernel's "
                         f"32-bit indices within an episode")
    if mode is None:
        plans = list(plan_candidates(episodes, d, h, w, sms, ctas_per_sm))
        if plans:
            return min(plans, key=lambda pl: plan_key(pl, gr, sms))
    return global_plan(episodes, d, h, w, sms, ctas_per_sm)


# ---------------------------------------------------------------- the kernel


def _lib():
    return _build.load(SOURCE, FLAGS, {
        "cg3d_occupancy": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2,
        "cg3d_launch": [ctypes.c_void_p] * 6 + [ctypes.c_uint, ctypes.c_long]
        + [ctypes.c_int] * 11 + [ctypes.c_void_p],
    })


def card_occupancy(index: int) -> Tuple[int, CTAsPerSM]:
    """(SM count, `ctas_per_sm`) of card `index` for `plan_launch`: the
    kernels' cudaOccupancyMaxActiveBlocksPerMultiprocessor (the C entry
    cg3d_occupancy), each shape asked once."""
    lib = _lib()
    queried = {}

    def ask(mode, threads, smem):
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = lib.cg3d_occupancy(int(mode == "chip"), threads, smem,
                                    ctypes.byref(per_sm), ctypes.byref(sms))
        if rc != 0:
            raise RuntimeError(f"cg3d_occupancy failed: cudaError {rc}")
        return per_sm.value, sms.value

    def count(mode, threads, smem):
        q = (mode, threads, smem)
        if q not in queried:
            queried[q] = ask(mode, threads, smem)[0]
        return queried[q]

    return ask("global", 32, 0)[1], count


_PLANS = {}  # (device index, episodes, d, h, w) -> CGPlan
_FLAGS = {}  # (device index, stream) -> [the CTAs' flags, the next tag]
TAG_LIMIT = 2 ** 32  # tags are 32-bit


def launch_plan(episodes: int, d: int, h: int, w: int, device=None) -> CGPlan:
    """The plan a CUDA call of `cg_pressure` takes on `device` (default:
    the current card), with the card's own occupancy."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, episodes, d, h, w)
    plan = _PLANS.get(key)
    if plan is None:
        plan = plan_launch(episodes, d, h, w, *card_occupancy(index))
        _PLANS[key] = plan
    return plan


def _flags(device: torch.device, stream: int, count: int, num_iters: int):
    """The flags for a launch on `stream` (at least `count`: a CTA of each
    episode) and its first tag. The flags are zeroed once (and again only when the 32-bit
    tag would wrap, or when they grow); each launch takes tags [tag, tag +
    2 num_iters] and the next one starts past them, so a flag never holds a
    tag that a later launch waits for."""
    key = (device.index, stream)
    entry = _FLAGS.get(key)
    if entry is None or entry[0].numel() < count:
        entry = [torch.zeros(count, dtype=torch.int32, device=device), 1]
        _FLAGS[key] = entry
    span = 2 * num_iters + 1
    if entry[1] + span >= TAG_LIMIT:
        entry[0].zero_()
        entry[1] = 1
    tag = entry[1]
    entry[1] += span
    return entry[0], tag


def _launch(p0: Tensor, div: Tensor, num_iters: int, plan: CGPlan) -> Tensor:
    """Launches the kernel as `plan` cuts it, on checked CUDA volumes."""
    d, h, w = p0.shape[-3:]
    episodes = p0.numel() // (d * h * w)
    gr = Granules(d, h, w)
    out = torch.empty_like(p0)
    vec = torch.empty(4, *p0.shape, dtype=torch.float32, device=p0.device)
    part = torch.empty(2, episodes, gr.count, dtype=torch.float32, device=p0.device)
    stream = torch.cuda.current_stream(p0.device).cuda_stream
    per_episode = math.prod(bricks(gr, plan.brick)) if plan.mode == "chip" else plan.ctas
    flags, tag = _flags(out.device, stream, episodes * per_episode, num_iters)
    rc = _lib().cg3d_launch(p0.data_ptr(), div.data_ptr(), out.data_ptr(), vec.data_ptr(),
                            part.data_ptr(), flags.data_ptr(), tag, episodes, d, h, w,
                            num_iters, *plan.args, stream)
    if rc != 0:
        raise RuntimeError(f"cg_pressure kernel launch failed: cudaError {rc} "
                           f"({plan.describe()})")
    return out


def cg_pressure(p0: Tensor, div: Tensor, num_iters: int = 30) -> Tensor:
    """`num_iters` CG iterations on float32 p0, div [..., D, H, W] (D, H,
    W >= 1). CUDA tensors run the kernel, one cooperative launch cut by
    `launch_plan`; CPU tensors take `cg_pressure_reference`. The inputs are
    not modified. A CUDA call is refused while its stream is being captured
    into a CUDA graph: the kernel's barrier tags come from a host counter,
    and a replay would wait on spent ones."""
    global LAUNCHES
    for name, t in (("p0", p0), ("div", div)):
        if t.dtype != torch.float32:
            raise TypeError(f"cg_pressure: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cg_pressure: {name} must be contiguous")
    if p0.shape != div.shape or p0.dim() < 3 or min(p0.shape[-3:]) < 1:
        raise ValueError(f"cg_pressure: p0 {tuple(p0.shape)} and div "
                         f"{tuple(div.shape)} must be one non-empty [..., D, H, W] shape")
    if p0.device != div.device:
        raise ValueError("cg_pressure: p0 and div must be on one device")
    if num_iters < 0:
        raise ValueError("cg_pressure: num_iters must be >= 0")
    if p0.device.type == "cpu":
        return cg_pressure_reference(p0, div, num_iters)
    if p0.device.type != "cuda":
        raise ValueError(f"cg_pressure: unsupported device {p0.device}")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("cg_pressure: the CG kernel cannot be captured into a CUDA graph "
                           "(its barrier tags are launch arguments from a host counter)")
    d, h, w = p0.shape[-3:]
    if p0.numel() == 0:
        raise ValueError("cg_pressure: empty batch")
    plan = launch_plan(p0.numel() // (d * h * w), d, h, w, device=p0.device)
    out = _launch(p0, div, num_iters, plan)
    LAUNCHES += 1
    return out
