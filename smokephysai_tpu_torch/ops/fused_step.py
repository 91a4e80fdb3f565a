"""Fused solver kernels (csrc/fused_step.cu) and their plain versions.

`fused_step` runs one solver step (buoyancy, diffusion, projection,
advection, decay) in one kernel launch for a CUDA state, and
`fused_step_reference` on a CPU state. Both reproduce the JAX package's
`fused_step_pallas` (`_step_vals`), stage by stage and in the same order of
floating-point operations. `fused_multi_step` runs a whole episode of steps
in one launch (`fused_multi_step_pallas`) and returns the density
trajectory; its plain version is a loop of `fused_step_reference`. A
leading batch of episodes is allowed, and any positive tap radius
`max_disp`.

The kernels run each episode on one thread-block cluster, one row stripe
per CTA. `plan_launch` (pure Python) chooses the cluster size, the rows
and threads per CTA, the shared memory and the mode: "shared" keeps the
state in the cluster's shared memory, "global" (grids whose state does
not fit it, e.g. 512^2 and 1024^2) in global scratch. `launch_plan` is
the plan a CUDA call takes, with the card's own count of the clusters that
fit it at once.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from . import _build
from .jacobi import jacobi_pressure_reference, row_threads
from .stencil import diffuse_reference, shift

Tensor = torch.Tensor

SOURCE = "fused_step.cu"
# no FMA contraction: every stage rounds as the plain version's separate
# multiply and add do, so the kernel matches it to the last bit or so
FLAGS = ("-fmad=false",)

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)
MULTI_LAUNCHES = 0  # fused_multi_step launches, likewise


def _coefs(dt: float, viscosity: float):
    """The step's scalars as the TPU kernel forms them, in float32."""
    dt32, visc32, tenth = np.float32(dt), np.float32(viscosity), np.float32(0.1)
    coef_uv = dt32 * visc32
    return dt32, dt32 * tenth, coef_uv, coef_uv * tenth


# ---------------------------------------------------------------- plain version


def _centered_velocities(u: Tensor, v: Tensor, fh: int, fw: int):
    """2-tap cell-centre velocities on an (fh, fw) grid: 0.5 (u[i,j] +
    u[i,j+1]) for j < uw-1 and 0.5 (v[i,j] + v[i+1,j]) for i < vh-1, zero
    beyond (what the clamped bilinear sample gives there)."""
    uw, vh = u.shape[-1], v.shape[-2]
    ncols, nrows = min(fw, uw - 1), min(fh, vh - 1)
    u_i = torch.zeros(*u.shape[:-2], fh, fw, dtype=u.dtype, device=u.device)
    u_i[..., :, :ncols] = 0.5 * (u[..., :fh, :ncols] + u[..., :fh, 1:ncols + 1])
    v_i = torch.zeros(*v.shape[:-2], fh, fw, dtype=v.dtype, device=v.device)
    v_i[..., :nrows, :] = 0.5 * (v[..., :nrows, :fw] + v[..., 1:nrows + 1, :fw])
    return u_i, v_i


def tent_advect(field: Tensor, u: Tensor, v: Tensor, dt, max_disp: int) -> Tensor:
    """Semi-Lagrangian advection by tent-weight shift taps, with the exact
    edge zeroing of the clamped bilinear sample."""
    h, w = field.shape[-2], field.shape[-1]
    dt = float(dt)
    u_i, v_i = _centered_velocities(u, v, h, w)
    y_c = torch.arange(h, dtype=field.dtype, device=field.device)[:, None]
    x_c = torch.arange(w, dtype=field.dtype, device=field.device)[None, :]
    prev_x = torch.clamp(x_c - dt * u_i, 0, w - 1)
    prev_y = torch.clamp(y_c - dt * v_i, 0, h - 1)
    out = torch.zeros_like(field)
    for di in range(-max_disp, max_disp + 1):
        wy = torch.clamp_min(1.0 - torch.abs(prev_y - (y_c + di)), 0.0)
        for dj in range(-max_disp, max_disp + 1):
            wx = torch.clamp_min(1.0 - torch.abs(prev_x - (x_c + dj)), 0.0)
            out = out + wy * wx * shift(field, di, dj, "zero")
    keep = (prev_x < w - 1) & (prev_y < h - 1)
    return torch.where(keep, out, torch.zeros_like(out))


def fused_step_reference(
    u: Tensor, v: Tensor, p: Tensor, density: Tensor,
    dt: float, viscosity: float,
    num_jacobi_iters: int = 20, max_disp: int = 1,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the fused step (the TPU kernel's
    `_step_vals`, operation for operation)."""
    dt32, buoy, coef_uv, coef_d = _coefs(dt, viscosity)
    d = density
    # 1. buoyancy on v[:, :-1] (the reference solver's quirk)
    v = torch.cat([v[..., :, :-1] + float(buoy) * d, v[..., :, -1:]], dim=-1)
    # 2. diffusion
    u = diffuse_reference(u, coef_uv)
    v = diffuse_reference(v, coef_uv)
    d = diffuse_reference(d, coef_d)
    # 3. projection: divergence, warm-started Jacobi, interior correction
    # a tensor divisor: true division on the card too (a Python scalar
    # divisor becomes a multiply by its reciprocal there)
    div = (u[..., 1:, :] - u[..., :-1, :] + v[..., :, 1:] - v[..., :, :-1]) / torch.tensor(
        float(dt32), dtype=u.dtype, device=u.device)
    p = jacobi_pressure_reference(p, div, num_jacobi_iters)
    dtf = float(dt32)
    u = torch.cat([u[..., :1, :],
                   u[..., 1:-1, :] - dtf * (p[..., 1:, :] - p[..., :-1, :]),
                   u[..., -1:, :]], dim=-2)
    v = torch.cat([v[..., :, :1],
                   v[..., :, 1:-1] - dtf * (p[..., :, 1:] - p[..., :, :-1]),
                   v[..., :, -1:]], dim=-1)
    # 4. sequential advection; 5. decay
    u_new = tent_advect(u, u, v, dtf, max_disp)
    v_new = tent_advect(v, u_new, v, dtf, max_disp)
    d_new = tent_advect(d, u_new, v_new, dtf, max_disp)
    return u_new, v_new, p, d_new * 0.995


# ---------------------------------------------------------------- launch plan

SMEM_MAX = 232_448  # dynamic shared memory one CTA can have on an H100
MAX_CLUSTER = 16    # CTAs per cluster (the non-portable size)
MAX_THREADS = 1024  # threads per CTA (the kernels' launch bound)
ROW_THREADS = (32, 64)  # threads along a row: one warp or two
SLOTS = 6           # planes of the state and its intermediates
BAR_BYTES = 16      # the shared mode's two mbarriers
MAX_INT = 2 ** 31 - 1  # the launchers take sizes and rows as 32-bit ints


def _round4(floats: int) -> int:
    """A slot's floats, rounded up so that every slot starts 16-byte aligned."""
    return -(-floats // 4) * 4


def stripe_floats(rows: int, w: int, max_disp: int) -> int:
    """Floats of one CTA's stripes of the 6 planes in the shared mode: each
    `rows` rows and max(max_disp, 1) halo rows above and below, w + 1
    wide (u, v, p and the density all fit)."""
    return SLOTS * _round4((rows + 2 * max(max_disp, 1)) * (w + 1))


def stripe_bytes(rows: int, w: int, max_disp: int) -> int:
    """Dynamic shared memory of one CTA in the shared mode: the stripes and
    two mbarriers (the halos' arrivals, even and odd stages)."""
    return BAR_BYTES + 4 * stripe_floats(rows, w, max_disp)


def plane_set_floats(h: int, w: int) -> int:
    """Floats of one cluster's 6 whole planes in the global mode."""
    return SLOTS * _round4((h + 1) * (w + 1))


@dataclass(frozen=True)
class LaunchPlan:
    """How one call of the fused kernels is cut: `cluster` CTAs per episode,
    each owning `rows` rows of the grid (the last CTA what is left, and u's
    row h); `clusters` clusters launched, each taking episodes in turn;
    `bx` x `by` threads per CTA; `smem_bytes` of dynamic shared memory per
    CTA in the "shared" mode; `scratch_floats` of global scratch in the
    "global" mode."""

    mode: str
    cluster: int
    clusters: int
    rows: int
    bx: int
    by: int
    smem_bytes: int
    scratch_floats: int

    @property
    def threads(self) -> int:
        return self.bx * self.by

    @property
    def ctas(self) -> int:
        return self.cluster * self.clusters

    @property
    def args(self):
        """The launchers' plan arguments."""
        return (self.cluster, self.clusters, self.rows, self.bx, self.by,
                self.smem_bytes, int(self.mode == "shared"))

    def describe(self) -> str:
        return (f"{self.mode} mode, cluster {self.cluster} x {self.clusters} "
                f"clusters = {self.ctas} CTAs of {self.bx}x{self.by} threads, "
                f"{self.rows} rows per CTA, {self.smem_bytes} B shared memory "
                f"per CTA, {self.scratch_floats * 4} B global scratch")


# (cluster, bx, by, smem_bytes, mode) -> clusters that fit the card at once
ActiveCount = Callable[[int, int, int, int, str], int]


def plan_candidates(episodes: int, h: int, w: int, max_disp: int,
                    max_active_clusters: ActiveCount, mode: str):
    """Every plan of `mode` ("shared" or "global") that the card can
    launch: each cluster size that cuts the grid into its own stripes of at
    least max_disp + 2 rows (in the shared mode, of at most SMEM_MAX bytes),
    each row width of ROW_THREADS and each count of thread rows, with as
    many clusters as fit at once (`max_active_clusters`), at most one per
    episode."""
    for cluster in range(MAX_CLUSTER, 0, -1):
        rows = max(-(-h // cluster), max_disp + 2)
        if -(-h // rows) != cluster:  # a smaller cluster cuts the same stripes
            continue
        smem = stripe_bytes(rows, w, max_disp) if mode == "shared" else 0
        if smem > SMEM_MAX:
            continue
        for bx in ROW_THREADS:
            for by in row_threads(rows, MAX_THREADS // bx):
                active = max_active_clusters(cluster, bx, by, smem, mode)
                if active < 1:
                    continue
                clusters = min(episodes, active)
                yield LaunchPlan(
                    mode=mode, cluster=cluster, clusters=clusters, rows=rows, bx=bx, by=by,
                    smem_bytes=smem,
                    scratch_floats=clusters * plane_set_floats(h, w) if mode == "global" else 0)


def plan_launch(episodes: int, h: int, w: int, max_disp: int,
                max_active_clusters: ActiveCount) -> LaunchPlan:
    """The launch plan of the fused kernels for `episodes` states of an
    h x w grid at tap radius `max_disp`.

    `max_active_clusters(cluster, bx, by, smem_bytes, mode)` says how many
    clusters of that shape fit the card at once (on the card,
    cudaOccupancyMaxActiveClusters). The state stays in shared memory
    ("shared" mode) where some cluster size gives stripes of at most
    SMEM_MAX bytes; otherwise the planes live in global scratch ("global").
    Among the mode's candidates (`plan_candidates`), the plan takes the
    fewest waves of clusters over the episodes, then the largest cluster,
    then the most threads, then the narrower rows of threads (one warp or
    two along a grid row). Every CTA has at least max_disp + 2 rows of
    room, so an advection tap reaches no further than the neighbouring
    stripe, and at most as many clusters are launched as fit at once; each
    takes episodes in turn."""
    if episodes < 1 or h < 2 or w < 2:
        raise ValueError(f"plan_launch: need episodes >= 1 and a grid of at least "
                         f"2x2, got {episodes} of {h}x{w}")
    if not (isinstance(max_disp, (int, np.integer)) and max_disp >= 1):
        raise ValueError(f"plan_launch: max_disp must be a positive integer, got {max_disp!r}")
    if max(h + 1, w + 1, max_disp + 2) > MAX_INT:
        raise ValueError(f"plan_launch: a {h}x{w} grid at max_disp {max_disp} needs rows of "
                         f"room (max_disp + 2) past the kernels' limit of {MAX_INT}")
    for mode in ("shared", "global"):
        plans = list(plan_candidates(episodes, h, w, max_disp, max_active_clusters, mode))
        if plans:
            return min(plans, key=lambda pl: (-(-episodes // pl.clusters), -pl.cluster,
                                              -pl.threads, pl.bx))
    raise ValueError(f"plan_launch: no cluster shape fits the card for {episodes} "
                     f"episodes of {h}x{w}")


# ---------------------------------------------------------------- the kernel


def _lib():
    ptrs = [ctypes.c_void_p] * 9
    ints = [ctypes.c_int] * 5
    floats = [ctypes.c_float] * 4
    plan = [ctypes.c_int] * 7
    return _build.load(SOURCE, FLAGS, {
        "fused_step_launch": ptrs + ints + floats + plan + [ctypes.c_void_p],
        "fused_multi_step_launch": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + floats + plan + [ctypes.c_void_p],
        "fused_step_max_active_clusters": [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int)],
    })


def card_active_clusters(index: int, multi: bool, max_disp: int) -> ActiveCount:
    """`max_active_clusters` for `plan_launch` on card `index`: the kernel's
    cudaOccupancyMaxActiveClusters (the C entry
    fused_step_max_active_clusters), each shape asked once."""
    lib = _lib()
    queried = {}

    def count(cluster, bx, by, smem_bytes, mode):
        q = (cluster, bx, by, smem_bytes, mode)
        if q not in queried:
            out = ctypes.c_int(0)
            with torch.cuda.device(index):
                rc = lib.fused_step_max_active_clusters(
                    int(multi), int(mode == "shared"), max_disp, cluster, bx, by, smem_bytes,
                    ctypes.byref(out))
            queried[q] = out.value if rc == 0 else 0
        return queried[q]

    return count


_PLANS = {}  # (device index, multi, episodes, h, w, max_disp) -> LaunchPlan


def launch_plan(episodes: int, h: int, w: int, max_disp: int, multi: bool = False,
                device=None) -> LaunchPlan:
    """The plan a CUDA call of `fused_step` (or, with `multi`,
    `fused_multi_step`) takes on `device` (default: the current card),
    with the card's count of the clusters that fit it at once."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, bool(multi), episodes, h, w, max_disp)
    plan = _PLANS.get(key)
    if plan is None:
        plan = plan_launch(episodes, h, w, max_disp,
                           card_active_clusters(index, multi, max_disp))
        _PLANS[key] = plan
    return plan


def _check(u: Tensor, v: Tensor, p: Tensor, density: Tensor):
    h, w = density.shape[-2], density.shape[-1]
    lead = density.shape[:-2]
    want = {"u": (*lead, h + 1, w), "v": (*lead, h, w + 1),
            "p": (*lead, h, w), "density": (*lead, h, w)}
    for name, t in (("u", u), ("v", v), ("p", p), ("density", density)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_step: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_step: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.device != density.device:
            raise ValueError("fused_step: all fields must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"fused_step: {name} must be contiguous")
    if h < 2 or w < 2:
        raise ValueError("fused_step: grid must be at least 2x2")


def fused_multi_step_reference(
    u: Tensor, v: Tensor, p: Tensor, density: Tensor, num_steps: int,
    dt: float, viscosity: float,
    num_jacobi_iters: int = 20, max_disp: int = 1,
) -> Tuple[Tuple[Tensor, Tensor, Tensor, Tensor], Tensor]:
    """Plain version of the multi-step kernel: `num_steps` calls of
    `fused_step_reference`. Returns the final (u, v, p, density) and the
    density after each step, [..., num_steps, H, W]."""
    traj = []
    for _ in range(num_steps):
        u, v, p, density = fused_step_reference(u, v, p, density, dt, viscosity,
                                                num_jacobi_iters, max_disp)
        traj.append(density)
    return (u, v, p, density), torch.stack(traj, dim=-3)


def _check_launch(name: str, density: Tensor, max_disp: int, num_jacobi_iters: int):
    if density.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {density.device}")
    if not (isinstance(max_disp, (int, np.integer)) and max_disp >= 1):
        raise ValueError(f"{name}: max_disp must be a positive integer, got {max_disp!r}")
    if num_jacobi_iters < 0:
        raise ValueError(f"{name}: num_jacobi_iters must be >= 0")
    h, w = density.shape[-2], density.shape[-1]
    episodes = density.numel() // (h * w)
    if episodes == 0:
        raise ValueError(f"{name}: empty batch")
    return h, w, episodes


@functools.lru_cache(maxsize=64)
def _launch_scalars(dt: float, viscosity: float):
    return tuple(float(x) for x in _coefs(dt, viscosity))


def _launch(u: Tensor, v: Tensor, p: Tensor, density: Tensor, num_steps, dt: float,
            viscosity: float, num_jacobi_iters: int, max_disp: int, plan: LaunchPlan):
    """Launches the single-step kernel (num_steps None) or the multi-step
    kernel as `plan` cuts it, on checked CUDA fields. Returns the new
    (u, v, p, density) and, for the multi-step kernel, the trajectory."""
    h, w = density.shape[-2], density.shape[-1]
    episodes = density.numel() // (h * w)
    outs = [torch.empty_like(t) for t in (u, v, p, density)]
    scratch = (torch.empty(plan.scratch_floats, dtype=torch.float32, device=density.device)
               if plan.mode == "global" else None)
    ptrs = [t.data_ptr() for t in (u, v, p, density, *outs)]
    scratch_ptr = None if scratch is None else scratch.data_ptr()
    stream = torch.cuda.current_stream(density.device).cuda_stream
    if num_steps is None:
        traj = None
        rc = _lib().fused_step_launch(*ptrs, scratch_ptr, episodes, h, w, num_jacobi_iters,
                                      max_disp, *_launch_scalars(dt, viscosity), *plan.args,
                                      stream)
    else:
        traj = torch.empty(*density.shape[:-2], num_steps, h, w, dtype=torch.float32,
                           device=density.device)
        rc = _lib().fused_multi_step_launch(*ptrs, traj.data_ptr(), scratch_ptr, episodes, h,
                                            w, num_jacobi_iters, max_disp, num_steps,
                                            *_launch_scalars(dt, viscosity), *plan.args,
                                            stream)
    if rc != 0:
        kernel = "fused_step" if num_steps is None else "fused_multi_step"
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc} "
                           f"({plan.describe()})")
    return tuple(outs), traj


def fused_multi_step(
    u: Tensor, v: Tensor, p: Tensor, density: Tensor, num_steps: int,
    dt: float, viscosity: float,
    num_jacobi_iters: int = 20, max_disp: int = 1,
) -> Tuple[Tuple[Tensor, Tensor, Tensor, Tensor], Tensor]:
    """`num_steps` solver steps. CUDA tensors launch the multi-step kernel
    once (one cluster per episode of the leading batch at a time, cut by
    `launch_plan`); CPU tensors take `fused_multi_step_reference`. Returns
    the final (u, v, p, density) and the trajectory [..., num_steps, H, W];
    the inputs are not modified."""
    global MULTI_LAUNCHES
    _check(u, v, p, density)
    if num_steps < 1:
        raise ValueError("fused_multi_step: num_steps must be >= 1")
    if density.device.type == "cpu":
        return fused_multi_step_reference(u, v, p, density, num_steps, dt,
                                          viscosity, num_jacobi_iters, max_disp)
    h, w, episodes = _check_launch("fused_multi_step", density, max_disp,
                                   num_jacobi_iters)
    plan = launch_plan(episodes, h, w, max_disp, multi=True, device=density.device)
    out = _launch(u, v, p, density, num_steps, dt, viscosity, num_jacobi_iters, max_disp,
                  plan)
    MULTI_LAUNCHES += 1
    return out


def fused_step(
    u: Tensor, v: Tensor, p: Tensor, density: Tensor,
    dt: float, viscosity: float,
    num_jacobi_iters: int = 20, max_disp: int = 1,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One whole solver step. CUDA tensors launch the kernel (one cluster
    per episode of the leading batch at a time, cut by `launch_plan`); CPU
    tensors take `fused_step_reference`."""
    global LAUNCHES
    _check(u, v, p, density)
    if density.device.type == "cpu":
        return fused_step_reference(u, v, p, density, dt, viscosity,
                                    num_jacobi_iters, max_disp)
    h, w, episodes = _check_launch("fused_step", density, max_disp,
                                   num_jacobi_iters)
    plan = launch_plan(episodes, h, w, max_disp, device=density.device)
    outs, _ = _launch(u, v, p, density, None, dt, viscosity, num_jacobi_iters, max_disp,
                      plan)
    LAUNCHES += 1
    return outs
