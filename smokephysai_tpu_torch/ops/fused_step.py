"""Fused solver kernels (csrc/fused_step.cu) and their plain versions.

`fused_step` runs one solver step (buoyancy, diffusion, projection,
advection, decay) in one kernel launch for a CUDA state, and
`fused_step_reference` on a CPU state. Both reproduce the JAX package's
`fused_step_pallas` (`_step_vals`), stage by stage and in the same order of
floating-point operations. `fused_multi_step` runs a whole episode of steps
in one launch (`fused_multi_step_pallas`) and returns the density
trajectory; its plain version is a loop of `fused_step_reference`. A
leading batch of episodes is allowed.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build

Tensor = torch.Tensor

SOURCE = "fused_step.cu"
# no FMA contraction: every stage rounds as the plain version's separate
# multiply and add do, so the kernel matches it to the last bit or so
FLAGS = ("-fmad=false",)
MAX_DISP = (1, 2)  # tap radii compiled into the kernel

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)
MULTI_LAUNCHES = 0  # fused_multi_step launches, likewise


def _coefs(dt: float, viscosity: float):
    """The step's scalars as the TPU kernel forms them, in float32."""
    dt32, visc32, tenth = np.float32(dt), np.float32(viscosity), np.float32(0.1)
    coef_uv = dt32 * visc32
    return dt32, dt32 * tenth, coef_uv, coef_uv * tenth


# ---------------------------------------------------------------- plain version


def _shift(f: Tensor, di: int, dj: int, fill: str) -> Tensor:
    """f[i + di, j + dj] on the last two dims; out-of-range taps are zero
    (fill='zero') or the nearest edge value (fill='edge')."""
    h, w = f.shape[-2], f.shape[-1]
    if fill == "edge":
        rows = torch.arange(h, device=f.device).add(di).clamp(0, h - 1)
        cols = torch.arange(w, device=f.device).add(dj).clamp(0, w - 1)
        return f.index_select(-2, rows).index_select(-1, cols)
    out = torch.zeros_like(f)
    r0, r1 = max(0, -di), min(h, h - di)
    c0, c1 = max(0, -dj), min(w, w - dj)
    if r1 > r0 and c1 > c0:
        out[..., r0:r1, c0:c1] = f[..., r0 + di:r1 + di, c0 + dj:c1 + dj]
    return out


def _diffuse(f: Tensor, coef) -> Tensor:
    lap = (
        _shift(f, -1, 0, "edge") + _shift(f, 1, 0, "edge")
        + _shift(f, 0, -1, "edge") + _shift(f, 0, 1, "edge") - 4.0 * f
    )
    return f + float(coef) * lap


def _jacobi(p: Tensor, div: Tensor, num_iters: int) -> Tensor:
    h, w = div.shape[-2], div.shape[-1]
    row = torch.arange(h, device=p.device)[:, None]
    col = torch.arange(w, device=p.device)[None, :]
    interior = (row > 0) & (row < h - 1) & (col > 0) & (col < w - 1)
    for _ in range(num_iters):
        val = 0.25 * (
            _shift(p, -1, 0, "zero") + _shift(p, 1, 0, "zero")
            + _shift(p, 0, -1, "zero") + _shift(p, 0, 1, "zero") - div
        )
        p = torch.where(interior, val, torch.zeros_like(val))
    return p


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
            out = out + wy * wx * _shift(field, di, dj, "zero")
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
    u = _diffuse(u, coef_uv)
    v = _diffuse(v, coef_uv)
    d = _diffuse(d, coef_d)
    # 3. projection: divergence, warm-started Jacobi, interior correction
    # a tensor divisor: true division on the card too (a Python scalar
    # divisor becomes a multiply by its reciprocal there)
    div = (u[..., 1:, :] - u[..., :-1, :] + v[..., :, 1:] - v[..., :, :-1]) / torch.tensor(
        float(dt32), dtype=u.dtype, device=u.device)
    p = _jacobi(p, div, num_jacobi_iters)
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


# ---------------------------------------------------------------- the kernel


def _lib():
    ptrs = [ctypes.c_void_p] * 9
    ints = [ctypes.c_int] * 5
    floats = [ctypes.c_float] * 4
    return _build.load(SOURCE, FLAGS, {
        "fused_step_launch": ptrs + ints + floats + [ctypes.c_void_p],
        "fused_multi_step_launch": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + floats + [ctypes.c_void_p],
    })


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
    if max_disp not in MAX_DISP:
        raise ValueError(f"{name}: max_disp must be one of {MAX_DISP}")
    if num_jacobi_iters < 0:
        raise ValueError(f"{name}: num_jacobi_iters must be >= 0")
    h, w = density.shape[-2], density.shape[-1]
    episodes = density.numel() // (h * w)
    if episodes == 0:
        raise ValueError(f"{name}: empty batch")
    return h, w, episodes


def fused_multi_step(
    u: Tensor, v: Tensor, p: Tensor, density: Tensor, num_steps: int,
    dt: float, viscosity: float,
    num_jacobi_iters: int = 20, max_disp: int = 1,
) -> Tuple[Tuple[Tensor, Tensor, Tensor, Tensor], Tensor]:
    """`num_steps` solver steps. CUDA tensors launch the multi-step kernel
    once (one block per episode of the leading batch); CPU tensors take
    `fused_multi_step_reference`. Returns the final (u, v, p, density) and
    the trajectory [..., num_steps, H, W]; the inputs are not modified."""
    global MULTI_LAUNCHES
    _check(u, v, p, density)
    if num_steps < 1:
        raise ValueError("fused_multi_step: num_steps must be >= 1")
    if density.device.type == "cpu":
        return fused_multi_step_reference(u, v, p, density, num_steps, dt,
                                          viscosity, num_jacobi_iters, max_disp)
    h, w, episodes = _check_launch("fused_multi_step", density, max_disp,
                                   num_jacobi_iters)
    outs = [torch.empty_like(t) for t in (u, v, p, density)]
    traj = torch.empty(*density.shape[:-2], num_steps, h, w,
                       dtype=torch.float32, device=density.device)
    scratch = torch.empty(
        episodes * (2 * (h + 1) * w + 2 * h * (w + 1) + 5 * h * w),
        dtype=torch.float32, device=density.device,
    )
    dt32, buoy, coef_uv, coef_d = _coefs(dt, viscosity)
    stream = torch.cuda.current_stream(density.device).cuda_stream
    rc = _lib().fused_multi_step_launch(
        u.data_ptr(), v.data_ptr(), p.data_ptr(), density.data_ptr(),
        *(t.data_ptr() for t in outs), traj.data_ptr(), scratch.data_ptr(),
        episodes, h, w, num_jacobi_iters, max_disp, num_steps,
        float(dt32), float(buoy), float(coef_uv), float(coef_d), stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_multi_step kernel launch failed: cudaError {rc}")
    MULTI_LAUNCHES += 1
    return tuple(outs), traj


def fused_step(
    u: Tensor, v: Tensor, p: Tensor, density: Tensor,
    dt: float, viscosity: float,
    num_jacobi_iters: int = 20, max_disp: int = 1,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One whole solver step. CUDA tensors launch the kernel (one block per
    episode of the leading batch); CPU tensors take `fused_step_reference`."""
    global LAUNCHES
    _check(u, v, p, density)
    if density.device.type == "cpu":
        return fused_step_reference(u, v, p, density, dt, viscosity,
                                    num_jacobi_iters, max_disp)
    h, w, episodes = _check_launch("fused_step", density, max_disp,
                                   num_jacobi_iters)
    outs = [torch.empty_like(t) for t in (u, v, p, density)]
    scratch = torch.empty(
        episodes * ((h + 1) * w + h * (w + 1) + 3 * h * w),
        dtype=torch.float32, device=density.device,
    )
    dt32, buoy, coef_uv, coef_d = _coefs(dt, viscosity)
    stream = torch.cuda.current_stream(density.device).cuda_stream
    rc = _lib().fused_step_launch(
        u.data_ptr(), v.data_ptr(), p.data_ptr(), density.data_ptr(),
        *(t.data_ptr() for t in outs), scratch.data_ptr(),
        episodes, h, w, num_jacobi_iters, max_disp,
        float(dt32), float(buoy), float(coef_uv), float(coef_d), stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_step kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return tuple(outs)
