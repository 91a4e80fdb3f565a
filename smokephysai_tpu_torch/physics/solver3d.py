"""3D incompressible smoke solver on tensors, with a conjugate-gradient
pressure solve.

Counterpart of the JAX package's `physics/solver3d.py`, with the same
numerics: a staggered 3D MAC grid; buoyancy on the vertical (w) faces;
replicate-padded explicit diffusion; a warm-started CG projection with the
zero-Dirichlet 7-point Laplacian; semi-Lagrangian advection of the
cell-centred velocities (each with the ones already advected) and of the
density, by the gather-free tent-shift taps (`max_disp` > 0) or the
corner-clamped trilinear gather (`max_disp=0`); re-staggering; 0.995 decay.
dt, the viscosity and the buoyancy are rounded to float32 first, as the
JAX package traces them.

Fields may carry a leading batch of episodes, where the JAX package vmaps.
`step3d(use_pallas=True)` solves the pressure with the CG kernel
(`ops/cg3d.py`) on every volume (the JAX package's Pallas kernel runs only
on volumes that fit in VMEM); the plain CG otherwise. The JAX package's
`checkify` guard on the tent-shift displacement does nothing under plain
jit and is left out. `pressure_solver="mg"` solves the pressure by
geometric-multigrid V-cycles (`physics/multigrid3d.py`) instead, max(1,
num_cg_iters // 15) of them, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cg3d as _cg
from .multigrid3d import mg_pressure

Tensor = torch.Tensor

# the plain CG (the JAX package's solver3d.cg_pressure)
cg_pressure = _cg.cg_pressure_reference


@dataclasses.dataclass(frozen=True)
class SimState3D:
    """Staggered MAC fields, the JAX package's shapes: u x-faces (d, h,
    w+1), v y-faces (d, h+1, w), w z-faces (d+1, h, w); p and density
    cell-centred (d, h, w). A leading batch of episodes is allowed."""

    u: Tensor
    v: Tensor
    w: Tensor
    p: Tensor
    density: Tensor

    def replace(self, **changes) -> "SimState3D":
        return dataclasses.replace(self, **changes)


def init_state3d(grid_size: Tuple[int, int, int], device="cuda",
                 dtype=torch.float32, batch=()) -> SimState3D:
    """Zero state; `batch` is a tuple of leading episode dims."""
    d, h, w = grid_size
    z = lambda *s: torch.zeros(*batch, *s, dtype=dtype, device=device)
    return SimState3D(u=z(d, h, w + 1), v=z(d, h + 1, w), w=z(d + 1, h, w),
                      p=z(d, h, w), density=z(d, h, w))


def _f32(x: float) -> float:
    return float(np.float32(x))


def _iota(shape, axis: int, like: Tensor) -> Tensor:
    """Cell index along `axis` of a [d, h, w] volume, broadcastable."""
    n = shape[axis]
    view = [1, 1, 1]
    view[axis] = n
    return torch.arange(n, dtype=like.dtype, device=like.device).view(view)


def add_smoke_source3d(density: Tensor, x, y, z, radius: float = 8.0,
                       intensity=1.0) -> Tensor:
    """Gaussian blob, sigma = radius/3, truncated where the squared distance
    exceeds radius^2. `x`, `y`, `z` and `intensity` are numbers or float32
    tensors that broadcast against [D, H, W] (for example [N, 1, 1, 1])."""
    shape = density.shape[-3:]
    zg, yg, xg = (_iota(shape, a, density) for a in range(3))
    dist2 = (xg - x) ** 2 + (yg - y) ** 2 + (zg - z) ** 2
    blob = intensity * torch.exp(-dist2 / _f32(2.0 * (radius / 3.0) ** 2))
    return density + torch.where(dist2 <= _f32(radius ** 2), blob, torch.zeros_like(blob))


def diffuse3d(field: Tensor, coef: float) -> Tensor:
    """field + coef * Lap(field), the 7-point Laplacian replicate-padded;
    coef is dt * viscosity, formed in float32 by the caller."""
    lead = field.shape[:-3]
    p = F.pad(field.reshape(-1, 1, *field.shape[-3:]), (1, 1, 1, 1, 1, 1),
              mode="replicate").reshape(*lead, *(s + 2 for s in field.shape[-3:]))
    lap = (
        p[..., :-2, 1:-1, 1:-1]
        + p[..., 2:, 1:-1, 1:-1]
        + p[..., 1:-1, :-2, 1:-1]
        + p[..., 1:-1, 2:, 1:-1]
        + p[..., 1:-1, 1:-1, :-2]
        + p[..., 1:-1, 1:-1, 2:]
        - 6.0 * field
    )
    return field + coef * lap


def trilinear_interpolate(field: Tensor, z: Tensor, y: Tensor, x: Tensor) -> Tensor:
    """Trilinear sample of `field` [..., d, h, w] at float coordinates,
    which broadcast against it: corner indices clamped, weights from the
    unclamped lower corner, one flat gather per corner."""
    d, h, w = field.shape[-3:]
    lead = field.shape[:-3]
    z0, y0, x0 = (torch.floor(c).long() for c in (z, y, x))
    z1 = (z0 + 1).clamp(0, d - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    z0c, y0c, x0c = z0.clamp(0, d - 1), y0.clamp(0, h - 1), x0.clamp(0, w - 1)
    fz = z - z0.to(field.dtype)
    fy = y - y0.to(field.dtype)
    fx = x - x0.to(field.dtype)
    shape = torch.broadcast_shapes(z.shape, y.shape, x.shape, (*lead, 1, 1, 1))
    flat = field.reshape(*lead, d * h * w)

    def g(zz, yy, xx):
        idx = ((zz * h + yy) * w + xx).expand(shape).reshape(*lead, -1)
        return torch.gather(flat, -1, idx).reshape(shape)

    c00 = g(z0c, y0c, x0c) * (1 - fx) + g(z0c, y0c, x1) * fx
    c01 = g(z0c, y1, x0c) * (1 - fx) + g(z0c, y1, x1) * fx
    c10 = g(z1, y0c, x0c) * (1 - fx) + g(z1, y0c, x1) * fx
    c11 = g(z1, y1, x0c) * (1 - fx) + g(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def trilinear_shift_sample(field: Tensor, pz: Tensor, py: Tensor, px: Tensor,
                           max_disp: int) -> Tensor:
    """Trilinear sample by tent-weight shift taps:

      out[k,i,j] = sum_{|dz|,|dy|,|dx| <= D} hat(pz - (k+dz)) hat(py - (i+dy))
                   hat(px - (j+dx)) field[k+dz, i+dy, j+dx]

    with hat(t) = max(0, 1 - |t|) and zero beyond the volume: the
    corner-clamped trilinear gather wherever the back-trace moves less than
    `max_disp` cells ((2D+1)^3 taps, 27 at max_disp 1)."""
    shape = field.shape[-3:]
    zc, yc, xc = (_iota(shape, a, field) for a in range(3))
    D = max_disp
    padded = F.pad(field, (D, D, D, D, D, D))
    d, h, w = shape

    def hat(pos, coord, off):
        return torch.clamp_min(1.0 - torch.abs(pos - (coord + off)), 0.0)

    wxs = [hat(px, xc, dx) for dx in range(-D, D + 1)]
    out = torch.zeros_like(field)
    for dz in range(-D, D + 1):
        wz = hat(pz, zc, dz)
        for dy in range(-D, D + 1):
            wzy = wz * hat(py, yc, dy)
            for dx, wx in zip(range(-D, D + 1), wxs):
                shifted = padded[..., D + dz:D + dz + d, D + dy:D + dy + h,
                                 D + dx:D + dx + w]
                out = out + wzy * wx * shifted
    return out


def centered_velocities(state: SimState3D) -> Tuple[Tensor, Tensor, Tensor]:
    """Face velocities averaged to the cell centres."""
    uc = 0.5 * (state.u[..., :, :, :-1] + state.u[..., :, :, 1:])
    vc = 0.5 * (state.v[..., :, :-1, :] + state.v[..., :, 1:, :])
    wc = 0.5 * (state.w[..., :-1, :, :] + state.w[..., 1:, :, :])
    return uc, vc, wc


def advect3d(field: Tensor, uc: Tensor, vc: Tensor, wc: Tensor, dt: float,
             max_disp: int = 1) -> Tensor:
    """Semi-Lagrangian back-trace of a cell-centred field with centred
    velocities: the tent-shift taps for `max_disp` > 0 (exact while the
    back-trace moves less than `max_disp` cells), the trilinear gather for
    `max_disp` 0."""
    shape = field.shape[-3:]
    d, h, w = shape
    dt = _f32(dt)
    zg, yg, xg = (_iota(shape, a, field) for a in range(3))
    pz = torch.clamp(zg - dt * wc, 0, d - 1)
    py = torch.clamp(yg - dt * vc, 0, h - 1)
    px = torch.clamp(xg - dt * uc, 0, w - 1)
    if max_disp > 0:
        return trilinear_shift_sample(field, pz, py, px, max_disp)
    return trilinear_interpolate(field, pz, py, px)


def divergence3d(state: SimState3D, dt: float) -> Tensor:
    """Face-difference divergence over 1/dt (a true division, as in JAX)."""
    dt = torch.tensor(_f32(dt), dtype=state.u.dtype, device=state.u.device)
    return (
        state.u[..., :, :, 1:]
        - state.u[..., :, :, :-1]
        + state.v[..., :, 1:, :]
        - state.v[..., :, :-1, :]
        + state.w[..., 1:, :, :]
        - state.w[..., :-1, :, :]
    ) / dt


def _restagger(c: Tensor, axis: int) -> Tensor:
    """Centred values back to faces: the mean of the two cells inside, the
    edge cell's value on the two boundary faces."""
    n = c.shape[axis]
    mids = 0.5 * (c.narrow(axis, 0, n - 1) + c.narrow(axis, 1, n - 1))
    return torch.cat([c.narrow(axis, 0, 1), mids, c.narrow(axis, n - 1, 1)], dim=axis)


def step3d(
    state: SimState3D,
    dt: float = 0.01,
    viscosity: float = 0.001,
    buoyancy: float = 0.1,
    num_cg_iters: int = 30,
    max_disp: int = 1,
    use_pallas: bool = False,
    pressure_solver: str = "cg",
) -> SimState3D:
    """One 3D step: buoyancy on the w faces below each cell, diffusion
    (density at a tenth of the viscosity), the pressure projection (CG, the
    kernel under `use_pallas`; or `pressure_solver="mg"`'s V-cycles),
    sequential advection of the centred velocities and the density,
    re-staggering, 0.995 decay."""
    if pressure_solver not in ("cg", "mg"):
        raise ValueError(f"unknown pressure_solver {pressure_solver!r}")
    dt32, visc32, buoy32 = np.float32(dt), np.float32(viscosity), np.float32(buoyancy)

    # 1. buoyancy on the vertical faces below each cell
    w = state.w.clone()
    w[..., :-1, :, :] = w[..., :-1, :, :] + float(dt32 * buoy32) * state.density

    # 2. diffusion
    coef = float(dt32 * visc32)
    state = state.replace(
        u=diffuse3d(state.u, coef),
        v=diffuse3d(state.v, coef),
        w=diffuse3d(w, coef),
        density=diffuse3d(state.density, float(dt32 * (visc32 * np.float32(0.1)))),
    )

    # 3. pressure projection
    div = divergence3d(state, dt)
    if pressure_solver == "mg":
        p = mg_pressure(state.p, div, num_cycles=max(1, num_cg_iters // 15))
    else:
        solve = _cg.cg_pressure if use_pallas else cg_pressure
        p = solve(state.p.contiguous(), div.contiguous(), num_cg_iters)
    ndt = -float(dt32)
    u = state.u.clone()
    u[..., :, :, 1:-1] = u[..., :, :, 1:-1] + ndt * (p[..., :, :, 1:] - p[..., :, :, :-1])
    v = state.v.clone()
    v[..., :, 1:-1, :] = v[..., :, 1:-1, :] + ndt * (p[..., :, 1:, :] - p[..., :, :-1, :])
    w = state.w.clone()
    w[..., 1:-1, :, :] = w[..., 1:-1, :, :] + ndt * (p[..., 1:, :, :] - p[..., :-1, :, :])
    state = state.replace(u=u, v=v, w=w, p=p)

    # 4. advection of the centred velocities, each seeing those already done
    uc, vc, wc = centered_velocities(state)
    uc_a = advect3d(uc, uc, vc, wc, dt, max_disp)
    vc_a = advect3d(vc, uc_a, vc, wc, dt, max_disp)
    wc_a = advect3d(wc, uc_a, vc_a, wc, dt, max_disp)
    density = advect3d(state.density, uc_a, vc_a, wc_a, dt, max_disp)

    # 5. back to the faces; decay
    return state.replace(u=_restagger(uc_a, -1), v=_restagger(vc_a, -2),
                         w=_restagger(wc_a, -3), density=density * 0.995)


def multi_step3d(
    state: SimState3D,
    num_steps: int,
    dt: float = 0.01,
    viscosity: float = 0.001,
    num_cg_iters: int = 30,
    max_disp: int = 1,
    use_pallas: bool = False,
    pressure_solver: str = "cg",
) -> Tuple[SimState3D, Tensor]:
    """`num_steps` steps; the final state and the density trajectory
    [..., num_steps, D, H, W]."""
    traj = []
    for _ in range(num_steps):
        state = step3d(state, dt=dt, viscosity=viscosity, num_cg_iters=num_cg_iters,
                       max_disp=max_disp, use_pallas=use_pallas,
                       pressure_solver=pressure_solver)
        traj.append(state.density)
    return state, torch.stack(traj, dim=-4)
