"""2D incompressible Navier-Stokes smoke solver on tensors.

Counterpart of the JAX package's `physics/solver.py`, with the same
numerics and the reference solver's quirks kept on purpose: buoyancy added
along the w slice of v, u advected first and v with the updated u, a
zero-boundary warm-started Jacobi pressure solve, and the clamped
staggered-to-centre velocity sampling.

Fields may carry a leading batch of episodes. `step(use_pallas=True)` runs
the whole step as one CUDA kernel (`ops/fused_step.py`) on every grid (the
JAX package's fused Pallas kernel runs only on grids whose fields fit in
VMEM), and `multi_step(use_pallas=True)` a whole episode of steps as one
kernel, unless vorticity confinement is on or `max_disp=0` asks for the
gather advection. Those take the per-op pipeline, whose diffusions and
Jacobi solve run as the stencil and Jacobi kernels (`ops/stencil.py`,
`ops/jacobi.py`) under `use_pallas` and as their plain versions without.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import fused_step as _fused
from ..ops import jacobi as _jacobi
from ..ops import stencil as _stencil
from ..ops.fused_step import tent_advect
from ..ops.stencil import shift
from .state import SimState

Tensor = torch.Tensor


def init_state(
    grid_size: Tuple[int, int], device="cuda", dtype=torch.float32, batch=(),
) -> SimState:
    """Zero state; `batch` is a tuple of leading episode dims."""
    h, w = grid_size
    z = lambda *s: torch.zeros(*batch, *s, dtype=dtype, device=device)
    return SimState(u=z(h + 1, w), v=z(h, w + 1), p=z(h, w), density=z(h, w))


def add_smoke_source(
    density: Tensor, x, y, radius: float = 10.0, intensity=1.0,
) -> Tensor:
    """Gaussian blob, sigma = radius/3, truncated at `radius`. `x`, `y`
    and `intensity` are numbers or float32 tensors that broadcast against
    [H, W] (for example [N, 1, 1], one blob per episode)."""
    h, w = density.shape[-2], density.shape[-1]
    y_grid = torch.arange(h, dtype=torch.float32, device=density.device)[:, None]
    x_grid = torch.arange(w, dtype=torch.float32, device=density.device)[None, :]
    dist = torch.sqrt((x_grid - x) ** 2 + (y_grid - y) ** 2)
    sigma2 = 2.0 * (radius / 3.0) ** 2
    blob = intensity * torch.exp(-(dist**2) / sigma2)
    return density + torch.where(dist <= radius, blob, torch.zeros_like(blob))


def bilinear_interpolate(field: Tensor, y: Tensor, x: Tensor) -> Tensor:
    """Bilinear sample of `field` [..., h, w] at float coordinates (y, x),
    which broadcast against the field's leading dims: corner indices
    clamped, the weights formed from the unclamped lower corner, a flat
    gather of the four corners."""
    h, w = field.shape[-2], field.shape[-1]
    lead = field.shape[:-2]
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x0c = x0.clamp(0, w - 1)
    y0c = y0.clamp(0, h - 1)
    dtype = field.dtype
    wa = (x1.to(dtype) - x) * (y1.to(dtype) - y)
    wb = (x - x0.to(dtype)) * (y1.to(dtype) - y)
    wc = (x1.to(dtype) - x) * (y - y0.to(dtype))
    wd = (x - x0.to(dtype)) * (y - y0.to(dtype))
    shape = torch.broadcast_shapes(y.shape, x.shape, (*lead, 1, 1))
    flat = field.reshape(*lead, h * w)

    def g(yy, xx):
        idx = (yy * w + xx).expand(shape).reshape(*lead, -1)
        return torch.gather(flat, -1, idx).reshape(shape)

    return wa * g(y0c, x0c) + wb * g(y0c, x1) + wc * g(y1, x0c) + wd * g(y1, x1)


def _sample_u_at_centers(u: Tensor, y: Tensor, x: Tensor) -> Tensor:
    """u lives at (i, j + 0.5): sample it at cell centres with a +0.5 x
    offset, clamped."""
    return bilinear_interpolate(u, y, torch.clamp(x + 0.5, 0, u.shape[-1] - 1))


def _sample_v_at_centers(v: Tensor, y: Tensor, x: Tensor) -> Tensor:
    """v lives at (i + 0.5, j): sample it at cell centres with a +0.5 y
    offset, clamped."""
    return bilinear_interpolate(v, torch.clamp(y + 0.5, 0, v.shape[-2] - 1), x)


def _centres(h: int, w: int, like: Tensor) -> Tuple[Tensor, Tensor]:
    """Cell-centre row and column coordinates, [h, w] each."""
    y_c = torch.arange(h, dtype=like.dtype, device=like.device)[:, None].expand(h, w)
    x_c = torch.arange(w, dtype=like.dtype, device=like.device)[None, :].expand(h, w)
    return y_c, x_c


def advect(
    field: Tensor, u: Tensor, v: Tensor, dt: float, max_disp: int = 2
) -> Tensor:
    """Semi-Lagrangian advection: back-trace X - dt*vel, clamp, bilinear.
    With `max_disp` > 0 in the gather-free tent-shift form, exact while the
    back-trace moves less than `max_disp` cells; with `max_disp` <= 0 the
    general gather path (centred velocities and the field sampled by
    `bilinear_interpolate`)."""
    dt = float(np.float32(dt))
    if max_disp > 0:
        return tent_advect(field, u, v, dt, max_disp)
    h, w = field.shape[-2], field.shape[-1]
    y_c, x_c = _centres(h, w, field)
    u_i = _sample_u_at_centers(u, y_c, x_c)
    v_i = _sample_v_at_centers(v, y_c, x_c)
    prev_x = torch.clamp(x_c - dt * u_i, 0, w - 1)
    prev_y = torch.clamp(y_c - dt * v_i, 0, h - 1)
    return bilinear_interpolate(field, prev_y, prev_x)


def divergence(u: Tensor, v: Tensor, dt: float) -> Tensor:
    """Face-difference divergence scaled by 1/dt."""
    dt = torch.tensor(float(np.float32(dt)), dtype=u.dtype, device=u.device)
    return (u[..., 1:, :] - u[..., :-1, :] + v[..., :, 1:] - v[..., :, :-1]) / dt


def pressure_projection(
    state: SimState, dt: float, num_iters: int = 20, jacobi_fn=None
) -> SimState:
    """Divergence, `num_iters` zero-Dirichlet Jacobi sweeps (`jacobi_fn`,
    the plain version unless given), interior velocity correction."""
    div = divergence(state.u, state.v, dt)
    p = (jacobi_fn or _jacobi.jacobi_pressure_reference)(state.p, div, num_iters)
    ndt = -float(np.float32(dt))
    u = state.u.clone()
    u[..., 1:-1, :] = u[..., 1:-1, :] + ndt * (p[..., 1:, :] - p[..., :-1, :])
    v = state.v.clone()
    v[..., :, 1:-1] = v[..., :, 1:-1] + ndt * (p[..., :, 1:] - p[..., :, :-1])
    return state.replace(u=u, v=v, p=p)


def vorticity_confinement(state: SimState, dt: float, eps: float) -> SimState:
    """Vorticity-confinement force (Fedkiw et al. 2001), cell-centred:
    w = dv/dx - du/dy from the centred velocities, N = grad|w| normalised
    by |grad|w|| + 1e-6, force eps * (N x w) added (times dt) to the faces
    u[:-1] and v[:, :-1]. Central differences with edge padding."""
    h, w = state.density.shape[-2], state.density.shape[-1]
    y_c, x_c = _centres(h, w, state.u)
    uc = _sample_u_at_centers(state.u, y_c, x_c)
    vc = _sample_v_at_centers(state.v, y_c, x_c)

    def ddx(f):
        return 0.5 * (shift(f, 0, 1, "edge") - shift(f, 0, -1, "edge"))

    def ddy(f):
        return 0.5 * (shift(f, 1, 0, "edge") - shift(f, -1, 0, "edge"))

    w_z = ddx(vc) - ddy(uc)
    aw = torch.abs(w_z)
    nx, ny = ddx(aw), ddy(aw)
    mag = torch.sqrt(nx * nx + ny * ny) + 1e-6
    nx, ny = nx / mag, ny / mag
    eps = float(np.float32(eps))
    fx = eps * (ny * w_z)
    fy = eps * (-nx * w_z)
    dtf = float(np.float32(dt))
    u = state.u.clone()
    u[..., :-1, :] = u[..., :-1, :] + dtf * fx
    v = state.v.clone()
    v[..., :, :-1] = v[..., :, :-1] + dtf * fy
    return state.replace(u=u, v=v)


def _takes_fused(use_pallas: bool, vorticity_eps: float, max_disp) -> bool:
    """The fused kernels run the whole step: with `use_pallas`, no
    vorticity confinement and the tent-shift advection (as in JAX)."""
    return use_pallas and vorticity_eps == 0.0 and (max_disp is None or max_disp > 0)


def step(
    state: SimState,
    dt: float = 0.01,
    viscosity: float = 0.001,
    num_jacobi_iters: int = 20,
    vorticity_eps: float = 0.0,
    use_pallas: bool = False,
    max_disp: int | None = None,
) -> SimState:
    """One solver step: buoyancy, vorticity confinement (when
    `vorticity_eps` > 0), diffusion, projection, advection, decay.

    `use_pallas=True` with no vorticity confinement and `max_disp` None or
    positive runs the fused step kernel (max_disp 1 unless given) on any
    grid: it keeps the fields in global memory, so it has no size limit.
    Otherwise the per-op pipeline runs, with max_disp 2 unless given
    (0: the gather advection); under `use_pallas` its three diffusions are
    one launch of the stencil kernel and its Jacobi solve the Jacobi kernel,
    as the JAX package's are three `diffuse_pallas` and one
    `jacobi_pressure_pallas`.
    """
    if _takes_fused(use_pallas, vorticity_eps, max_disp):
        u, v, p, d = _fused.fused_step(
            state.u, state.v, state.p, state.density, dt, viscosity,
            num_jacobi_iters, max_disp=1 if max_disp is None else max_disp,
        )
        return SimState(u=u, v=v, p=p, density=d)
    if max_disp is None:
        max_disp = 2
    jacobi_fn = _jacobi.jacobi_pressure if use_pallas else _jacobi.jacobi_pressure_reference

    # 1. buoyancy (along the w slice of v)
    v = state.v.clone()
    v[..., :, :-1] = v[..., :, :-1] + float(np.float32(dt)) * (state.density * 0.1)
    state = state.replace(v=v)

    if vorticity_eps > 0.0:
        state = vorticity_confinement(state, dt, vorticity_eps)

    # 2. diffusion (density at a tenth of the viscosity, formed in float32);
    # under use_pallas the three fields in one launch of the stencil kernel
    dt32, visc32 = np.float32(dt), np.float32(viscosity)
    coef_uv, coef_d = dt32 * visc32, dt32 * (visc32 * np.float32(0.1))
    if use_pallas:
        u, v, d = _stencil.diffuse_fields(state.u, state.v, state.density, coef_uv, coef_d)
    else:
        diffuse = _stencil.diffuse_reference
        u, v, d = (diffuse(state.u, coef_uv), diffuse(state.v, coef_uv),
                   diffuse(state.density, coef_d))
    state = state.replace(u=u, v=v, density=d)

    # 3. pressure projection
    state = pressure_projection(state, dt, num_jacobi_iters, jacobi_fn)

    # 4. advection: v sees the new u, density sees both
    u = advect(state.u, state.u, state.v, dt, max_disp)
    v = advect(state.v, u, state.v, dt, max_disp)
    density = advect(state.density, u, v, dt, max_disp)

    # 5. decay
    return state.replace(u=u, v=v, density=density * 0.995)


def multi_step(
    state: SimState,
    num_steps: int,
    dt: float = 0.01,
    viscosity: float = 0.001,
    num_jacobi_iters: int = 20,
    vorticity_eps: float = 0.0,
    use_pallas: bool = False,
    max_disp: int | None = None,
) -> Tuple[SimState, Tensor]:
    """`num_steps` solver steps; returns the final state and the density
    trajectory [..., num_steps, H, W] (episodes of a leading batch stay
    first, as the JAX package's vmapped call returns them).

    Where `step` would take the fused kernel (`use_pallas`, no vorticity
    confinement, `max_disp` None or positive) the whole loop is one
    multi-step kernel launch (max_disp 1 unless given); otherwise it is a
    loop of `step`, whose per-op path runs the stencil and Jacobi kernels
    under `use_pallas`."""
    if _takes_fused(use_pallas, vorticity_eps, max_disp):
        (u, v, p, d), traj = _fused.fused_multi_step(
            state.u, state.v, state.p, state.density, num_steps, dt, viscosity,
            num_jacobi_iters, max_disp=1 if max_disp is None else max_disp,
        )
        return SimState(u=u, v=v, p=p, density=d), traj
    traj = []
    for _ in range(num_steps):
        state = step(state, dt=dt, viscosity=viscosity,
                     num_jacobi_iters=num_jacobi_iters, vorticity_eps=vorticity_eps,
                     use_pallas=use_pallas, max_disp=max_disp)
        traj.append(state.density)
    return state, torch.stack(traj, dim=-3)
