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
kernel; everything else is the plain per-op pipeline. Vorticity
confinement and the general gather advection (max_disp=0) are not ported
yet and raise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import fused_step as _fused
from ..ops.fused_step import tent_advect
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


def diffuse(field: Tensor, dt: float, viscosity: float) -> Tensor:
    """Explicit Euler diffusion with a replicate-padded 5-point Laplacian."""
    coef = np.float32(dt) * np.float32(viscosity)
    return _fused._diffuse(field, coef)


def advect(
    field: Tensor, u: Tensor, v: Tensor, dt: float, max_disp: int = 2
) -> Tensor:
    """Semi-Lagrangian advection: back-trace X - dt*vel, clamp, bilinear,
    in the gather-free tent-shift form, exact while the back-trace moves
    less than `max_disp` cells. The general gather path of the JAX package
    (max_disp=0) is not ported."""
    if max_disp <= 0:
        raise NotImplementedError("the gather advection path (max_disp=0) is not ported")
    return tent_advect(field, u, v, float(np.float32(dt)), max_disp)


def divergence(u: Tensor, v: Tensor, dt: float) -> Tensor:
    """Face-difference divergence scaled by 1/dt."""
    dt = torch.tensor(float(np.float32(dt)), dtype=u.dtype, device=u.device)
    return (u[..., 1:, :] - u[..., :-1, :] + v[..., :, 1:] - v[..., :, :-1]) / dt


def jacobi_pressure(p: Tensor, div: Tensor, num_iters: int = 20) -> Tensor:
    """`num_iters` Jacobi sweeps with a zero-Dirichlet boundary re-imposed
    every sweep."""
    return _fused._jacobi(p, div, num_iters)


def pressure_projection(state: SimState, dt: float, num_iters: int = 20) -> SimState:
    """Divergence, Jacobi solve, interior velocity correction."""
    div = divergence(state.u, state.v, dt)
    p = jacobi_pressure(state.p, div, num_iters)
    ndt = -float(np.float32(dt))
    u = state.u.clone()
    u[..., 1:-1, :] = u[..., 1:-1, :] + ndt * (p[..., 1:, :] - p[..., :-1, :])
    v = state.v.clone()
    v[..., :, 1:-1] = v[..., :, 1:-1] + ndt * (p[..., :, 1:] - p[..., :, :-1])
    return state.replace(u=u, v=v, p=p)


def step(
    state: SimState,
    dt: float = 0.01,
    viscosity: float = 0.001,
    num_jacobi_iters: int = 20,
    vorticity_eps: float = 0.0,
    use_pallas: bool = False,
    max_disp: int | None = None,
) -> SimState:
    """One solver step: buoyancy, diffusion, projection, advection, decay.

    `use_pallas=True` with `max_disp` None or positive runs the fused step
    kernel (max_disp 1 unless given) on any grid: it keeps the fields in
    global memory, so it has no size limit. Otherwise the plain per-op
    pipeline runs, with max_disp 2 unless given. Vorticity confinement and
    the gather path (max_disp=0) are not ported: they raise.
    """
    if vorticity_eps != 0.0:
        raise NotImplementedError("vorticity confinement is not ported")
    if max_disp is not None and max_disp <= 0:
        raise NotImplementedError("the gather advection path (max_disp=0) is not ported")
    if use_pallas:
        u, v, p, d = _fused.fused_step(
            state.u, state.v, state.p, state.density, dt, viscosity,
            num_jacobi_iters, max_disp=1 if max_disp is None else max_disp,
        )
        return SimState(u=u, v=v, p=p, density=d)
    if max_disp is None:
        max_disp = 2
    # 1. buoyancy (along the w slice of v)
    v = state.v.clone()
    v[..., :, :-1] = v[..., :, :-1] + float(np.float32(dt)) * (state.density * 0.1)
    state = state.replace(v=v)

    # 2. diffusion (density at a tenth of the viscosity, formed in float32)
    state = state.replace(
        u=diffuse(state.u, dt, viscosity),
        v=diffuse(state.v, dt, viscosity),
        density=diffuse(state.density, dt, np.float32(viscosity) * np.float32(0.1)),
    )

    # 3. pressure projection
    state = pressure_projection(state, dt, num_jacobi_iters)

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

    `use_pallas=True` runs the whole loop as one multi-step kernel launch
    (max_disp 1 unless given); otherwise a loop of `step` on the plain
    path (max_disp 2 unless given), the policy of `step`."""
    if vorticity_eps != 0.0:
        raise NotImplementedError("vorticity confinement is not ported")
    if max_disp is not None and max_disp <= 0:
        raise NotImplementedError("the gather advection path (max_disp=0) is not ported")
    if use_pallas:
        (u, v, p, d), traj = _fused.fused_multi_step(
            state.u, state.v, state.p, state.density, num_steps, dt, viscosity,
            num_jacobi_iters, max_disp=1 if max_disp is None else max_disp,
        )
        return SimState(u=u, v=v, p=p, density=d), traj
    traj = []
    for _ in range(num_steps):
        state = step(state, dt=dt, viscosity=viscosity,
                     num_jacobi_iters=num_jacobi_iters, max_disp=max_disp)
        traj.append(state.density)
    return state, torch.stack(traj, dim=-3)
