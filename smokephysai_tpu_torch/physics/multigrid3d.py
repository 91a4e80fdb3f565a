"""Geometric multigrid pressure solve for the 3D projection step.

Counterpart of the JAX package's `physics/multigrid3d.py`, with the same
numerics: damped-Jacobi V(2,2) cycles (omega 6/7), 24 relaxations at the
coarsest level, coarsening while every dim is even and >= 8; a level's
operator is the zero-Dirichlet 7-point stencil with the boundary ghost
correction that keeps the Dirichlet plane at the fine grid's location;
2x2x2 block-mean restriction; cell-centred trilinear prolongation.

`pressure_solver="mg"` on `solver3d.step3d` selects it instead of the CG
solve. The JAX functions act on one volume under the simulator's vmap;
these take [..., D, H, W] and keep the leading episode axes. Plain PyTorch
ops: the JAX module has no Pallas kernel.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..ops.cg3d import laplacian_dirichlet

Tensor = torch.Tensor

OMEGA = 6.0 / 7.0
NU_PRE = 2
NU_POST = 2
NU_COARSE = 24
MIN_COARSE = 4


def _neg_lap(p: Tensor) -> Tensor:
    """-Lap(p) with p = 0 outside the volume (zero-pad Dirichlet), unit
    spacing, over the last three dims: the CG solve's stencil negated. It
    sums the six neighbours in the JAX module's order, and -(s - 6 p) is
    6 p - s to the bit."""
    return -laplacian_dirichlet(p)


def _ghost_coef(level: int) -> float:
    """Ghost-cell coefficient of a coarse level: a level-l centre sits
    alpha = (2^l + 1) / 2^(l+1) coarse cells from the fine grid's Dirichlet
    plane, so ghost = (1 - 1/alpha) * the adjacent cell."""
    alpha = (2.0 ** level + 1.0) / 2.0 ** (level + 1)
    return 1.0 - 1.0 / alpha


def _boundary_count(shape: Tuple[int, int, int], device: torch.device) -> Tensor:
    """[D, H, W]: the number of the volume's faces each cell touches."""
    m = torch.zeros(shape, dtype=torch.float32, device=device)
    for axis, n in enumerate(shape):
        view = [1, 1, 1]
        view[axis] = n
        idx = torch.arange(n, device=device).view(view)
        m = m + ((idx == 0) | (idx == n - 1)).to(torch.float32)
    return m


@functools.lru_cache(maxsize=64)
def _level_terms(shape: Tuple[int, int, int], level: int,
                 device: torch.device) -> Tuple[Tensor, Tensor]:
    """A level's constants, built once per shape and device: the ghost
    term's factor coef * faces and the Jacobi scale omega / diag, diag =
    (6 - coef * faces) * 0.25^level (JAX's expressions, in its order)."""
    ghost = _ghost_coef(level) * _boundary_count(shape, device)
    return ghost, OMEGA / ((6.0 - ghost) * 0.25 ** level)


def _neg_lap_level(p: Tensor, level: int) -> Tensor:
    """Level-l operator: the 7-point stencil plus the ghost correction
    (level 0 is `_neg_lap`)."""
    if level == 0:
        return _neg_lap(p)
    ghost, _ = _level_terms(tuple(p.shape[-3:]), level, p.device)
    return _neg_lap(p) - ghost * p


def _smooth(x: Tensor, b: Tensor, level: int, n: int) -> Tensor:
    """n damped-Jacobi sweeps on (0.25^level * `_neg_lap_level`) x = b."""
    inv_h2 = 0.25 ** level
    _, scale = _level_terms(tuple(x.shape[-3:]), level, x.device)
    for _ in range(n):
        x = x + scale * (b - inv_h2 * _neg_lap_level(x, level))
    return x


def _restrict(r: Tensor) -> Tensor:
    """2x2x2 block mean of the last three dims."""
    *lead, d, h, w = r.shape
    return r.reshape(*lead, d // 2, 2, h // 2, 2, w // 2, 2).mean(dim=(-5, -3, -1))


def _prolong_axis(c: Tensor, axis: int) -> Tensor:
    """Cell-centred linear interpolation along `axis` (-3, -2 or -1), n ->
    2n: fine cell 2i takes 3/4 of coarse i and 1/4 of i - 1, 2i + 1 3/4 of
    i and 1/4 of i + 1; beyond the volume the Dirichlet zero."""
    n = c.shape[axis]
    zero = torch.zeros_like(c.narrow(axis, 0, 1))
    prev = torch.cat([zero, c.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([c.narrow(axis, 1, n - 1), zero], dim=axis)
    even = 0.75 * c + 0.25 * prev
    odd = 0.75 * c + 0.25 * nxt
    return torch.stack([even, odd], dim=axis).flatten(axis - 1, axis)


def _prolong(c: Tensor) -> Tensor:
    return _prolong_axis(_prolong_axis(_prolong_axis(c, -3), -2), -1)


def num_levels(shape: Tuple[int, int, int]) -> int:
    """Levels of the V-cycle: halve while every dim is even and >=
    2 * MIN_COARSE (1: no coarsening, the smoother alone)."""
    levels = 1
    dims = list(shape)
    while all(d % 2 == 0 and d >= 2 * MIN_COARSE for d in dims):
        dims = [d // 2 for d in dims]
        levels += 1
    return levels


def _vcycle(x: Tensor, b: Tensor, level: int, coarsest: int) -> Tensor:
    inv_h2 = 0.25 ** level
    if level == coarsest:
        return _smooth(x, b, level, NU_COARSE)
    x = _smooth(x, b, level, NU_PRE)
    rc = _restrict(b - inv_h2 * _neg_lap_level(x, level))
    ec = _vcycle(torch.zeros_like(rc), rc, level + 1, coarsest)
    x = x + _prolong(ec)
    return _smooth(x, b, level, NU_POST)


def mg_pressure(p0: Tensor, div: Tensor, num_cycles: int = 2) -> Tensor:
    """Solve -Lap(p) = -div warm-started from p0 by `num_cycles` V(2,2)
    cycles: the counterpart of the CG solve for `pressure_solver="mg"`.
    p0 and div are [..., D, H, W]."""
    b = -div
    coarsest = num_levels(tuple(div.shape[-3:])) - 1
    p = p0
    for _ in range(num_cycles):
        p = _vcycle(p, b, 0, coarsest)
    return p
