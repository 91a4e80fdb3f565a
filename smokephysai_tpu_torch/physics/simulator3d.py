"""Batched 3D episode generation for the volumetric configuration.

Counterpart of the JAX package's `physics/simulator3d.py`: sources ->
`solver3d.multi_step3d` -> chaos label over the volumes, over an explicit
leading episode axis where the JAX package vmaps one episode.

Routing of the pressure solve: the JAX package's `simulate_episode3d` never
passes `use_pallas`, so its episodes solve with the XLA CG. Here
`use_pallas` is an argument passed through to `step3d`: with it (the
dataset's default from `tpu.use_pallas`) each step solves with the CG
kernel on the card, and the plain CG runs only where asked for.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import chaos as chaos_mod
from . import solver3d

SOURCE_RADIUS = 8.0


def source_density3d(source_xyz: torch.Tensor, source_intensity: torch.Tensor,
                     source_active: torch.Tensor,
                     grid_size: Tuple[int, int, int]) -> torch.Tensor:
    """[N, D, H, W] initial densities: per episode the sum over its source
    slots of active * `solver3d.add_smoke_source3d` (radius 8 at (x, y, z),
    the slot's intensity). source_xyz is [N, S, 3], intensity and active
    [N, S]."""
    density = torch.zeros(source_xyz.shape[0], *grid_size, dtype=torch.float32,
                          device=source_xyz.device)
    at = lambda t, i: t[:, i, None, None, None]
    for i in range(source_xyz.shape[1]):
        blob = solver3d.add_smoke_source3d(
            torch.zeros_like(density), at(source_xyz[..., 0], i),
            at(source_xyz[..., 1], i), at(source_xyz[..., 2], i),
            radius=SOURCE_RADIUS, intensity=at(source_intensity, i))
        density = density + at(source_active, i) * blob
    return density


def simulate_episode3d(
    source_xyz: torch.Tensor,
    source_intensity: torch.Tensor,
    source_active: torch.Tensor,
    grid_size: Tuple[int, int, int] = (64, 64, 64),
    num_steps: int = 20,
    dt: float = 0.01,
    viscosity: float = 0.001,
    num_cg_iters: int = 30,
    pressure_solver: str = "cg",
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch of N whole 3D episodes on the source parameters' device.

    Args: source_xyz [N, S, 3] (x, y, z), source_intensity [N, S],
    source_active [N, S] in {0, 1}. Returns (sequences [N, num_steps, D, H,
    W], labels [N, 3])."""
    if source_xyz.dim() != 3 or source_xyz.shape[-1] != 3:
        raise ValueError(f"simulate_episode3d: source_xyz must be [N, S, 3], "
                         f"got {tuple(source_xyz.shape)}")
    dev = source_xyz.device
    state = solver3d.init_state3d(grid_size, device=dev, batch=(source_xyz.shape[0],))
    state = state.replace(density=source_density3d(
        source_xyz.float(), source_intensity.float().to(dev),
        source_active.float().to(dev), tuple(grid_size)))
    _, sequence = solver3d.multi_step3d(
        state, num_steps, dt=dt, viscosity=viscosity, num_cg_iters=num_cg_iters,
        use_pallas=use_pallas, pressure_solver=pressure_solver)
    return sequence, chaos_mod.chaos_features_from_sequence(sequence, spatial_dims=3)
