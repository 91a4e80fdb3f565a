"""Smoke simulation facade and the batched episode generator.

Counterpart of the JAX package's `physics/simulator.py`: `SmokeSimulator`
owns a state, steps it, keeps a bounded history of the recorded
(fractal-perturbed) frames and reports its chaos features, with the
reference quirk that the perturbation is applied to the recorded frame
only, never written back into the solver state. `simulate_episode` runs a
batch of whole episodes (sources -> `solver.multi_step` -> perturbation ->
chaos label) over an explicit leading episode axis, where the JAX package
vmaps one episode. The domain-decomposed (mesh) stepping is not ported.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import chaos as chaos_mod
from . import solver
from .fractal import apply_fractal_perturbation, fractal_field

FRACTAL_INTENSITY = 0.05
INCENSE_RADIUS = 8.0
MAX_HISTORY = 100


class SmokeSimulator:
    """Stateful wrapper around `solver.step` on one device."""

    def __init__(
        self,
        grid_size: Tuple[int, int] = (128, 128),
        dt: float = 0.01,
        viscosity: float = 0.001,
        num_jacobi_iters: int = 20,
        vorticity_eps: float = 0.0,
        use_pallas: bool = False,
        device="cuda",
    ):
        """`use_pallas=True` (the config's `tpu.use_pallas`) steps through
        the fused step kernel, or with `vorticity_eps` > 0 through the
        per-op step's stencil and Jacobi kernels, as the JAX package steps
        through its Pallas kernels."""
        self.grid_size = tuple(grid_size)
        self.dt = dt
        self.viscosity = viscosity
        self.num_jacobi_iters = num_jacobi_iters
        self.vorticity_eps = vorticity_eps
        self.use_pallas = use_pallas
        self.device = torch.device(device)
        self.state = solver.init_state(self.grid_size, device=self.device)
        self.history: List[torch.Tensor] = []
        self.max_history = MAX_HISTORY
        self._fractal = fractal_field(self.grid_size, device=self.device)

    def reset(self):
        self.state = solver.init_state(self.grid_size, device=self.device)
        self.history = []

    def add_incense_source(self, positions, intensities):
        """Radius-8 Gaussian sources at (x, y) positions."""
        density = self.state.density
        for (x, y), intensity in zip(positions, intensities):
            density = solver.add_smoke_source(
                density, float(x), float(y), radius=INCENSE_RADIUS,
                intensity=float(intensity),
            )
        self.state = self.state.replace(density=density)

    def simulate_step(self, add_fractal: bool = True) -> torch.Tensor:
        """One solver step; the perturbed frame is recorded and returned,
        not fed back."""
        self.state = solver.step(
            self.state,
            dt=self.dt,
            viscosity=self.viscosity,
            num_jacobi_iters=self.num_jacobi_iters,
            vorticity_eps=self.vorticity_eps,
            use_pallas=self.use_pallas,
        )
        density = self.state.density
        if add_fractal:
            density = apply_fractal_perturbation(
                density, FRACTAL_INTENSITY, self._fractal
            )
        self.history.append(density)
        if len(self.history) > self.max_history:
            self.history.pop(0)
        return density

    def get_chaos_features(self) -> Dict[str, float]:
        """{lyapunov_exponent, fractal_dimension, entropy} of the last (up
        to 20) recorded frames once 10 exist, else {}."""
        if len(self.history) < 10:
            return {}
        n = min(len(self.history), chaos_mod.LYAPUNOV_WINDOW)
        tail = torch.stack(self.history[-chaos_mod.LYAPUNOV_WINDOW:])
        lyap, fd, ent = chaos_mod.chaos_features(tail, n).tolist()
        return {"lyapunov_exponent": lyap, "fractal_dimension": fd, "entropy": ent}


def source_density(
    source_xy: torch.Tensor, source_intensity: torch.Tensor,
    source_active: torch.Tensor, grid_size: Tuple[int, int],
) -> torch.Tensor:
    """[N, H, W] initial densities: per episode the sum over its source
    slots of active * `solver.add_smoke_source` (radius 8 at (x, y), the
    slot's intensity). source_xy is [N, S, 2] (x, y), intensity and active
    [N, S]."""
    density = torch.zeros(source_xy.shape[0], *grid_size, dtype=torch.float32,
                          device=source_xy.device)
    for i in range(source_xy.shape[1]):
        blob = solver.add_smoke_source(
            torch.zeros_like(density), source_xy[:, i, 0, None, None],
            source_xy[:, i, 1, None, None], radius=INCENSE_RADIUS,
            intensity=source_intensity[:, i, None, None])
        density = density + source_active[:, i, None, None] * blob
    return density


def simulate_episode(
    source_xy: torch.Tensor,
    source_intensity: torch.Tensor,
    source_active: torch.Tensor,
    grid_size: Tuple[int, int] = (128, 128),
    num_steps: int = 20,
    dt: float = 0.01,
    viscosity: float = 0.001,
    num_jacobi_iters: int = 20,
    vorticity_eps: float = 0.0,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch of N whole episodes on the source parameters' device:
    sources -> `solver.multi_step` (with `use_pallas`, one multi-step kernel
    launch for the batch, or with vorticity confinement `num_steps` per-op
    steps through the stencil and Jacobi kernels) -> fractal perturbation
    of the recorded frames -> episode-averaged chaos label.

    Args: source_xy [N, S, 2] (x, y), source_intensity [N, S], source_active
    [N, S] in {0, 1} (inactive slots are masked). Returns (sequences
    [N, num_steps, H, W], labels [N, 3])."""
    if source_xy.dim() != 3 or source_xy.shape[-1] != 2:
        raise ValueError(f"simulate_episode: source_xy must be [N, S, 2], "
                         f"got {tuple(source_xy.shape)}")
    dev = source_xy.device
    n = source_xy.shape[0]
    state = solver.init_state(grid_size, device=dev, batch=(n,))
    density = source_density(source_xy.float(), source_intensity.float().to(dev),
                             source_active.float().to(dev), grid_size)
    state = state.replace(density=density)
    _, sequence = solver.multi_step(
        state, num_steps, dt=dt, viscosity=viscosity,
        num_jacobi_iters=num_jacobi_iters, vorticity_eps=vorticity_eps,
        use_pallas=use_pallas,
    )
    sequence = apply_fractal_perturbation(
        sequence, FRACTAL_INTENSITY, fractal_field(tuple(grid_size), device=dev))
    return sequence, chaos_mod.chaos_features_from_sequence(sequence)
