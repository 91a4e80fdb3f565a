"""Streaming: one solver step, the fractal perturbation and the model's eval
forward per frame, the state never leaving the device.

Counterpart of the JAX package's `train/streaming.py`. `make_streaming_step`
returns one frame as a function of the state; `streaming_rollout` runs
`num_frames` of them and writes each frame's physics features [T, 3] and
perturbed frame [T, H, W] into tensors allocated once, with no wait for the
card inside the loop (the caller's first read of a result waits once).

A frame is `solver.step` (the fused step kernel under `use_pallas` on the
card), `frame = density * (1 + FRACTAL_INTENSITY * F)` with the fractal F
computed on the device once per grid (at the step's first frame of that
grid, so no later frame copies it from the host), and the model's eval
forward at batch 1. The rollout loops over the streaming step, so one
per-frame path serves both. The JAX
package passes the same chaos key on every frame, so every frame sees the
same per-layer chaos fields: here they are drawn once from a generator
seeded with `chaos_seed` (or given as `chaos_fields`) and reused. Where a
frame's reconstruction is not returned (the rollout, or
`return_reconstruction=False`) only the encoder, the trunk and the physics
head run, as XLA leaves the unused decoder out of the JAX program.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from ..models.net import SmokePhysNet
from ..physics import solver
from ..physics.fractal import apply_fractal_perturbation, fractal_field
from ..physics.simulator import FRACTAL_INTENSITY
from ..physics.state import SimState

Tensor = torch.Tensor


def _stream_fields(model: SmokePhysNet, chaos_seed: int,
                   chaos_fields: Sequence[Tensor] | None, device) -> list:
    """The per-layer chaos fields every frame sees, float32 on `device`."""
    if chaos_fields is None:
        chaos_fields = model.chaos_fields(torch.Generator().manual_seed(chaos_seed), 1, device)
    if len(chaos_fields) != model.num_layers:
        raise ValueError(f"streaming: {len(chaos_fields)} chaos fields for "
                         f"{model.num_layers} layers")
    return [f.to(device, torch.float32) for f in chaos_fields]


def _physics_features(model: SmokePhysNet, frame: Tensor, fields) -> Tensor:
    """[3] physics features of one [H, W] frame: encoder, trunk, physics
    head."""
    feats = model.trunk(model.encode(frame[None, None]), fields)
    return model.physics(feats)[0][0]


def make_streaming_step(
    model: SmokePhysNet,
    dt: float = 0.01,
    viscosity: float = 0.001,
    num_jacobi_iters: int = 20,
    use_pallas: bool = True,
    vorticity_eps: float = 0.0,
    chaos_seed: int = 0,
    return_reconstruction: bool = True,
    chaos_fields: Sequence[Tensor] | None = None,
) -> Callable[[SimState], Tuple[SimState, Dict[str, Tensor]]]:
    """One frame: state -> (next state, {"physics_features" [3], "frame"
    [H, W], and "reconstructed" [H, W] (resized to the grid) with
    `return_reconstruction`})."""
    model.eval()
    device = next(model.parameters()).device
    fields = _stream_fields(model, chaos_seed, chaos_fields, device)
    fractals = {}  # grid -> its fractal on the device, made at its first frame

    @torch.inference_mode()
    def stream_step(state: SimState) -> Tuple[SimState, Dict[str, Tensor]]:
        state = solver.step(state, dt=dt, viscosity=viscosity,
                            num_jacobi_iters=num_jacobi_iters,
                            vorticity_eps=vorticity_eps, use_pallas=use_pallas)
        grid = tuple(state.density.shape)
        if grid not in fractals:
            fractals[grid] = fractal_field(grid, device=state.density.device)
        frame = apply_fractal_perturbation(state.density, FRACTAL_INTENSITY, fractals[grid])
        if not return_reconstruction:
            return state, {"physics_features": _physics_features(model, frame, fields),
                           "frame": frame}
        out = model(frame[None, :, :, None], chaos_fields=fields)
        return state, {"physics_features": out["physics_features"][0], "frame": frame,
                       "reconstructed": out["reconstructed"][0, :, :, 0]}

    return stream_step


def streaming_rollout(
    model: SmokePhysNet,
    state: SimState,
    num_frames: int,
    dt: float = 0.01,
    viscosity: float = 0.001,
    num_jacobi_iters: int = 20,
    use_pallas: bool = True,
    chaos_seed: int = 0,
    chaos_fields: Sequence[Tensor] | None = None,
) -> Tuple[SimState, Dict[str, Tensor]]:
    """`num_frames` frames from one episode's state ([H, W] fields): the
    final state and {"physics_features" [T, 3], "frame" [T, H, W]} on the
    state's device. No vorticity confinement, as in the JAX package."""
    if state.density.dim() != 2:
        raise ValueError(f"streaming_rollout: one episode's [H, W] fields, got density "
                         f"of shape {tuple(state.density.shape)}")
    step = make_streaming_step(model, dt, viscosity, num_jacobi_iters, use_pallas,
                               chaos_seed=chaos_seed, return_reconstruction=False,
                               chaos_fields=chaos_fields)
    device, grid = state.density.device, tuple(state.density.shape)
    with torch.inference_mode():
        feats = torch.empty(num_frames, 3, device=device)
        frames = torch.empty(num_frames, *grid, device=device, dtype=state.density.dtype)
        for t in range(num_frames):
            state, out = step(state)
            feats[t], frames[t] = out["physics_features"], out["frame"]
    return state, {"physics_features": feats, "frame": frames}
