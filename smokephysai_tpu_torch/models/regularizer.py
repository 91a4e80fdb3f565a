"""Physics-regularisation losses, as the JAX package's `models/regularizer.py`
computes them: the same four terms, the same dict-keyed dispatch and the
fixed 0.5 divergence weight."""
from __future__ import annotations

from typing import Dict, Optional

import torch

Tensor = torch.Tensor


def mass_conservation_loss(density_pred: Tensor, density_target: Tensor,
                           reduce: str = "sum") -> Tensor:
    """MSE of per-image total mass (or per-voxel mean mass with
    reduce="mean"), summed over every axis but the first."""
    axes = tuple(range(1, density_pred.dim()))
    op = torch.sum if reduce == "sum" else torch.mean
    return torch.mean((op(density_pred, dim=axes) - op(density_target, dim=axes)) ** 2)


def continuity_loss(density_sequence: Tensor) -> Tensor:
    """Mean |d(density)/dt| over a [B, T, ...] sequence; 0 for T < 2."""
    if density_sequence.shape[1] < 2:
        return density_sequence.new_zeros((), dtype=torch.float32)
    return torch.mean(torch.abs(density_sequence[:, 1:] - density_sequence[:, :-1]))


def energy_conservation_loss(velocity_pred: Tensor) -> Tensor:
    """Mean positive kinetic-energy increase along the leading axis."""
    kinetic = 0.5 * torch.sum(velocity_pred ** 2, dim=1)
    if kinetic.shape[0] <= 1:
        return velocity_pred.new_zeros((), dtype=torch.float32)
    return torch.mean(torch.clamp_min(kinetic[1:] - kinetic[:-1], 0.0))


def divergence_loss(velocity: Tensor) -> Tensor:
    """Mean squared forward-difference divergence of a [B, 2, H, W] field,
    the two differences cropped to a common shape; 0 for another channel
    count."""
    if velocity.shape[1] != 2:
        return velocity.new_zeros((), dtype=torch.float32)
    u, v = velocity[:, 0], velocity[:, 1]
    du_dx = u[:, :, 1:] - u[:, :, :-1]
    dv_dy = v[:, 1:, :] - v[:, :-1, :]
    min_h = min(du_dx.shape[1], dv_dy.shape[1])
    min_w = min(du_dx.shape[2], dv_dy.shape[2])
    div = du_dx[:, :min_h, :min_w] + dv_dy[:, :min_h, :min_w]
    return torch.mean(div ** 2)


def physics_losses(
    predictions: Dict[str, Tensor],
    targets: Optional[Dict[str, Tensor]] = None,
    conservation_weight: float = 1.0,
    continuity_weight: float = 1.0,
    energy_weight: float = 0.5,
    mass_reduce: str = "sum",
) -> Dict[str, Tensor]:
    """Per-term losses for the keys present, plus 'total_physics_loss'."""
    losses: Dict[str, Tensor] = {}
    ref = next(iter(predictions.values()))
    total = ref.new_zeros((), dtype=torch.float32)
    if "density" in predictions and targets and "density" in targets:
        mass = mass_conservation_loss(predictions["density"], targets["density"],
                                      reduce=mass_reduce)
        losses["mass_conservation"] = mass
        total = total + conservation_weight * mass
    if "density_sequence" in predictions:
        cont = continuity_loss(predictions["density_sequence"])
        losses["continuity"] = cont
        total = total + continuity_weight * cont
    if "velocity" in predictions:
        energy = energy_conservation_loss(predictions["velocity"])
        losses["energy_conservation"] = energy
        total = total + energy_weight * energy
        div = divergence_loss(predictions["velocity"])
        losses["divergence"] = div
        total = total + 0.5 * div  # fixed weight, as in the JAX package
    losses["total_physics_loss"] = total
    return losses
