"""Chaos-modulated multi-head attention.

Counterpart of the JAX package's `models/chaos_attention.py`. The Lorenz
initial condition comes from an explicit `torch.Generator`, and the gated
chaos scores are folded into the query before the score product:

    q k^T + s * g * (c k^T) == (q + s * g * c) k^T

so one attention call (the flash kernel, or the einsum path) computes the
reference's two-product attention.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..ops.attention import flash_attention_tokens_trainable
from .layers import Linear

Tensor = torch.Tensor

LORENZ_SIGMA = 10.0
LORENZ_RHO = 28.0
LORENZ_BETA = 8.0 / 3.0
LORENZ_DT = 0.01
LORENZ_STEPS = 5


def lorenz_trajectory(init: Tensor, steps: int = LORENZ_STEPS) -> Tensor:
    """[..., steps, 3] Euler-integrated Lorenz states from `init` [..., 3]."""
    states = []
    s = init
    for _ in range(steps):
        x, y, z = s[..., 0], s[..., 1], s[..., 2]
        dx = LORENZ_SIGMA * (y - x)
        dy = x * (LORENZ_RHO - z) - y
        dz = x * y - LORENZ_BETA * z
        s = torch.stack(
            [x + LORENZ_DT * dx, y + LORENZ_DT * dy, z + LORENZ_DT * dz], dim=-1
        )
        states.append(s)
    return torch.stack(states, dim=-2)


def chaos_fields(
    generator: torch.Generator, layers: int, batch: int, seq_len: int,
    device="cuda",
) -> Tensor:
    """[layers, B, L, 3]: per layer, the 5-step Lorenz trajectory from a
    0.1 * N(0, 1) start drawn from `generator`, tiled along the sequence.

    All layers' starts are drawn in one call and integrated in one batched
    pass where the generator lives. From a host generator only the
    [layers, B, 5, 3] trajectory goes to the card, in one copy from pinned
    memory that does not wait for the card's queued work; the tiling runs
    on `device`."""
    init = 0.1 * torch.randn(layers, batch, 3, generator=generator,
                             device=generator.device, dtype=torch.float32)
    traj = lorenz_trajectory(init)
    device = torch.device(device)
    if traj.device.type == "cpu" and device.type == "cuda":
        traj = traj.pin_memory().to(device, non_blocking=True)
    else:
        traj = traj.to(device)
    n_repeats = -(-seq_len // LORENZ_STEPS)
    return traj.repeat(1, 1, n_repeats, 1)[:, :, :seq_len, :]


def chaos_field(
    generator: torch.Generator, batch: int, seq_len: int, device="cuda"
) -> Tensor:
    """[B, L, 3]: one layer's chaos field (`chaos_fields` with one layer)."""
    return chaos_fields(generator, 1, batch, seq_len, device)[0]


class ChaosAttention(nn.Module):
    """MHA plus Lorenz-gated additive chaos scores; token-major [B, L, D]."""

    def __init__(self, dim: int, num_heads: int = 8, chaos_strength: float = 0.1,
                 dtype=torch.float32, out_dtype=torch.float32,
                 use_flash: bool = False):
        super().__init__()
        assert dim % num_heads == 0
        self.dim, self.num_heads = dim, num_heads
        self.chaos_strength = chaos_strength
        self.dtype, self.out_dtype, self.use_flash = dtype, out_dtype, use_flash
        # the strength as the compute type holds it (0.1 is 0.10009765625 in
        # bf16), applied as a Python scalar: no host-to-card copy per call
        self.strength = float(torch.tensor(chaos_strength, dtype=dtype))
        self.q_proj = Linear(dim, dim, dtype)
        self.k_proj = Linear(dim, dim, dtype)
        self.v_proj = Linear(dim, dim, dtype)
        self.chaos_proj = Linear(3, dim, dtype)
        self.chaos_gate = Linear(dim, 1, dtype)
        self.out_proj = Linear(dim, dim, dtype)

    def forward(self, x: Tensor, field: Tensor) -> Tensor:
        """`field` is this layer's chaos field [B, L, 3] (`chaos_field`)."""
        B, L, D = x.shape
        h = self.num_heads
        hd = D // h
        q = self.q_proj(x)
        k = self.k_proj(x)
        v = self.v_proj(x)
        feats = self.chaos_proj(field)
        gate = torch.sigmoid(self.chaos_gate(feats).float()).to(self.dtype)
        q_eff = q + self.strength * gate * feats

        if self.use_flash:
            # the lean kernel when nothing needs a gradient (serving, eval),
            # the forward-with-logsumexp and backward kernels when training
            out = flash_attention_tokens_trainable(
                q_eff.contiguous(), k.contiguous(), v.contiguous(), h)
            return self.out_proj(out).to(self.out_dtype)

        split = lambda t: t.reshape(B, L, h, hd).transpose(1, 2)
        scores = torch.einsum(
            "bhid,bhjd->bhij", split(q_eff).float(), split(k).float()
        ) / float(np.sqrt(np.float32(hd)))
        attn = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.einsum("bhij,bhjd->bhid", attn.float(), split(v).float())
        out = out.transpose(1, 2).reshape(B, L, D)
        return self.out_proj(out).to(self.out_dtype)
