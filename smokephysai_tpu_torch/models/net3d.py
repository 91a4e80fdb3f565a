"""SmokePhysNet3D: the volumetric variant of SmokePhysNet.

Counterpart of the JAX package's `models/net3d.py`, with the same parameter
names, so `models/convert.py` maps the JAX variables one to one: 3D conv
encoder -> mean-pool to an 8^3 = 512-token grid -> the 2D model's
`ChaosTransformerLayer`s -> `dec` to `output_channels` per token -> three
stride-2 transposed convs back to 64^3 -> `recon_out` and a sigmoid ->
`jax.image.resize`'s trilinear resize to the input volume; the physics
heads read the mean token. NDHWC [B, D, H, W, 1] in and out of `forward`,
NCDHW inside. `self.training` plays the JAX model's `train` flag, as in the
2D model: the five BatchNorms take batch statistics over (N, D, H, W) and
update their running ones, and the transformer layers apply their dropout
with masks from the generator passed to `forward`.

`dtype` is the compute type of the encoder convs, the transposed convs and
the trunk; `feature_proj`, `dec`, `recon_out` and the physics heads compute
in float32 (float64 for a model built in float64, a reference run), as the
JAX layers built without a dtype do. A float32 model computes its
convolutions in float32 on the card only with
`torch.backends.cudnn.allow_tf32 = False`, which is the caller's to set.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import resize_trilinear
from .chaos_attention import chaos_fields
from .layers import BatchNorm, Conv3D, ConvTranspose3D2x, Linear, wide
from .net import ChaosTransformerLayer

Tensor = torch.Tensor

TOKEN_GRID_3D = 8  # 8^3 = 512 tokens


def avg_pool_to(x: Tensor, out_size: int) -> Tensor:
    """Mean-pool each spatial dim of NCDHW down to `out_size` (the dims must
    be multiples of it)."""
    B, C, D, H, W = x.shape
    g = out_size
    x = x.reshape(B, C, g, D // g, g, H // g, g, W // g)
    return x.mean(dim=(3, 5, 7))


class SmokePhysNet3D(nn.Module):
    def __init__(self, hidden_dim: int = 256, num_layers: int = 4, num_heads: int = 8,
                 output_channels: int = 32, chaos_strength: float = 0.1,
                 dtype=torch.float32, fast_math: bool = False,
                 use_flash: bool = False):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.output_channels = output_channels
        self.dtype = dtype
        acc = wide(dtype)
        g3 = TOKEN_GRID_3D ** 3
        self.enc_conv1 = Conv3D(1, 32, 5, padding=2, dtype=dtype)
        self.enc_bn1 = BatchNorm(32)
        self.enc_conv2 = Conv3D(32, 64, 3, padding=1, dtype=dtype)
        self.enc_bn2 = BatchNorm(64)
        self.feature_proj = Linear(64, hidden_dim, acc)
        self.pos_embedding = nn.Parameter(torch.empty(1, g3, hidden_dim))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ChaosTransformerLayer(
                hidden_dim, num_heads, chaos_strength, dtype=dtype,
                fast_math=fast_math, use_flash=use_flash))
        self.dec = Linear(hidden_dim, output_channels, acc)
        self.up1 = ConvTranspose3D2x(output_channels, 16, dtype)
        self.up_bn1 = BatchNorm(16)
        self.up2 = ConvTranspose3D2x(16, 8, dtype)
        self.up_bn2 = BatchNorm(8)
        self.up3 = ConvTranspose3D2x(8, 4, dtype)
        self.up_bn3 = BatchNorm(4)
        self.recon_out = Conv3D(4, 1, 3, padding=1, dtype=acc)
        self.phys1 = Linear(hidden_dim, 128, acc)
        self.phys2 = Linear(128, 3, acc)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def chaos_fields(self, generator: torch.Generator, batch: int, device):
        """[num_layers, B, 512, 3]: one chaos field per layer."""
        return chaos_fields(generator, self.num_layers, batch, TOKEN_GRID_3D ** 3, device)

    def forward(self, x: Tensor, generator: torch.Generator | None = None,
                chaos_fields: Sequence[Tensor] | None = None,
                return_features: bool = False) -> Dict:
        """x: NDHWC [B, D, H, W, 1] (D, H, W multiples of 8). The per-layer
        chaos fields come from `chaos_fields` when given, else from
        `generator`; in training mode the dropout masks come from
        `generator` after them."""
        if chaos_fields is None:
            if generator is None:
                raise ValueError("SmokePhysNet3D: pass a generator or chaos_fields")
            chaos_fields = self.chaos_fields(generator, x.shape[0], x.device)
        if len(chaos_fields) != self.num_layers:
            raise ValueError(f"SmokePhysNet3D: {len(chaos_fields)} chaos fields "
                             f"for {self.num_layers} layers")
        B = x.shape[0]
        acc = wide(self.dtype)
        g = TOKEN_GRID_3D
        h = F.relu(self.enc_bn1(self.enc_conv1(x.permute(0, 4, 1, 2, 3))))
        h = F.relu(self.enc_bn2(self.enc_conv2(h)))
        tokens = avg_pool_to(h, g).flatten(2).transpose(1, 2)  # [B, 512, 64]
        feats = self.feature_proj(tokens) + self.pos_embedding.to(acc)
        for layer, field in zip(self.layers, chaos_fields):
            feats = layer(feats, field.to(x.device, acc), generator)
        feats = feats.to(acc)

        out = self.dec(F.relu(feats))
        vol = out.reshape(B, g, g, g, self.output_channels).permute(0, 4, 1, 2, 3)
        vol = F.relu(self.up_bn1(self.up1(vol)))
        vol = F.relu(self.up_bn2(self.up2(vol)))
        vol = F.relu(self.up_bn3(self.up3(vol)))
        recon = torch.sigmoid(self.recon_out(vol))
        recon = resize_trilinear(recon, tuple(x.shape[1:4]))

        pooled = feats.mean(dim=1)
        phys = self.phys2(F.relu(self.phys1(pooled)))
        results = {
            "reconstructed": recon.permute(0, 2, 3, 4, 1),
            "physics_features": phys,
            "latent_features": pooled,
        }
        if return_features:
            results["intermediate_features"] = feats
        return results
