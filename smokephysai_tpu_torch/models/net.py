"""SmokePhysNet: CNN encoder -> chaos-gated transformer -> reconstruction and
physics-feature heads.

`self.training` plays the JAX model's `train` flag: in training mode the
four BatchNorms normalise with batch statistics (and update their running
ones) and each transformer layer applies dropout 0.1 after the GELU and
after `ffn_out`, with masks drawn from the generator passed to `forward`.

Counterpart of the JAX package's `models/net.py`, with the same parameter
names, so `models/convert.py` maps the JAX variables one to one. NHWC
[B, H, W, 1] in and out of `forward`, NCHW inside.

Options as in the JAX model: `dtype` is the compute type of the dense and
conv layers (bfloat16 for serving); `fast_math` keeps the trunk's residual
stream in `dtype` and uses the tanh GELU; `use_flash` routes attention
through the flash kernel (`ops/attention.py`); `fast_encoder` pools a
frame larger than `input_dim`^2 down to `input_dim`^2 before the conv
encoder (the streaming fast path; the JAX model's documented divergence,
an exact no-op on `input_dim`^2 frames), where the parity path pools after
`enc_conv2`.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import adaptive_avg_pool2d, interpolate_bilinear
from .chaos_attention import ChaosAttention, chaos_fields
from .layers import BatchNorm, Conv, ConvTranspose2x, LayerNorm, Linear, dropout, wide

Tensor = torch.Tensor

TOKEN_GRID = 32  # the trunk's token grid is 32 x 32
DROPOUT = 0.1  # the FFN's dropout rate in training mode


class ChaosTransformerLayer(nn.Module):
    """Pre-LN block: x += ChaosAttn(LN(x)); x += FFN(LN(x)), with dropout
    after the GELU and after `ffn_out` in training mode."""

    def __init__(self, dim: int, num_heads: int, chaos_strength: float = 0.1,
                 dtype=torch.float32, fast_math: bool = False,
                 use_flash: bool = False):
        super().__init__()
        self.fast_math = fast_math
        self.dropout = DROPOUT
        self.res_dtype = dtype if fast_math else wide(dtype)
        self.chaos_attention = ChaosAttention(
            dim, num_heads, chaos_strength, dtype=dtype,
            out_dtype=self.res_dtype, use_flash=use_flash,
        )
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.ffn_in = Linear(dim, 4 * dim, dtype)
        self.ffn_out = Linear(4 * dim, dim, dtype)

    def forward(self, x: Tensor, field: Tensor,
                generator: torch.Generator | None = None) -> Tensor:
        """`generator` draws the dropout masks (training mode only)."""
        drop = self.training and self.dropout > 0.0
        if drop and generator is None:
            raise ValueError("ChaosTransformerLayer: training-mode dropout "
                             "needs a generator")
        x = x.to(self.res_dtype)
        x = x + self.chaos_attention(self.norm1(x), field)
        y = self.ffn_in(self.norm2(x))
        y = F.gelu(y, approximate="tanh" if self.fast_math else "none")
        if drop:
            y = dropout(y, self.dropout, generator)
        y = self.ffn_out(y).to(self.res_dtype)
        if drop:
            y = dropout(y, self.dropout, generator)
        return x + y


class SmokePhysNet(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 512,
                 num_layers: int = 6, num_heads: int = 8,
                 output_channels: int = 64, chaos_strength: float = 0.1,
                 dtype=torch.float32, fast_math: bool = False,
                 use_flash: bool = False, fast_encoder: bool = False):
        super().__init__()
        self.input_dim, self.hidden_dim = input_dim, hidden_dim
        self.fast_encoder = fast_encoder
        self.num_layers, self.output_channels = num_layers, output_channels
        self.dtype = dtype
        self.enc_conv1 = Conv(1, 64, 7, padding=3, dtype=dtype)
        self.enc_bn1 = BatchNorm(64)
        self.enc_conv2 = Conv(64, 128, 3, padding=1, dtype=dtype)
        self.enc_bn2 = BatchNorm(128)
        self.feature_proj = Linear(128, hidden_dim, dtype)
        self.pos_embedding = nn.Parameter(
            torch.empty(1, input_dim * input_dim, hidden_dim))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ChaosTransformerLayer(
                hidden_dim, num_heads, chaos_strength, dtype=dtype,
                fast_math=fast_math, use_flash=use_flash))
        self.dec1 = Linear(hidden_dim, 256, dtype)
        self.dec2 = Linear(256, output_channels, dtype)
        self.up1 = ConvTranspose2x(output_channels, 32)
        self.up_bn1 = BatchNorm(32)
        self.up2 = ConvTranspose2x(32, 16)
        self.up_bn2 = BatchNorm(16)
        self.recon_out = Conv(16, 1, 3, padding=1)
        self.phys1 = Linear(hidden_dim, 256)
        self.phys2 = Linear(256, 3)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def encode(self, x: Tensor) -> Tensor:
        """NCHW frames -> token features [B, 1024, hidden_dim] (float32)."""
        if self.fast_encoder and max(x.shape[-2:]) > self.input_dim:
            x = adaptive_avg_pool2d(x, (self.input_dim, self.input_dim))
        h = F.relu(self.enc_bn1(self.enc_conv1(x)))
        h = F.relu(self.enc_bn2(self.enc_conv2(h)))
        h = adaptive_avg_pool2d(h, (self.input_dim, self.input_dim))
        h = adaptive_avg_pool2d(h, (TOKEN_GRID, TOKEN_GRID))
        tokens = h.flatten(2).transpose(1, 2)  # [B, 1024, 128], row-major grid
        feats = self.feature_proj(tokens).float()
        pos = self.pos_embedding
        if TOKEN_GRID * TOKEN_GRID != self.input_dim * self.input_dim:
            img = pos.reshape(1, self.input_dim, self.input_dim, self.hidden_dim)
            img = interpolate_bilinear(img.permute(0, 3, 1, 2), (TOKEN_GRID, TOKEN_GRID))
            pos = img.permute(0, 2, 3, 1).reshape(1, TOKEN_GRID * TOKEN_GRID,
                                                  self.hidden_dim)
        return feats + pos

    def trunk(self, feats: Tensor, fields: Sequence[Tensor],
              generator: torch.Generator | None = None) -> Tensor:
        for layer, field in zip(self.layers, fields):
            feats = layer(feats, field, generator)
        return feats.float()

    def decode(self, feats: Tensor, in_hw, return_features: bool = False) -> Dict:
        B = feats.shape[0]
        out = self.dec2(F.relu(self.dec1(feats))).float()
        img = out.reshape(B, TOKEN_GRID, TOKEN_GRID, self.output_channels)
        img = img.permute(0, 3, 1, 2)
        img = F.relu(self.up_bn1(self.up1(img)))
        img = F.relu(self.up_bn2(self.up2(img)))
        recon = torch.sigmoid(self.recon_out(img))
        if tuple(recon.shape[-2:]) != tuple(in_hw):
            recon = interpolate_bilinear(recon, tuple(in_hw))
        phys, pooled = self.physics(feats)
        results = {
            "reconstructed": recon.permute(0, 2, 3, 1),
            "physics_features": phys,
            "latent_features": pooled,
        }
        if return_features:
            results["intermediate_features"] = feats
        return results

    def physics(self, feats: Tensor):
        """The physics head on the trunk's token features: ([B, 3] physics
        features, [B, hidden_dim] mean token)."""
        pooled = feats.mean(dim=1)
        return self.phys2(F.relu(self.phys1(pooled))), pooled

    def chaos_fields(self, generator: torch.Generator, batch: int, device):
        """[num_layers, B, 1024, 3]: one chaos field per layer."""
        return chaos_fields(generator, self.num_layers, batch,
                            TOKEN_GRID * TOKEN_GRID, device)

    def forward(self, x: Tensor, generator: torch.Generator | None = None,
                chaos_fields: Sequence[Tensor] | None = None,
                return_features: bool = False) -> Dict:
        """x: NHWC [B, H, W, 1]. The per-layer chaos fields come from
        `chaos_fields` when given, else from `generator`; in training mode
        the dropout masks come from `generator` after them."""
        fields = self._fields(x, generator, chaos_fields)
        feats = self.encode(x.permute(0, 3, 1, 2))
        feats = self.trunk(feats, fields, generator)
        return self.decode(feats, x.shape[1:3], return_features)

    def _fields(self, x: Tensor, generator, chaos_fields) -> List[Tensor]:
        if chaos_fields is None:
            if generator is None:
                raise ValueError("SmokePhysNet: pass a generator or chaos_fields")
            chaos_fields = self.chaos_fields(generator, x.shape[0], x.device)
        if len(chaos_fields) != self.num_layers:
            raise ValueError(f"SmokePhysNet: {len(chaos_fields)} chaos fields "
                             f"for {self.num_layers} layers")
        return [f.to(x.device, torch.float32) for f in chaos_fields]

    def attention_weights(self, x: Tensor, generator: torch.Generator | None = None,
                          chaos_fields: Sequence[Tensor] | None = None) -> Tensor:
        """Layer 0's attention probabilities [B, heads, 1024, 1024] for NHWC
        `x`, from the einsum path, under the chaos field that `forward` gives
        that layer from the same `generator` or `chaos_fields`."""
        fields = self._fields(x, generator, chaos_fields)
        layer = self.layer_0
        feats = self.encode(x.permute(0, 3, 1, 2)).to(layer.res_dtype)
        _, attn = layer.chaos_attention(layer.norm1(feats), fields[0],
                                        return_attention=True)
        return attn
