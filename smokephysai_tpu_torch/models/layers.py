"""Layers with the numerics of the JAX package's flax layers.

Parameters are float32 and cast to the compute `dtype` at use, as the flax
layers do. Convolutions and their BatchNorms take NCHW. `BatchNorm`
follows `self.training` as flax's `use_running_average=not train` does;
`dropout` draws its mask from an explicit generator.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import conv_transpose_2x

Tensor = torch.Tensor


class Linear(nn.Module):
    """y = x W^T + b in `dtype` (TorchDense); weight [out, in]."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        x = x.to(self.dtype)
        return torch.matmul(x, self.weight.to(self.dtype).t()) + self.bias.to(self.dtype)


class Conv(nn.Module):
    """Stride-1 conv with symmetric zero padding in `dtype` (TorchConv);
    weight OIHW."""

    def __init__(self, c_in: int, c_out: int, kernel: int, padding: int,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        out = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), padding=self.padding)
        return out + self.bias.to(self.dtype)[:, None, None]


class ConvTranspose2x(nn.Module):
    """ConvTranspose2d(k=4, s=2, p=1) in float32 (TorchConvTranspose2x);
    weight in torch layout [C_in, C_out, 4, 4]."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, c_out, 4, 4))
        self.bias = nn.Parameter(torch.empty(c_out))

    def forward(self, x: Tensor) -> Tensor:
        return conv_transpose_2x(x.float(), self.weight, self.bias)


class BatchNorm(nn.Module):
    """BatchNorm2d computed as flax's `nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)`: (x - mean) * (rsqrt(var + eps) * scale) + bias, in
    float32.

    Eval (`self.training` False) reads the running statistics. Training
    normalises with the batch's statistics over (N, H, W) in float32, the
    variance biased and computed as E[x^2] - E[x]^2 clamped at 0 (flax's
    fast variance), gradients flowing through both; it then updates the
    running statistics as flax does, ra = 0.9 ra + 0.1 batch, with that
    biased variance (torch's BatchNorm2d would store the unbiased one).
    """

    MOMENTUM = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        shape = (1, -1, 1, 1)
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            mean2 = (x * x).mean(dim=(0, 2, 3))
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def dropout(x: Tensor, rate: float, generator: torch.Generator) -> Tensor:
    """flax `nn.Dropout`: keep each element with probability 1 - rate (a
    uniform draw from `generator` below it) and scale the kept ones by
    1 / (1 - rate). The generator must live on x's device."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis: float32 statistics with the
    fast variance E[x^2] - E[x]^2 (clamped at 0), float32 result."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias
