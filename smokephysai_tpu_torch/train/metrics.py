"""Evaluation metrics over NHWC tensors: the simplified average-pool SSIM,
PSNR, MSE and the per-sample Pearson correlation of the three physics
features.

Counterpart of the JAX package's `train/metrics.py`, with the same
definitions: SSIM's window is an 11-wide mean filter with zero padding
counted over the whole window (torch's `count_include_pad=True`), C1 =
0.01^2 and C2 = 0.03^2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _avg_pool_same(x: Tensor, window: int) -> Tensor:
    """Mean filter with SAME zero padding over NHWC."""
    pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride=1,
                          padding=window // 2, count_include_pad=True)
    return pooled.permute(0, 2, 3, 1)


def ssim(pred: Tensor, target: Tensor, window: int = 11) -> Tensor:
    """Simplified SSIM with a uniform window, averaged over the map."""
    mu1 = _avg_pool_same(pred, window)
    mu2 = _avg_pool_same(target, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _avg_pool_same(pred * pred, window) - mu1_sq
    sigma2_sq = _avg_pool_same(target * target, window) - mu2_sq
    sigma12 = _avg_pool_same(pred * target, window) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


def mse(pred: Tensor, target: Tensor) -> Tensor:
    return ((pred - target) ** 2).mean()


def psnr(pred: Tensor, target: Tensor) -> Tensor:
    """20 log10(1 / sqrt(mse)), for values in [0, 1]."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(pred, target)))


def pearson_per_sample(pred: Tensor, target: Tensor) -> Tensor:
    """Row-wise Pearson correlation over the feature axis: [B, F] -> [B]."""
    pm = pred - pred.mean(dim=-1, keepdim=True)
    tm = target - target.mean(dim=-1, keepdim=True)
    num = (pm * tm).sum(dim=-1)
    den = torch.sqrt((pm ** 2).sum(dim=-1) * (tm ** 2).sum(dim=-1))
    return num / den
