"""Chaos features of smoke frames: Lyapunov exponent, box-counting fractal
dimension, Shannon entropy.

Counterpart of the JAX package's `physics/chaos.py`, with the same
definitions, batched over any leading axes (episodes) instead of vmapped.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

Tensor = torch.Tensor

BOX_SCALES: Tuple[int, ...] = (2, 4, 8, 16, 32)
LYAPUNOV_WINDOW = 20
HISTOGRAM_BINS = 256


def lyapunov_exponent(states: Tensor) -> Tensor:
    """max(0, mean(diff(log(||s[t+1] - s[t]|| + 1e-8)))) over the last
    `LYAPUNOV_WINDOW` states of [..., T, H, W] (norms over H, W)."""
    window = states[..., -LYAPUNOV_WINDOW:, :, :]
    diffs = window[..., 1:, :, :] - window[..., :-1, :, :]
    dists = torch.sqrt(torch.sum(diffs ** 2, dim=(-2, -1)))
    log_d = torch.log(dists + 1e-8)
    lyap = torch.mean(log_d[..., 1:] - log_d[..., :-1], dim=-1)
    return torch.clamp_min(lyap, 0.0)


def box_count(binary: Tensor, scale: int) -> Tensor:
    """Number of scale x scale boxes of [..., H, W] holding any positive
    cell; rows and columns beyond a whole box are dropped."""
    h, w = binary.shape[-2], binary.shape[-1]
    bh, bw = h // scale, w // scale
    cropped = binary[..., : bh * scale, : bw * scale]
    sums = cropped.reshape(*binary.shape[:-2], bh, scale, bw, scale).sum(dim=(-3, -1))
    return (sums > 0).sum(dim=(-2, -1)).float()


def fractal_dimension(frame: Tensor, scales: Sequence[int] = BOX_SCALES) -> Tensor:
    """|slope| of log(count + 1) against log(scale) for the frame
    thresholded at its mean, [..., H, W] -> [...]."""
    mean = frame.mean(dim=(-2, -1), keepdim=True)
    binary = (frame > mean).float()
    counts = torch.stack([box_count(binary, s) for s in scales], dim=-1)
    log_scales = torch.log(torch.tensor(scales, dtype=torch.float32, device=frame.device))
    log_counts = torch.log(counts + 1.0)
    xm = log_scales.mean()
    ym = log_counts.mean(dim=-1, keepdim=True)
    slope = torch.sum((log_scales - xm) * (log_counts - ym), dim=-1) / torch.sum(
        (log_scales - xm) ** 2)
    return torch.abs(slope)


def shannon_entropy(frame: Tensor, bins: int = HISTOGRAM_BINS) -> Tensor:
    """Base-2 entropy of a `bins`-bin histogram over [0, 1], [..., H, W] ->
    [...]: values outside [0, 1] are left out, and 1.0 falls in the last
    bin (the closed right edge)."""
    x = frame.reshape(*frame.shape[:-2], -1)
    valid = (x >= 0.0) & (x <= 1.0)
    idx = torch.clamp(torch.floor(x * bins).to(torch.int64), 0, bins - 1)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    counts = torch.zeros(*x.shape[:-1], bins, dtype=torch.float32, device=x.device)
    counts.scatter_add_(-1, idx, valid.float())
    probs = counts / counts.sum(dim=-1, keepdim=True)
    return -torch.sum(probs * torch.log2(probs + 1e-8), dim=-1)


def chaos_features(history: Tensor, history_len: int) -> Tensor:
    """[lyapunov, fractal_dimension, entropy] of a history [..., T, H, W]
    ordered oldest to newest; lyapunov is 0 until 20 frames exist."""
    current = history[..., -1, :, :]
    if history_len >= LYAPUNOV_WINDOW:
        lyap = lyapunov_exponent(history)
    else:
        lyap = torch.zeros(current.shape[:-2], dtype=history.dtype,
                           device=history.device)
    return torch.stack([lyap, fractal_dimension(current), shannon_entropy(current)],
                       dim=-1)


def chaos_features_from_sequence(sequence: Tensor, warmup: int = 10) -> Tensor:
    """Episode-averaged chaos label of [..., T, H, W] -> [..., 3]: the mean
    over t in [warmup, T) of [lyapunov_t, fd_t, entropy_t], where lyapunov_t
    is that of frames t-19..t once t >= 19 and 0 before, and fd and
    entropy are those of frame t."""
    T = sequence.shape[-3]
    frames = sequence[..., warmup:T, :, :]
    fd = fractal_dimension(frames)
    ent = shannon_entropy(frames)
    lyaps = torch.zeros_like(fd)
    for t in range(max(warmup, LYAPUNOV_WINDOW - 1), T):
        window = sequence[..., t - (LYAPUNOV_WINDOW - 1): t + 1, :, :]
        lyaps[..., t - warmup] = lyapunov_exponent(window)
    return torch.stack([lyaps.mean(dim=-1), fd.mean(dim=-1), ent.mean(dim=-1)], dim=-1)
