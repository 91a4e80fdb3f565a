"""Chaos features of smoke frames and volumes: Lyapunov exponent,
box-counting fractal dimension, Shannon entropy.

Counterpart of the JAX package's `physics/chaos.py`, with the same
definitions, batched over any leading axes (episodes) instead of vmapped.
A leading axis cannot be told from a volume's depth, so each function takes
the spatial rank: `spatial_dims=2` for frames [..., H, W] (the default),
3 for volumes [..., D, H, W], which the JAX package tells by the array's
rank (box counting over cubes, the entropy of the whole volume, the
Lyapunov norm over every spatial axis).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

Tensor = torch.Tensor

BOX_SCALES: Tuple[int, ...] = (2, 4, 8, 16, 32)
LYAPUNOV_WINDOW = 20
HISTOGRAM_BINS = 256


def _space(spatial_dims: int) -> Tuple[int, ...]:
    if spatial_dims not in (2, 3):
        raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
    return tuple(range(-spatial_dims, 0))


def lyapunov_exponent(states: Tensor, spatial_dims: int = 2) -> Tensor:
    """max(0, mean(diff(log(||s[t+1] - s[t]|| + 1e-8)))) over the last
    `LYAPUNOV_WINDOW` states of [..., T, *space] (norms over the space)."""
    space = _space(spatial_dims)
    t_axis = -spatial_dims - 1
    window = states.narrow(t_axis, max(states.shape[t_axis] - LYAPUNOV_WINDOW, 0),
                           min(states.shape[t_axis], LYAPUNOV_WINDOW))
    n = window.shape[t_axis]
    diffs = window.narrow(t_axis, 1, n - 1) - window.narrow(t_axis, 0, n - 1)
    dists = torch.sqrt(torch.sum(diffs ** 2, dim=space))
    log_d = torch.log(dists + 1e-8)
    lyap = torch.mean(log_d[..., 1:] - log_d[..., :-1], dim=-1)
    return torch.clamp_min(lyap, 0.0)


def box_count(binary: Tensor, scale: int, spatial_dims: int = 2) -> Tensor:
    """Number of scale^d boxes of [..., *space] holding any positive cell;
    cells beyond a whole box are dropped."""
    space = _space(spatial_dims)
    sizes = [binary.shape[a] // scale for a in space]
    cropped = binary[(..., *(slice(0, n * scale) for n in sizes))]
    split = [x for n in sizes for x in (n, scale)]
    sums = cropped.reshape(*binary.shape[:-spatial_dims], *split).sum(
        dim=tuple(range(-2 * spatial_dims + 1, 0, 2)))
    return (sums > 0).sum(dim=space).float()


def fractal_dimension(frame: Tensor, scales: Sequence[int] = BOX_SCALES,
                      spatial_dims: int = 2) -> Tensor:
    """|slope| of log(count + 1) against log(scale) for the frame or volume
    thresholded at its mean, [..., *space] -> [...]."""
    space = _space(spatial_dims)
    mean = frame.mean(dim=space, keepdim=True)
    binary = (frame > mean).float()
    counts = torch.stack([box_count(binary, s, spatial_dims) for s in scales], dim=-1)
    log_scales = torch.log(torch.tensor(scales, dtype=torch.float32, device=frame.device))
    log_counts = torch.log(counts + 1.0)
    xm = log_scales.mean()
    ym = log_counts.mean(dim=-1, keepdim=True)
    slope = torch.sum((log_scales - xm) * (log_counts - ym), dim=-1) / torch.sum(
        (log_scales - xm) ** 2)
    return torch.abs(slope)


def shannon_entropy(frame: Tensor, bins: int = HISTOGRAM_BINS,
                    spatial_dims: int = 2) -> Tensor:
    """Base-2 entropy of a `bins`-bin histogram over [0, 1] of each frame or
    volume, [..., *space] -> [...]: values outside [0, 1] are left out,
    and 1.0 falls in the last bin (the closed right edge)."""
    _space(spatial_dims)
    x = frame.flatten(-spatial_dims)
    valid = (x >= 0.0) & (x <= 1.0)
    idx = torch.clamp(torch.floor(x * bins).to(torch.int64), 0, bins - 1)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    counts = torch.zeros(*x.shape[:-1], bins, dtype=torch.float32, device=x.device)
    counts.scatter_add_(-1, idx, valid.float())
    probs = counts / counts.sum(dim=-1, keepdim=True)
    return -torch.sum(probs * torch.log2(probs + 1e-8), dim=-1)


def chaos_features(history: Tensor, history_len: int, spatial_dims: int = 2) -> Tensor:
    """[lyapunov, fractal_dimension, entropy] of a history [..., T, *space]
    ordered oldest to newest; lyapunov is 0 until 20 frames exist."""
    current = history.select(-spatial_dims - 1, -1)
    if history_len >= LYAPUNOV_WINDOW:
        lyap = lyapunov_exponent(history, spatial_dims)
    else:
        lyap = torch.zeros(current.shape[:-spatial_dims], dtype=history.dtype,
                           device=history.device)
    return torch.stack([lyap, fractal_dimension(current, spatial_dims=spatial_dims),
                        shannon_entropy(current, spatial_dims=spatial_dims)], dim=-1)


def chaos_features_from_sequence(sequence: Tensor, warmup: int = 10,
                                 spatial_dims: int = 2) -> Tensor:
    """Episode-averaged chaos label of [..., T, *space] -> [..., 3]: the
    mean over t in [warmup, T) of [lyapunov_t, fd_t, entropy_t], where
    lyapunov_t is that of frames t-19..t once t >= 19 and 0 before, and fd
    and entropy are those of frame t."""
    t_axis = -spatial_dims - 1
    T = sequence.shape[t_axis]
    frames = sequence[(..., slice(warmup, T)) + (slice(None),) * spatial_dims]
    fd = fractal_dimension(frames, spatial_dims=spatial_dims)
    ent = shannon_entropy(frames, spatial_dims=spatial_dims)
    lyaps = torch.zeros_like(fd)
    for t in range(max(warmup, LYAPUNOV_WINDOW - 1), T):
        window = sequence.narrow(t_axis, t - (LYAPUNOV_WINDOW - 1), LYAPUNOV_WINDOW)
        lyaps[..., t - warmup] = lyapunov_exponent(window, spatial_dims)
    return torch.stack([lyaps.mean(dim=-1), fd.mean(dim=-1), ent.mean(dim=-1)], dim=-1)
