"""Image ops of the model on NCHW tensors, with torch's semantics expressed
as the JAX package's `ops/image.py` expresses them.

Adaptive average pooling and the bilinear resize (align_corners=False) are
separable, so each is two contractions with constant [out, in] matrices;
the stride-2 transposed convolution is torch's own. The volumetric model's
trilinear resize is `jax.image.resize(method="trilinear")`, three
contractions with its weights: a triangle kernel, widened by the scale
when shrinking (antialiased), renormalised where it meets the edge.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@functools.lru_cache(maxsize=64)
def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] averaging matrix: bin i covers
    [floor(i*in/out), ceil((i+1)*in/out))."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -((-(i + 1) * in_size) // out_size)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] bilinear weights, align_corners=False: src = (i+0.5)*in/out
    - 0.5 clamped at 0, the upper tap clamped to the last sample."""
    scale = in_size / out_size
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        src = max((i + 0.5) * scale - 0.5, 0.0)
        i0 = int(np.floor(src))
        i1 = min(i0 + 1, in_size - 1)
        w1 = src - i0
        m[i, i0] += 1.0 - w1
        m[i, i1] += w1
    return m


@functools.lru_cache(maxsize=64)
def _jax_linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of jax.image.resize's linear (antialiased) kernel,
    computed as jax.image.scale's compute_weight_mat does in float32:
    sample s_i = (i + 0.5) in/out - 0.5, weight max(0, 1 - |s_i - j| / k)
    with k = max(in/out, 1), each row divided by its sum (0 where the sum is
    ~0), and rows whose sample lies outside [-0.5, in - 0.5] zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).T.astype(f32)


_MATRICES = {"pool": _adaptive_pool_matrix, "resize": _resize_matrix,
             "jax_linear": _jax_linear_resize_matrix}


@functools.lru_cache(maxsize=64)
def _on_device(kind: str, in_size: int, out_size: int, device, dtype) -> Tensor:
    """The matrix, copied to the device once (a copy from host memory at
    every call would wait for the work already queued on the card). Made
    outside inference mode, so that a matrix first cached by an inference
    call can still be saved for a later backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(_MATRICES[kind](in_size, out_size)).to(device, dtype)


def _separable(x: Tensor, kind: str, out_hw: Tuple[int, int]) -> Tensor:
    mh = _on_device(kind, x.shape[-2], out_hw[0], x.device, x.dtype)
    mw = _on_device(kind, x.shape[-1], out_hw[1], x.device, x.dtype)
    x = torch.einsum("oh,nchw->ncow", mh, x)
    return torch.einsum("pw,ncow->ncop", mw, x)


def adaptive_avg_pool2d(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """F.adaptive_avg_pool2d on NCHW, as two matrix contractions."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    if (h_in, w_in) == tuple(out_hw):
        return x
    return _separable(x, "pool", out_hw)


def interpolate_bilinear(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) on NCHW, as two
    matrix contractions."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    if (h_in, w_in) == tuple(out_hw):
        return x
    return _separable(x, "resize", out_hw)


def resize_trilinear(x: Tensor, out_dhw: Tuple[int, int, int]) -> Tensor:
    """jax.image.resize(method="trilinear") over the last three dims of
    NCDHW, as three matrix contractions."""
    if tuple(x.shape[-3:]) == tuple(out_dhw):
        return x
    md, mh, mw = (_on_device("jax_linear", n, m, x.device, x.dtype)
                  for n, m in zip(x.shape[-3:], out_dhw))
    x = torch.einsum("od,ncdhw->ncohw", md, x)
    x = torch.einsum("ph,ncohw->ncopw", mh, x)
    return torch.einsum("qw,ncopw->ncopq", mw, x)


def conv_transpose_2x(x: Tensor, weight: Tensor, bias: Tensor | None = None) -> Tensor:
    """ConvTranspose2d(k=4, stride=2, padding=1) on NCHW: exactly doubles the
    spatial size. `weight` in torch layout [C_in, C_out, 4, 4]."""
    return F.conv_transpose2d(x, weight, bias, stride=2, padding=1)
