"""Image ops of the model on NCHW tensors, with torch's semantics expressed
as the JAX package's `ops/image.py` expresses them.

Adaptive average pooling and the bilinear resize (align_corners=False) are
separable, so each is two contractions with constant [out, in] matrices;
the stride-2 transposed convolution is torch's own.
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
def _on_device(kind: str, in_size: int, out_size: int, device, dtype) -> Tensor:
    """The matrix, copied to the device once (a copy from host memory at
    every call would wait for the work already queued on the card). Made
    outside inference mode, so that a matrix first cached by an inference
    call can still be saved for a later backward."""
    build = _adaptive_pool_matrix if kind == "pool" else _resize_matrix
    with torch.inference_mode(False):
        return torch.from_numpy(build(in_size, out_size)).to(device, dtype)


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


def conv_transpose_2x(x: Tensor, weight: Tensor, bias: Tensor | None = None) -> Tensor:
    """ConvTranspose2d(k=4, stride=2, padding=1) on NCHW: exactly doubles the
    spatial size. `weight` in torch layout [C_in, C_out, 4, 4]."""
    return F.conv_transpose2d(x, weight, bias, stride=2, padding=1)
