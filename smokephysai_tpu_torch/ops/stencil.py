"""Diffusion stencil kernel (csrc/stencil.cu) and its plain version.

`diffuse(field, coef)` runs one explicit-Euler diffusion update,
f + coef * (up + down + left + right - 4 f) with a replicate-padded 5-point
Laplacian, over the last two dims of a float32 field (a leading batch of
episodes is allowed): one kernel launch for a CUDA field,
`diffuse_reference` for a CPU field. Counterpart of the JAX package's
`diffuse_pallas`; the kernel adds in the plain version's order and is built
without FMA contraction, so the two agree to the bit.

`shift` is the tap that the plain solver versions share (the Jacobi sweep,
the fused step's tent-shift advection).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

Tensor = torch.Tensor

SOURCE = "stencil.cu"
# no FMA contraction: the kernel rounds each product and sum as the plain
# version's separate PyTorch operations do
FLAGS = ("-fmad=false",)

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)


def shift(f: Tensor, di: int, dj: int, fill: str) -> Tensor:
    """f[i + di, j + dj] on the last two dims; out-of-range taps are zero
    (fill='zero') or the nearest edge value (fill='edge')."""
    h, w = f.shape[-2], f.shape[-1]
    if fill == "edge":
        rows = torch.arange(h, device=f.device).add(di).clamp(0, h - 1)
        cols = torch.arange(w, device=f.device).add(dj).clamp(0, w - 1)
        return f.index_select(-2, rows).index_select(-1, cols)
    out = torch.zeros_like(f)
    r0, r1 = max(0, -di), min(h, h - di)
    c0, c1 = max(0, -dj), min(w, w - dj)
    if r1 > r0 and c1 > c0:
        out[..., r0:r1, c0:c1] = f[..., r0 + di:r1 + di, c0 + dj:c1 + dj]
    return out


def diffuse_reference(f: Tensor, coef) -> Tensor:
    """Plain version: f + coef * (((up + down) + left) + right - 4 f)."""
    lap = (
        shift(f, -1, 0, "edge") + shift(f, 1, 0, "edge")
        + shift(f, 0, -1, "edge") + shift(f, 0, 1, "edge") - 4.0 * f
    )
    return f + float(coef) * lap


def _lib():
    return _build.load(SOURCE, FLAGS, {
        "diffuse_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_void_p],
    })


def diffuse(field: Tensor, coef) -> Tensor:
    """One diffusion update of a float32 field [..., H, W] with the float32
    coefficient `coef` (dt * viscosity). A CUDA field launches the kernel
    once; a CPU field takes `diffuse_reference`. The input is not
    modified."""
    global LAUNCHES
    if field.dtype != torch.float32:
        raise TypeError(f"diffuse: field must be float32, got {field.dtype}")
    if field.dim() < 2 or min(field.shape[-2:]) < 1:
        raise ValueError(f"diffuse: field must be [..., H, W], got {tuple(field.shape)}")
    if not field.is_contiguous():
        raise ValueError("diffuse: field must be contiguous")
    coef = np.float32(coef)
    if field.device.type == "cpu":
        return diffuse_reference(field, coef)
    if field.device.type != "cuda":
        raise ValueError(f"diffuse: unsupported device {field.device}")
    h, w = field.shape[-2], field.shape[-1]
    out = torch.empty_like(field)
    stream = torch.cuda.current_stream(field.device).cuda_stream
    rc = _lib().diffuse_launch(field.data_ptr(), out.data_ptr(),
                               field.numel() // (h * w), h, w, float(coef), stream)
    if rc != 0:
        raise RuntimeError(f"diffuse kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
