"""Diffusion stencil kernel (csrc/stencil.cu) and its plain version.

`diffuse(field, coef)` runs one explicit-Euler diffusion update,
f + coef * (up + down + left + right - 4 f) with a replicate-padded 5-point
Laplacian, over the last two dims of a float32 field (a leading batch of
episodes is allowed): one kernel launch for a CUDA field,
`diffuse_reference` for a CPU field. `diffuse_fields(u, v, density,
coef_uv, coef_d)` updates a solver step's three fields in one launch of the
same kernel. Counterpart of the JAX package's `diffuse_pallas`; the kernel
adds in the plain version's order and is built without FMA contraction, so
the two agree to the bit.

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
    field = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
             ctypes.c_float]
    return _build.load(SOURCE, FLAGS, {
        "diffuse_launch": [ctypes.c_int] + field * 3 + [ctypes.c_void_p],
    })


def _check(name: str, field: Tensor):
    if field.dtype != torch.float32:
        raise TypeError(f"diffuse: {name} must be float32, got {field.dtype}")
    if field.dim() < 2 or min(field.shape[-2:]) < 1:
        raise ValueError(f"diffuse: {name} must be [..., H, W], got {tuple(field.shape)}")
    if not field.is_contiguous():
        raise ValueError(f"diffuse: {name} must be contiguous")
    if field.device.type not in ("cpu", "cuda"):
        raise ValueError(f"diffuse: unsupported device {field.device}")


_UNUSED = (None, None, 0, 0, 0, 0.0)  # a field slot the launch leaves out


def _launch(fields, coefs):
    """One launch over the checked CUDA fields, each with its float32
    coefficient; returns their updates."""
    outs = [torch.empty_like(f) for f in fields]
    args = []
    for f, o, c in zip(fields, outs, coefs):
        h, w = f.shape[-2], f.shape[-1]
        args += (f.data_ptr(), o.data_ptr(), f.numel() // (h * w), h, w, float(c))
    args += _UNUSED * (3 - len(fields))
    rc = _lib().diffuse_launch(len(fields), *args,
                               torch.cuda.current_stream(fields[0].device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"diffuse kernel launch failed: cudaError {rc}")
    return outs


def diffuse(field: Tensor, coef) -> Tensor:
    """One diffusion update of a float32 field [..., H, W] with the float32
    coefficient `coef` (dt * viscosity). A CUDA field launches the kernel
    once; a CPU field takes `diffuse_reference`. The input is not
    modified."""
    global LAUNCHES
    _check("field", field)
    coef = np.float32(coef)
    if field.device.type == "cpu":
        return diffuse_reference(field, coef)
    out, = _launch([field], [coef])
    LAUNCHES += 1
    return out


def diffuse_fields(u: Tensor, v: Tensor, density: Tensor, coef_uv, coef_d):
    """A solver step's diffusion of its three staggered float32 fields, u
    [..., H+1, W] and v [..., H, W+1] with `coef_uv`, the density [..., H, W]
    with `coef_d` (float32 coefficients): each exactly what `diffuse` gives
    it. CUDA fields launch the kernel once for all three; CPU fields take
    `diffuse_reference` three times. Returns (u, v, density); the inputs
    are not modified."""
    global LAUNCHES
    fields = (u, v, density)
    for name, f in zip(("u", "v", "density"), fields):
        _check(name, f)
        if f.device != density.device:
            raise ValueError("diffuse_fields: u, v and density must be on one device")
    coefs = (np.float32(coef_uv), np.float32(coef_uv), np.float32(coef_d))
    if density.device.type == "cpu":
        return tuple(diffuse_reference(f, c) for f, c in zip(fields, coefs))
    outs = _launch(fields, coefs)
    LAUNCHES += 1
    return tuple(outs)
