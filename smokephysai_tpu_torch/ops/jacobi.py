"""Jacobi pressure kernel (csrc/jacobi.cu) and its plain version.

`jacobi_pressure(p, div, num_iters)` runs `num_iters` zero-Dirichlet Jacobi
sweeps p <- (up + down + left + right - div) / 4 on the interior (0 on the
edge), warm-started from p, over the last two dims of float32 fields (a
leading batch of episodes is allowed): one kernel launch for CUDA tensors
(more only past `MAX_HALO` sweeps), `jacobi_pressure_reference` for CPU
tensors. Counterpart of the JAX package's `jacobi_pressure_pallas` in both
its whole-grid and its tiled forms; the kernel adds in the plain version's
order and is built without FMA contraction, so the two agree to the bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .stencil import shift

Tensor = torch.Tensor

SOURCE = "jacobi.cu"
FLAGS = ("-fmad=false",)
MAX_HALO = 32  # sweeps one launch runs (csrc/jacobi.cu); more take further launches

LAUNCHES = 0  # kernel launches, one per pass (read by chip_smoke.py)


def jacobi_pressure_reference(p: Tensor, div: Tensor, num_iters: int) -> Tensor:
    """Plain version: each sweep (((up + down) + left) + right - div) * 0.25
    with zero taps beyond the grid, then 0 on the edge cells."""
    h, w = div.shape[-2], div.shape[-1]
    row = torch.arange(h, device=p.device)[:, None]
    col = torch.arange(w, device=p.device)[None, :]
    interior = (row > 0) & (row < h - 1) & (col > 0) & (col < w - 1)
    for _ in range(num_iters):
        val = 0.25 * (
            shift(p, -1, 0, "zero") + shift(p, 1, 0, "zero")
            + shift(p, 0, -1, "zero") + shift(p, 0, 1, "zero") - div
        )
        p = torch.where(interior, val, torch.zeros_like(val))
    return p


def _lib():
    return _build.load(SOURCE, FLAGS, {
        "jacobi_launch": [ctypes.c_void_p] * 4 + [ctypes.c_long]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    })


def jacobi_pressure(p: Tensor, div: Tensor, num_iters: int = 20) -> Tensor:
    """`num_iters` Jacobi sweeps of float32 p, div [..., H, W] (H, W >= 2).
    CUDA tensors launch the kernel, tiled over the grid and the episodes
    (ceil(num_iters / MAX_HALO) launches, one at the solver's 20 sweeps);
    CPU tensors take `jacobi_pressure_reference`. The inputs are not
    modified."""
    global LAUNCHES
    for name, t in (("p", p), ("div", div)):
        if t.dtype != torch.float32:
            raise TypeError(f"jacobi_pressure: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"jacobi_pressure: {name} must be contiguous")
    if p.shape != div.shape or p.dim() < 2:
        raise ValueError(f"jacobi_pressure: p {tuple(p.shape)} and div "
                         f"{tuple(div.shape)} must be one [..., H, W] shape")
    if p.device != div.device:
        raise ValueError("jacobi_pressure: p and div must be on one device")
    h, w = p.shape[-2], p.shape[-1]
    if h < 2 or w < 2:
        raise ValueError("jacobi_pressure: grid must be at least 2x2")
    if num_iters < 0:
        raise ValueError("jacobi_pressure: num_iters must be >= 0")
    if p.device.type == "cpu":
        return jacobi_pressure_reference(p, div, num_iters)
    if p.device.type != "cuda":
        raise ValueError(f"jacobi_pressure: unsupported device {p.device}")
    out = torch.empty_like(p)
    passes = max(1, -(-num_iters // MAX_HALO))
    # passes ping-pong between out and scratch so that the last lands in out
    scratch = torch.empty_like(p) if passes > 1 else out
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rc = _lib().jacobi_launch(p.data_ptr(), div.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), p.numel() // (h * w), h, w, num_iters,
                              stream)
    if rc != 0:
        raise RuntimeError(f"jacobi_pressure kernel launch failed: cudaError {rc}")
    LAUNCHES += passes
    return out
