"""Conjugate-gradient pressure kernel of the 3D solver (csrc/cg3d.cu) and its
plain version.

`cg_pressure(p0, div, num_iters)` runs `num_iters` iterations of matrix-free
CG on -Lap(p) = -div with the zero-Dirichlet 7-point Laplacian, warm-started
from p0, over the last three dims of float32 volumes (a leading batch of
episodes is allowed, each with its own alpha and beta): one call of the
kernel for CUDA tensors, `cg_pressure_reference` for CPU tensors.
Counterpart of the JAX package's `cg_pressure_pallas`; the kernel reduces its
dot products in a fixed order of its own, so it matches the plain version to
float32 rounding, and itself (and each episode's solve alone) to the bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

Tensor = torch.Tensor

SOURCE = "cg3d.cu"
# no FMA contraction: the stencil and the updates round as the plain
# version's separate PyTorch operations do
FLAGS = ("-fmad=false",)

LAUNCHES = 0  # solves run by the kernel (read by chip_smoke.py)


def launches_per_solve(num_iters: int) -> int:
    """Kernel launches one solve makes on the stream: the residual, then a
    direction and an update launch per iteration (csrc/cg3d.cu)."""
    return 1 + 2 * num_iters


def laplacian_dirichlet(p: Tensor) -> Tensor:
    """7-point Laplacian over the last three dims with p = 0 beyond the
    volume: (((((z-1 + z+1) + y-1) + y+1) + x-1) + x+1) - 6 p."""
    z = torch.nn.functional.pad(p, (1, 1, 1, 1, 1, 1))
    return (
        z[..., :-2, 1:-1, 1:-1]
        + z[..., 2:, 1:-1, 1:-1]
        + z[..., 1:-1, :-2, 1:-1]
        + z[..., 1:-1, 2:, 1:-1]
        + z[..., 1:-1, 1:-1, :-2]
        + z[..., 1:-1, 1:-1, 2:]
        - 6.0 * p
    )


def cg_pressure_reference(p0: Tensor, div: Tensor, num_iters: int = 30) -> Tensor:
    """Plain version (the JAX package's `solver3d.cg_pressure`): CG on
    A p = -div with A = -Lap, alpha = rs / (denom + 1e-30) where denom > 0
    (else 0), beta = rs' / (rs + 1e-30) where rs > 0 (else 0); the sums and
    both guards are per episode of a leading batch."""
    dims = (-3, -2, -1)

    def A(x):
        return -laplacian_dirichlet(x)

    def total(x):
        return torch.sum(x, dim=dims, keepdim=True)

    r = -div - A(p0)
    d = r
    rs = total(r * r)
    p = p0
    zero = torch.zeros((), dtype=p0.dtype, device=p0.device)
    for _ in range(num_iters):
        ad = A(d)
        denom = total(d * ad)
        alpha = torch.where(denom > 0, rs / (denom + 1e-30), zero)
        p = p + alpha * d
        r = r - alpha * ad
        rs_new = total(r * r)
        beta = torch.where(rs > 0, rs_new / (rs + 1e-30), zero)
        d = r + beta * d
        rs = rs_new
    return p


def _lib():
    return _build.load(SOURCE, FLAGS, {
        "cg3d_blocks": [ctypes.c_int] * 3,
        "cg3d_launch": [ctypes.c_void_p] * 5 + [ctypes.c_long]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    })


def cg_pressure(p0: Tensor, div: Tensor, num_iters: int = 30) -> Tensor:
    """`num_iters` CG iterations on float32 p0, div [..., D, H, W] (D, H,
    W >= 1). CUDA tensors run the kernel, one host call of
    `launches_per_solve(num_iters)` launches, blocks over the volume and the
    episodes; CPU tensors take `cg_pressure_reference`. The inputs are not
    modified."""
    global LAUNCHES
    for name, t in (("p0", p0), ("div", div)):
        if t.dtype != torch.float32:
            raise TypeError(f"cg_pressure: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cg_pressure: {name} must be contiguous")
    if p0.shape != div.shape or p0.dim() < 3 or min(p0.shape[-3:]) < 1:
        raise ValueError(f"cg_pressure: p0 {tuple(p0.shape)} and div "
                         f"{tuple(div.shape)} must be one non-empty [..., D, H, W] shape")
    if p0.device != div.device:
        raise ValueError("cg_pressure: p0 and div must be on one device")
    if num_iters < 0:
        raise ValueError("cg_pressure: num_iters must be >= 0")
    if p0.device.type == "cpu":
        return cg_pressure_reference(p0, div, num_iters)
    if p0.device.type != "cuda":
        raise ValueError(f"cg_pressure: unsupported device {p0.device}")
    d, h, w = p0.shape[-3:]
    episodes = p0.numel() // (d * h * w)
    lib = _lib()
    blocks = lib.cg3d_blocks(d, h, w)
    out = torch.empty_like(p0)
    vols = torch.empty(4, *p0.shape, dtype=torch.float32, device=p0.device)
    partials = torch.empty(3, episodes, blocks, dtype=torch.float32, device=p0.device)
    stream = torch.cuda.current_stream(p0.device).cuda_stream
    rc = lib.cg3d_launch(p0.data_ptr(), div.data_ptr(), out.data_ptr(),
                         vols.data_ptr(), partials.data_ptr(), episodes, d, h, w,
                         num_iters, stream)
    if rc != 0:
        raise RuntimeError(f"cg_pressure kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
