"""Token-major flash attention (csrc/flash_tokens.cu, csrc/flash_bwd.cu) and
the plain versions of its three kernels.

Layout as in the JAX package's `flash_attention_tokens`: q, k, v and the
output are [B, L, D] with D = heads * head_dim, head h being the column
slice [h*hd, (h+1)*hd); scale = 1 / (sqrt(hd) * temperature). The
probabilities are cast to v's type before P.V, which accumulates in float32.

- `flash_attention_tokens`: the lean forward (serving; no logsumexp).
- `flash_attention_tokens_fwd_lse`: the training forward, which also
  returns the per-head logsumexp [B, H, L] float32.
- `flash_attention_tokens_bwd`: dq, dk, dv from the forward's output and
  logsumexp (the JAX package's `_flash_trainable_bwd`): the fused kernel,
  or with `SMOKEPHYS_FUSED_BWD=0` the split dq and dk/dv kernels, as in
  the JAX package.
- `flash_attention_tokens_trainable`: the autograd Function over the pair,
  which takes the lean forward when no input needs a gradient.
- `flash_attention`: the head-major [B, H, L, D] forward (the JAX
  package's `flash_attention`), through the lean kernel with one head.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version for CPU tensors only. The float32 forward and all three float32
backward kernels (fused, dq, dk/dv) run on the tensor cores in split TF32
(csrc/tf32.cuh), one CTA of 64 rows per (row tile, head, batch).
"""
from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from . import _build

Tensor = torch.Tensor

SOURCE = "flash_tokens.cu"
BWD_SOURCE = "flash_bwd.cu"
FLAGS = ()
HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernels are instantiated for
BLOCK = 64  # L must be a multiple of it (the bf16 forward masks a half 128-key tile)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES = 0  # lean forward
LSE_LAUNCHES = 0  # forward with logsumexp
BWD_LAUNCHES = 0  # fused backward
BWD_DQ_LAUNCHES = 0  # split backward: dq
BWD_DKV_LAUNCHES = 0  # split backward: dk, dv
HM_LAUNCHES = 0  # head-major forward


def _fused_bwd_enabled() -> bool:
    """The fused backward kernel (default), read on every backward call as
    the JAX package reads it; `SMOKEPHYS_FUSED_BWD=0` selects the split dq
    and dk/dv kernels (A/B timing, and gradients that are the same bits on
    every run)."""
    return os.environ.get("SMOKEPHYS_FUSED_BWD", "1") != "0"


def _scale(head_dim: int, temperature: float) -> float:
    return 1.0 / (float(head_dim) ** 0.5 * temperature)


def _split(t: Tensor, num_heads: int) -> Tensor:
    """[B, L, D] -> [B, H, L, hd] float32."""
    B, L, D = t.shape
    return t.reshape(B, L, num_heads, D // num_heads).transpose(1, 2).float()


def _merge(t: Tensor, dtype) -> Tensor:
    """[B, H, L, hd] -> [B, L, D] in `dtype`."""
    B, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(B, L, H * hd).to(dtype)


# ---------------------------------------------------------------- plain versions


def flash_attention_tokens_fwd_lse_reference(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int, temperature: float = 1.0,
) -> Tuple[Tensor, Tensor]:
    """Plain version of the forward: per-head softmax(q k^T * scale) v in
    float32, with the unnormalised probabilities cast to v's type before P.V
    and the row sum taken in float32, as the TPU kernel does. Returns
    (out [B, L, D] in q's type, lse [B, H, L] float32)."""
    hd = q.shape[-1] // num_heads
    s = torch.einsum("bhid,bhjd->bhij", _split(q, num_heads),
                     _split(k, num_heads)) * _scale(hd, temperature)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(),
                       _split(v, num_heads)) / l
    return _merge(out, q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_tokens_reference(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int, temperature: float = 1.0,
) -> Tensor:
    """Plain version of the lean forward (the output of
    `flash_attention_tokens_fwd_lse_reference`)."""
    return flash_attention_tokens_fwd_lse_reference(q, k, v, num_heads, temperature)[0]


def _bwd_plain(q, k, v, out, lse, dout, num_heads, temperature, dq, dkv,
               kernel_exp=False):
    """The plain backward's arithmetic: (dq,) if `dq`, then (dk, dv) if
    `dkv`. With `kernel_exp`, P is formed by the kernels' formula,
    exp2(S scale log2(e) - lse log2(e)), instead of exp(S scale - lse): the
    same value, rounded another way (chip_smoke.py measures by it how far
    bf16 roundings of P and dS alone move the gradients)."""
    hd = q.shape[-1] // num_heads
    scale = _scale(hd, temperature)
    qh, kh, vh, doh = (_split(t, num_heads) for t in (q, k, v, dout))
    delta = (doh * _split(out, num_heads)).sum(dim=-1, keepdim=True)
    s = torch.einsum("bhid,bhjd->bhij", qh, kh)
    if kernel_exp:
        log2e = 1.4426950408889634
        p = torch.exp2(s * float(scale * log2e) - lse[..., None] * log2e)
    else:
        p = torch.exp(s * scale - lse[..., None])
    dp = torch.einsum("bhid,bhjd->bhij", doh, vh)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    grads = ()
    if dq:
        grads += (_merge(torch.einsum("bhij,bhjd->bhid", ds, kh), q.dtype),)
    if dkv:
        dk = torch.einsum("bhij,bhid->bhjd", ds, qh)
        dv = torch.einsum("bhij,bhid->bhjd", p.to(v.dtype).float(), doh)
        grads += (_merge(dk, k.dtype), _merge(dv, v.dtype))
    return grads


def flash_attention_tokens_bwd_reference(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, dout: Tensor,
    num_heads: int, temperature: float = 1.0,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of the backward, as the fused TPU kernel computes it:
    P = exp(S - lse), dS = P (dP - delta) scale with delta = rowsum(dO O)
    per head; P cast to v's type before P^T dO, dS to q's type before dS k
    and dS^T q; dq, dk, dv returned in q's, k's and v's types."""
    return _bwd_plain(q, k, v, out, lse, dout, num_heads, temperature, True, True)


def flash_attention_tokens_bwd_dq_reference(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, dout: Tensor,
    num_heads: int, temperature: float = 1.0,
) -> Tensor:
    """Plain version of the split dq kernel: the dq of
    `flash_attention_tokens_bwd_reference` (the split and fused TPU
    kernels round in the same places)."""
    return _bwd_plain(q, k, v, out, lse, dout, num_heads, temperature, True, False)[0]


def flash_attention_tokens_bwd_dkv_reference(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, dout: Tensor,
    num_heads: int, temperature: float = 1.0,
) -> Tuple[Tensor, Tensor]:
    """Plain version of the split dk/dv kernel: the (dk, dv) of
    `flash_attention_tokens_bwd_reference`."""
    return _bwd_plain(q, k, v, out, lse, dout, num_heads, temperature, False, True)


def flash_attention_reference(
    q: Tensor, k: Tensor, v: Tensor, temperature: float = 1.0,
) -> Tensor:
    """Plain version of the head-major forward on [B, H, L, D]:
    `flash_attention_tokens_reference` with one head on [B*H, L, D]."""
    B, H, L, D = q.shape
    flat = (t.reshape(B * H, L, D) for t in (q, k, v))
    return flash_attention_tokens_reference(*flat, 1, temperature).view(B, H, L, D)


# ---------------------------------------------------------------- the kernels


def _lib():
    return _build.load(SOURCE, FLAGS, {
        "flash_tokens_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    })


def _bwd_lib():
    tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return _build.load(BWD_SOURCE, FLAGS, {
        "flash_tokens_bwd": [ctypes.c_void_p] * 9 + tail,
        "flash_tokens_bwd_dq": [ctypes.c_void_p] * 7 + tail,
        "flash_tokens_bwd_dkv": [ctypes.c_void_p] * 8 + tail,
    })


def _check_qkv(name: str, q: Tensor, k: Tensor, v: Tensor, num_heads: int,
               layout: str = "[B, L, D]", rank: int = 3):
    if q.dim() != rank or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one {layout} shape, "
                         f"got {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v must share a device")
    D = q.shape[-1]
    if num_heads <= 0 or D % num_heads:
        raise ValueError(f"{name}: D={D} not divisible by {num_heads} heads")


def _check_launch(name: str, num_heads: int, *tensors: Tensor):
    """What the kernels take: bf16 or float32, head_dim D / heads in
    `HEAD_DIMS`, L a multiple of 64 (q is [..., L, D]), CUDA, contiguous and
    16-byte aligned."""
    q = tensors[0]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(bfloat16 or float32)")
    L, D = q.shape[-2:]
    hd = D // num_heads
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd}; the kernels take head dims "
                         f"{', '.join(map(str, HEAD_DIMS))}")
    if L % BLOCK:
        raise ValueError(f"{name}: L={L} is not a multiple of {BLOCK}")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _launch_fwd(q: Tensor, k: Tensor, v: Tensor, num_heads: int,
                temperature: float, with_lse: bool):
    B, L, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(B, num_heads, L, dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_tokens_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        B, L, D, num_heads, _scale(D // num_heads, temperature),
        _DTYPE_CODE[q.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed: "
                           f"cudaError {rc}")
    return out, lse


def flash_attention_tokens(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int, temperature: float = 1.0,
) -> Tensor:
    """Multi-head attention on token-major [B, L, D], forward only. CUDA
    tensors launch the lean kernel (bf16 or float32, head_dim in
    `HEAD_DIMS`, L a multiple of 64); CPU tensors take `flash_attention_tokens_reference`.
    The kernel's output has no gradient, so a CUDA call that would need one
    raises: use `flash_attention_tokens_trainable` there."""
    global LAUNCHES
    _check_qkv("flash_attention_tokens", q, k, v, num_heads)
    if q.device.type == "cpu":
        return flash_attention_tokens_reference(q, k, v, num_heads, temperature)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_tokens: an input needs a gradient, "
                           "which the lean kernel cannot give; call "
                           "flash_attention_tokens_trainable")
    _check_launch("flash_attention_tokens", num_heads, q, k, v)
    out, _ = _launch_fwd(q, k, v, num_heads, temperature, with_lse=False)
    LAUNCHES += 1
    return out


def flash_attention_tokens_fwd_lse(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int, temperature: float = 1.0,
) -> Tuple[Tensor, Tensor]:
    """The training forward: (out [B, L, D], lse [B, H, L] float32). CUDA
    tensors launch the LSE instantiation of the forward kernel; CPU tensors
    take `flash_attention_tokens_fwd_lse_reference`."""
    global LSE_LAUNCHES
    _check_qkv("flash_attention_tokens_fwd_lse", q, k, v, num_heads)
    if q.device.type == "cpu":
        return flash_attention_tokens_fwd_lse_reference(q, k, v, num_heads,
                                                        temperature)
    _check_launch("flash_attention_tokens_fwd_lse", num_heads, q, k, v)
    out, lse = _launch_fwd(q, k, v, num_heads, temperature, with_lse=True)
    LSE_LAUNCHES += 1
    return out, lse


def _check_bwd(name, q, k, v, out, lse, dout, num_heads):
    _check_qkv(name, q, k, v, num_heads)
    B, L, D = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{name}: out and dout must have q's shape")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"{name}: out and dout must have q's dtype")
    if lse.shape != (B, num_heads, L) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be float32 [{B}, {num_heads}, {L}]")
    if q.device.type != "cpu":
        _check_launch(name, num_heads, q, k, v, out, dout, lse)


def _delta(out: Tensor, dout: Tensor, num_heads: int) -> Tensor:
    """rowsum(dO O) per head, [B, H, L] float32 (one PyTorch reduce, as it
    is one XLA reduce in JAX)."""
    B, L, D = out.shape
    return (dout.float() * out.float()).view(B, L, num_heads, D // num_heads) \
        .sum(dim=-1).transpose(1, 2).contiguous()


def _launch_bwd(kernel, outs, q, k, v, dout, lse, delta, num_heads, temperature):
    """Launches `kernel` of csrc/flash_bwd.cu, which writes `outs`."""
    B, L, D = q.shape
    rc = getattr(_bwd_lib(), kernel)(
        *(t.data_ptr() for t in (q, k, v, dout, lse, delta, *outs)), B, L, D,
        num_heads, _scale(D // num_heads, temperature), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash attention backward kernel {kernel} launch "
                           f"failed: cudaError {rc}")


def _launch_bwd_dq(q, k, v, dout, lse, delta, num_heads, temperature) -> Tensor:
    global BWD_DQ_LAUNCHES
    dq = torch.empty_like(q)
    _launch_bwd("flash_tokens_bwd_dq", (dq,), q, k, v, dout, lse, delta, num_heads,
                temperature)
    BWD_DQ_LAUNCHES += 1
    return dq


def _launch_bwd_dkv(q, k, v, dout, lse, delta, num_heads, temperature):
    global BWD_DKV_LAUNCHES
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_tokens_bwd_dkv", (dk, dv), q, k, v, dout, lse, delta, num_heads,
                temperature)
    BWD_DKV_LAUNCHES += 1
    return dk, dv


def flash_attention_tokens_bwd(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor, dout: Tensor,
    num_heads: int, temperature: float = 1.0,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of `flash_attention_tokens_fwd_lse`. CUDA tensors take
    one PyTorch reduce for delta = rowsum(dO O) per head, then the fused
    backward kernel (dq summed in float32 by the kernel and cast to q's
    type), or with `SMOKEPHYS_FUSED_BWD=0` the split dq kernel and then the
    dk/dv kernel; CPU tensors take `flash_attention_tokens_bwd_reference`
    on both routes (the split kernels' plain versions give the same bits)."""
    global BWD_LAUNCHES
    _check_bwd("flash_attention_tokens_bwd", q, k, v, out, lse, dout, num_heads)
    if q.device.type == "cpu":
        return flash_attention_tokens_bwd_reference(q, k, v, out, lse, dout,
                                                    num_heads, temperature)
    delta = _delta(out, dout, num_heads)
    if not _fused_bwd_enabled():
        args = (q, k, v, dout, lse, delta, num_heads, temperature)
        return (_launch_bwd_dq(*args), *_launch_bwd_dkv(*args))
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_tokens_bwd", (dq, dk, dv), q, k, v, dout, lse, delta, num_heads,
                temperature)
    BWD_LAUNCHES += 1
    return dq.to(q.dtype), dk, dv


class FlashAttentionTokens(torch.autograd.Function):
    """Forward with logsumexp, backward by `flash_attention_tokens_bwd`
    (the counterpart of the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, temperature):
        out, lse = flash_attention_tokens_fwd_lse(q, k, v, num_heads, temperature)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.temperature = num_heads, temperature
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_tokens_bwd(
            q, k, v, out, lse, dout.contiguous(), ctx.num_heads, ctx.temperature)
        return dq, dk, dv, None, None


def flash_attention_tokens_trainable(
    q: Tensor, k: Tensor, v: Tensor, num_heads: int, temperature: float = 1.0,
) -> Tensor:
    """`flash_attention_tokens` with a backward: when an input needs a
    gradient, the forward-with-logsumexp kernel and the backward kernel
    (`FlashAttentionTokens`); otherwise the lean forward, as the JAX
    package's primal does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionTokens.apply(q, k, v, num_heads, temperature)
    return flash_attention_tokens(q, k, v, num_heads, temperature)


def flash_attention(
    q: Tensor, k: Tensor, v: Tensor, temperature: float = 1.0,
    block_q: int = 256, block_k: int = 512,
) -> Tensor:
    """softmax(q k^T / (sqrt(D) * temperature)) v on head-major [B, H, L, D]
    (the JAX package's `flash_attention`), forward only. The block sizes are
    checked as the JAX function asserts them (each capped at L must divide
    L); the CUDA kernel tiles by its own sizes. A contiguous [B, H, L, D] is
    token-major [B*H, L, D] with one head, so CUDA tensors launch the lean
    kernel on that view (bf16 or float32, D in `HEAD_DIMS`, L a multiple
    of 64); CPU tensors take `flash_attention_reference`. As for the lean
    forward, a CUDA call that would need a gradient raises."""
    global HM_LAUNCHES
    _check_qkv("flash_attention", q, k, v, 1, layout="[B, H, L, D]", rank=4)
    B, H, L, D = q.shape
    bq, bk = min(block_q, L), min(block_k, L)
    if bq <= 0 or bk <= 0 or L % bq or L % bk:
        raise ValueError(f"flash_attention: L={L} does not divide by the blocks "
                         f"({block_q}, {block_k})")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, temperature)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: an input needs a gradient, which the "
                           "lean kernel cannot give")
    _check_launch("flash_attention", 1, q, k, v)
    flat = (t.view(B * H, L, D) for t in (q, k, v))
    out, _ = _launch_fwd(*flat, 1, temperature, with_lse=False)
    HM_LAUNCHES += 1
    return out.view(B, H, L, D)
