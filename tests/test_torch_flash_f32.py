"""The float32 flash kernels' arithmetic, emulated on the CPU (no JAX).

On the card the float32 forward (`flash_f32_kernel`), the float32 fused
and dk/dv backward (`flash_bwd_f32_kernel`) and the float32 split dq kernel
(`flash_bwd_dq_f32_kernel`) in csrc/ form every product on the tensor
cores in split TF32: each float32 operand x is carried as hi =
tf32(x) and lo = tf32(x - hi) (10 stored mantissa bits, round to nearest,
ties away from zero), and each 8-deep k-step of a product adds lo hi',
hi lo' and then hi hi' into a float32 accumulator. The emulation takes
each mma.sync step as c + sum of the eight products, the products exact
and the result rounded toward zero to float32: the tensor cores truncate
as they accumulate. Each tile's products go into a fresh accumulator that
is then added to the running sum in float32, as the kernels do.

These tests run that arithmetic in torch through the kernels' formulas (the
forward's online softmax over 64-key tiles, the backward per query tile
with dQ summed per 64-key block, the split dq kernel per 64-key tile of a
query-stationary CTA, also at L = 1024) at B = 2, L = 128, head dims 32
and 64,
and hold the results against the port's float32 plain versions with the
bounds the card's checks use: out atol 1e-5, lse atol 1e-4, ||d|| / ||ref||
<= 1e-5 for each of dq, dk, dv. Two negative controls show that the bound
bites: the forward in single-pass TF32 exceeds it, and so does, at L = 1024,
the split forward with one accumulator over all of L (the truncation's
bias then builds up over 384 steps), where the fresh accumulator per tile
stays inside. What the emulation cannot show is how the card rounds in
detail; the card's own checks (chip_smoke.py, tests/test_torch_cuda.py)
hold the kernels. Run:

    python -m pytest tests/test_torch_flash_f32.py -q
"""
import math

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one share of the cores per test worker)
from smokephysai_tpu_torch.ops import attention as attn_ops

OUT_ATOL = 1e-5  # chip_smoke's FLASH_F32_ATOL
LSE_ATOL = 1e-4  # chip_smoke's LSE_ATOL
BWD_REL_NORM = 1e-5  # chip_smoke's BWD_F32_REL_NORM
LOG2E = 1.4426950408889634
BK = 64  # the forward's keys per tile (head dims up to 64)
TEMPERATURE = 0.8  # the card tests' value: a sharper softmax than 1.0


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: the low 13 of the 23
    mantissa bits cleared, rounding to nearest with ties away from zero
    (adding half of the cleared range to the magnitude's bits)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def round_to_zero(x):
    """float64 x rounded toward zero to float32."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def mma(c, a, b):
    """One mma.sync step on TF32 values: c + a b with the products exact
    (two TF32 values multiply exactly in float64) and the result rounded
    toward zero to float32."""
    return round_to_zero(c.double() + a.double() @ b.double())


def mm(a, b, passes=3, acc=None):
    """acc + a @ b over the last axes as the kernels' mma.sync m16n8k8
    steps, acc zero if not given: per 8-deep k-step, lo hi', hi lo' and hi
    hi' (passes=3), or tf32(a) tf32(b') alone (passes=1)."""
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        if passes == 1:
            acc = mma(acc, tf32(ak), tf32(bk))
            continue
        (ah, al), (bh, bl) = split(ak), split(bk)
        acc = mma(acc, al, bh)
        acc = mma(acc, ah, bl)
        acc = mma(acc, ah, bh)
    return acc


def fma(a, b, c):
    """a b + c in float32 with one rounding."""
    return (a.double() * b.double() + c.double()).float()


def heads_of(t, heads):
    """[B, L, D] -> [B, H, L, hd]."""
    B, L, D = t.shape
    return t.view(B, L, heads, D // heads).transpose(1, 2)


def merge(t):
    B, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(B, L, H * hd)


def emulated_forward(q, k, v, heads, passes=3, one_accumulator=False):
    """The float32 forward kernel's arithmetic: 64-key tiles, the running
    max in log2 units, exp2 of one FMA (scale * log2(e) folded in), each
    tile's P V in a fresh accumulator and added to O by one FMA (O = O c +
    P V), O divided by the row sum once; lse = m ln 2 + log l. With
    `one_accumulator`, P V goes straight into O (rescaled by c) instead.
    Returns (out [B, L, D], lse [B, H, L])."""
    qh, kh, vh = (heads_of(t, heads) for t in (q, k, v))
    hd = qh.shape[-1]
    scale_log2 = torch.tensor(LOG2E / (math.sqrt(hd) * TEMPERATURE), dtype=torch.float32)
    m = torch.full(qh.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for k0 in range(0, kh.shape[-2], BK):
        s = mm(qh, kh[..., k0:k0 + BK, :].transpose(-1, -2), passes)
        n = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        c = torch.exp2(m - n)
        p = torch.exp2(torch.addcmul(-n, s, scale_log2.expand_as(s)))
        m = n
        l = l * c + p.sum(-1, keepdim=True)
        if one_accumulator:
            acc = mm(p, vh[..., k0:k0 + BK, :], passes, acc * c)
        else:
            acc = fma(acc, c.expand_as(acc), mm(p, vh[..., k0:k0 + BK, :], passes))
    return merge(acc / l), (m * math.log(2.0) + torch.log(l))[..., 0]


def emulated_backward(q, k, v, out, lse, dout, heads, q_tile):
    """The float32 fused backward kernel's arithmetic, query tile by query
    tile: S^T = K Q^T and dP^T = V dO^T, P^T = exp2(S^T scale log2(e) -
    lse log2(e)), dS^T = P^T (dP^T - delta) scale, then dV += P^T dO,
    dK += dS^T Q, each tile's sum formed in a fresh accumulator, and dQ +=
    dS K per block of 64 keys (the kernel adds those by atomics). Returns
    (dq, dk, dv) [B, L, D]."""
    qh, kh, vh, oh, gh = (heads_of(t, heads) for t in (q, k, v, out, dout))
    hd = qh.shape[-1]
    scale = 1.0 / (math.sqrt(hd) * TEMPERATURE)
    scale_log2 = scale * LOG2E
    delta = (gh * oh).sum(-1)
    dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)
    for q0 in range(0, qh.shape[-2], q_tile):
        rows = slice(q0, q0 + q_tile)
        qt, gt = qh[..., rows, :], gh[..., rows, :]
        st = mm(kh, qt.transpose(-1, -2))
        dpt = mm(vh, gt.transpose(-1, -2))
        pt = torch.exp2(st * scale_log2 - (lse[..., rows] * LOG2E)[..., None, :])
        dst = pt * (dpt - delta[..., None, rows]) * scale
        dv = dv + mm(pt, gt)
        dk = dk + mm(dst, qt)
        for k0 in range(0, kh.shape[-2], BK):
            keys = slice(k0, k0 + BK)
            dq[..., rows, :] += mm(dst[..., keys, :].transpose(-1, -2), kh[..., keys, :])
    return merge(dq), merge(dk), merge(dv)


def emulated_dq(q, k, v, out, lse, dout, heads, one_accumulator=False):
    """The float32 split dq kernel's arithmetic, query-stationary: per tile
    of 64 keys (32 at head_dim 128) S = Q K^T and dP = dO V^T, P =
    exp2(S scale log2(e) - lse log2(e)) by one FMA, dS = P (dP - delta)
    scale, then the tile's dS K in a fresh accumulator, added to dQ in
    float32; its k-steps take the tile's keys 8i..8i+7 in dS's fragment
    order (2t, 2t + 1: keys 0, 2, 4, 6, 1, 3, 5, 7 of the step). With
    `one_accumulator`, dS K goes straight into dQ instead. Returns dq [B,
    L, D]."""
    qh, kh, vh, oh, gh = (heads_of(t, heads) for t in (q, k, v, out, dout))
    hd = qh.shape[-1]
    bk = 32 if hd == 128 else BK
    scale = torch.tensor(1.0 / (math.sqrt(hd) * TEMPERATURE), dtype=torch.float32)
    scale_log2 = torch.tensor(float(scale) * LOG2E, dtype=torch.float32)
    delta = (gh * oh).sum(-1, keepdim=True)
    la = lse[..., None] * torch.tensor(LOG2E, dtype=torch.float32)
    order = torch.tensor([8 * i + j for i in range(bk // 8) for j in (0, 2, 4, 6, 1, 3, 5, 7)])
    dq = torch.zeros_like(qh)
    for k0 in range(0, kh.shape[-2], bk):
        kt, vt = kh[..., k0:k0 + bk, :], vh[..., k0:k0 + bk, :]
        s = mm(qh, kt.transpose(-1, -2))
        dp = mm(gh, vt.transpose(-1, -2))
        p = torch.exp2(fma(s, scale_log2.expand_as(s), -la.expand_as(s)))
        ds = p * (dp - delta) * scale
        if one_accumulator:
            dq = mm(ds[..., order], kt[..., order, :], acc=dq)
        else:
            dq = dq + mm(ds[..., order], kt[..., order, :])
    return merge(dq)


def inputs(head_dim, seed, batch=2, length=128, width=None):
    """q, k, v, dout [batch, length, width (4 head dims)] float32, from numpy
    draws."""
    rng = np.random.default_rng(seed)
    shape = (batch, length, width or 4 * head_dim)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(4)]


def rel_norm(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_split_parts():
    """hi and lo are TF32 values (the low 13 bits clear), hi + lo is within
    2^-21 of x, and the rounding is to nearest with ties away from zero."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()) \
        <= 2.0 ** -21
    one = torch.tensor([1.0, -1.0], dtype=torch.float32)
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    torch.testing.assert_close(tf32(tie), torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]),
                               atol=0, rtol=0)
    torch.testing.assert_close(tf32(one), one, atol=0, rtol=0)


@pytest.mark.parametrize("head_dim", [32, 64])
def test_split_tf32_forward_within_card_bounds(head_dim):
    q, k, v, _ = inputs(head_dim, seed=head_dim)
    heads = 4
    out, lse = emulated_forward(q, k, v, heads)
    rout, rlse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads, TEMPERATURE)
    torch.testing.assert_close(out, rout, atol=OUT_ATOL, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("head_dim", [32, 64])
def test_single_pass_tf32_exceeds_forward_bound(head_dim):
    """The negative control: one TF32 product per float32 product (~2^-11
    of each) leaves the output outside the card's 1e-5 bound."""
    q, k, v, _ = inputs(head_dim, seed=head_dim)
    out, _ = emulated_forward(q, k, v, 4, passes=1)
    rout = attn_ops.flash_attention_tokens_reference(q, k, v, 4, TEMPERATURE)
    assert float((out - rout).abs().max()) > OUT_ATOL


@pytest.mark.parametrize("head_dim", [32, 64])
def test_split_tf32_backward_within_card_bounds(head_dim):
    q, k, v, dout = inputs(head_dim, seed=10 + head_dim)
    heads = 4
    out, lse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads, TEMPERATURE)
    q_tile = 32 if head_dim >= 64 else 64  # the kernel's queries per streamed tile
    got = emulated_backward(q, k, v, out, lse, dout, heads, q_tile)
    refs = attn_ops.flash_attention_tokens_bwd_reference(q, k, v, out, lse, dout, heads,
                                                         TEMPERATURE)
    for name, a, b in zip(("dq", "dk", "dv"), got, refs):
        assert rel_norm(a, b) <= BWD_REL_NORM, (name, rel_norm(a, b))


def _dq_gap(head_dim, length, one_accumulator=False):
    """||d|| / ||ref|| of the emulated split dq kernel against the plain dq,
    4 heads, B = 2 at L = 128 and 1 above."""
    q, k, v, dout = inputs(head_dim, seed=20 + head_dim, batch=2 if length == 128 else 1,
                           length=length)
    heads = 4
    out, lse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads, TEMPERATURE)
    got = emulated_dq(q, k, v, out, lse, dout, heads, one_accumulator)
    ref = attn_ops.flash_attention_tokens_bwd_dq_reference(q, k, v, out, lse, dout, heads,
                                                           TEMPERATURE)
    return rel_norm(got, ref)


@pytest.mark.parametrize("head_dim,length", [(32, 128), (64, 128), (64, 1024)],
                         ids=["hd32", "hd64", "hd64-L1024"])
def test_split_tf32_dq_within_card_bound(head_dim, length):
    """The float32 split dq kernel's arithmetic (query-stationary, 64-key
    tiles, a fresh accumulator per tile, dS's fragment order) within the
    card's 1e-5 of the plain dq, at L = 128 and at L = 1024 (4 heads of 64:
    16 tiles added into dQ)."""
    gap = _dq_gap(head_dim, length)
    assert gap <= BWD_REL_NORM, gap


def test_dq_one_accumulator_exceeds_bound_at_1024():
    """The negative control of the dq kernel's design: dS K summed over all
    1024 keys in one accumulator (128 truncating k-steps) crosses 1e-5."""
    gap = _dq_gap(64, 1024, one_accumulator=True)
    assert gap > BWD_REL_NORM, gap


# L = 1024 with 16 heads of 16 (the card tests' width 256): 128 k-steps of
# P V, 384 mma.sync steps in one accumulator per output
LONG = dict(batch=1, length=1024, width=256)


@pytest.mark.parametrize("one_accumulator", [False, True], ids=["per-tile", "one-accumulator"])
def test_accumulator_per_tile_keeps_forward_bound_at_1024(one_accumulator):
    """The kernels' design (a fresh accumulator for each tile's P V, added
    in float32) keeps the 1e-5 bound at L = 1024; one accumulator over all
    of L, which the truncating accumulate biases toward zero at every
    step, exceeds it (the negative control)."""
    q, k, v, _ = inputs(16, seed=7, **LONG)
    out, _ = emulated_forward(q, k, v, 16, one_accumulator=one_accumulator)
    err = float((out - attn_ops.flash_attention_tokens_reference(q, k, v, 16, TEMPERATURE))
                .abs().max())
    assert (err > OUT_ATOL) if one_accumulator else (err <= OUT_ATOL), err
