"""The port's flash attention plain versions against the JAX package's
token-major Pallas kernels (interpret mode on the CPU): the lean forward,
and the training pair (forward with logsumexp, backward through the
autograd Function); and the wrappers' checks. Inputs are made with numpy
from a seed and handed to both.

Tolerances: float32 atol 1e-5 (sums taken in another order). bfloat16
(the probabilities are rounded to bf16 before P.V on both sides, and the
output is bf16): the largest |d| within two bf16 ulps of the largest
output, and ||d|| / ||ref|| within 2^-8, the bound the card's kernel is
held to (one ulp off everywhere gives ~2^-7.5).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
from smokephysai_tpu.ops.pallas.attention import (
    _flash_tokens_fwd_lse,
    flash_attention_tokens as jflash,
    flash_attention_tokens_trainable as jflash_trainable,
)
from smokephysai_tpu_torch.ops import attention as attn
from smokephysai_tpu_torch.ops.attention import (
    flash_attention_tokens,
    flash_attention_tokens_reference,
)

B, L, D, H = 2, 256, 128, 2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize(
    "jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
    ids=["f32", "bf16"],
)
def test_reference_matches_pallas(jdtype, tdtype):
    q, k, v = _inputs(0)
    jout = jflash(*(jnp.asarray(a, jdtype) for a in (q, k, v)), H, temperature=0.7)
    tq, tk, tv = (torch.from_numpy(a).to(tdtype) for a in (q, k, v))
    tout = flash_attention_tokens_reference(tq, tk, tv, H, temperature=0.7)
    assert tout.dtype == tdtype and tout.shape == (B, L, D)
    got, want = tout.float().numpy(), np.asarray(jout, np.float32)
    if tdtype == torch.float32:
        atol = 1e-5
    else:
        atol = 2 * 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2.0 ** -8
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    # on CPU tensors the wrapper is the plain version
    torch.testing.assert_close(
        flash_attention_tokens(tq, tk, tv, H, temperature=0.7), tout, rtol=0, atol=0
    )


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(ValueError, match="shape"):
        flash_attention_tokens(q, k[:, :-64], v, H)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_tokens(q, k.double(), v, H)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention_tokens(q, k, v, 3)


# ---------------------------------------------------------------- training pair

TB, TL, TD, TH = 1, 128, 128, 2
TEMP = 0.8


def _qkvg(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((TB, TL, TD)).astype(np.float32) for _ in range(4)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_fwd_lse_matches_pallas(jdtype, tdtype):
    """The plain forward-with-logsumexp against `_flash_tokens_fwd_lse`.
    float32: out atol 2e-5, lse atol 1e-5. bfloat16: out within two bf16
    ulps of its largest value and ||d||/||ref|| <= 2^-8 (as the lean
    forward above); lse atol 1e-4 (float32 scores
    of the same bf16 inputs on both sides)."""
    q, k, v, _ = _qkvg(0)
    scale = 1.0 / (np.sqrt(TD // TH) * TEMP)
    jout, jlse = _flash_tokens_fwd_lse(*(jnp.asarray(a, jdtype) for a in (q, k, v)),
                                       TH, scale, TL, TL)
    tq, tk, tv = (torch.from_numpy(a).to(tdtype) for a in (q, k, v))
    out, lse = attn.flash_attention_tokens_fwd_lse(tq, tk, tv, TH, TEMP)
    assert out.dtype == tdtype and lse.dtype == torch.float32 and lse.shape == (TB, TH, TL)
    got, want = out.float().numpy(), np.asarray(jout, np.float32)
    if tdtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, atol=2 * ulp, rtol=0)
        assert _rel(got, want) <= 2.0 ** -8
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-4, rtol=0)


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_trainable_grads_match_jax(jdtype, tdtype):
    """Gradients of sum(flash(q, k, v) * g) through the port's autograd
    Function (plain versions on the CPU) against jax.grad through
    `flash_attention_tokens_trainable` (Pallas forward and fused backward in
    interpret mode). float32: atol 2e-5, as tests/test_pallas.py holds the
    JAX pair. bfloat16: ||d||/||ref|| <= 2^-7 for each of dq, dk, dv (P and
    dS are rounded to bf16 once on each side, against other maxima)."""
    q, k, v, g = _qkvg(1)
    jargs = [jnp.asarray(a, jdtype) for a in (q, k, v)]
    jg = jnp.asarray(g, jdtype)
    jgrads = jax.grad(
        lambda q_, k_, v_: jnp.sum((jflash_trainable(q_, k_, v_, TH, TEMP) * jg)
                                   .astype(jnp.float32)),
        argnums=(0, 1, 2))(*jargs)
    tq, tk, tv = (torch.from_numpy(a).to(tdtype).requires_grad_() for a in (q, k, v))
    out = attn.flash_attention_tokens_trainable(tq, tk, tv, TH, TEMP)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g).to(tdtype))
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        assert t.grad.dtype == tdtype
        got, want = t.grad.float().numpy(), np.asarray(j, np.float32)
        if tdtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, err_msg=name)
        else:
            assert _rel(got, want) <= 2.0 ** -7, name


def test_function_grads_equal_autograd_of_plain_forward():
    """float32: the Function's backward (the plain backward) against
    autograd through the plain forward, atol 1e-5; with no input needing a
    gradient the trainable entry point is the lean forward."""
    q, k, v, g = _qkvg(2)
    gt = torch.from_numpy(g)
    grads = []
    for fn in (attn.flash_attention_tokens_trainable,
               attn.flash_attention_tokens_reference):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        fn(*ts, TH, TEMP).backward(gt)
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    with torch.no_grad():
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        torch.testing.assert_close(
            attn.flash_attention_tokens_trainable(tq, tk, tv, TH, TEMP),
            attn.flash_attention_tokens(tq, tk, tv, TH, TEMP), rtol=0, atol=0)


def test_bwd_wrapper_rejects_bad_inputs():
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(3))
    out, lse = attn.flash_attention_tokens_fwd_lse(q, k, v, TH)
    with pytest.raises(ValueError, match="lse"):
        attn.flash_attention_tokens_bwd(q, k, v, out, lse[:, :1], g, TH)
    with pytest.raises(TypeError, match="dtype"):
        attn.flash_attention_tokens_bwd(q, k, v, out.double(), lse, g, TH)


# ---------------------------------------------------------------- head_dim 32

HB, HL, HD32, HH = 1, 128, 128, 4  # 4 heads of 32, as the volumetric trunk's 8 of 32


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_head_dim_32_matches_pallas(jdtype, tdtype):
    """At head_dim 32 the plain versions of all three kernels against the
    JAX package's Pallas kernels (interpret mode), with the head_dim-64
    tests' bounds: the lean forward and the forward with logsumexp (float32
    out atol 2e-5 and lse 1e-5; bf16 out two ulps and ||d||/||ref|| 2^-8,
    lse 1e-4) and the gradients through the autograd Function (float32
    atol 2e-5; bf16 ||d||/||ref|| 2^-7)."""
    rng = np.random.default_rng(9)
    q, k, v, g = (rng.standard_normal((HB, HL, HD32)).astype(np.float32) for _ in range(4))
    jargs = [jnp.asarray(a, jdtype) for a in (q, k, v)]
    scale = 1.0 / (np.sqrt(HD32 // HH) * TEMP)
    jlean = jflash(*jargs, HH, temperature=TEMP)
    jout, jlse = _flash_tokens_fwd_lse(*jargs, HH, scale, HL, HL)
    jg = jnp.asarray(g, jdtype)
    jgrads = jax.grad(
        lambda q_, k_, v_: jnp.sum((jflash_trainable(q_, k_, v_, HH, TEMP) * jg)
                                   .astype(jnp.float32)),
        argnums=(0, 1, 2))(*jargs)
    tq, tk, tv = (torch.from_numpy(a).to(tdtype) for a in (q, k, v))
    lean = flash_attention_tokens(tq, tk, tv, HH, temperature=TEMP)
    out, lse = attn.flash_attention_tokens_fwd_lse(tq, tk, tv, HH, TEMP)
    assert lse.shape == (HB, HH, HL)
    for got, want in ((lean, jlean), (out, jout)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if tdtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
            np.testing.assert_allclose(got, want, atol=2 * ulp, rtol=0)
            assert _rel(got, want) <= 2.0 ** -8
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               atol=1e-5 if tdtype == torch.float32 else 1e-4, rtol=0)
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    attn.flash_attention_tokens_trainable(*ts, HH, TEMP).backward(
        torch.from_numpy(g).to(tdtype))
    for name, t, j in zip("qkv", ts, jgrads):
        got, want = t.grad.float().numpy(), np.asarray(j, np.float32)
        if tdtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, err_msg=name)
        else:
            assert _rel(got, want) <= 2.0 ** -7, name


# ---------------------------------------------------------------- tail shapes

@pytest.mark.parametrize("head_dim", [16, 128])
def test_tail_length_matches_pallas(head_dim):
    """L = 192 (three 64-row tiles: the card's kernel takes 128 queries and
    128 keys at a time, so its last query tile is half out of range and its
    last key tile half masked) at head dims 16 and 128, B = 3, bf16: the
    plain lean forward and forward with logsumexp against the JAX package's
    `flash_attention_tokens(..., block_q=64, block_k=64)` and
    `_flash_tokens_fwd_lse` (interpret mode), with the head_dim-64 tests'
    bounds: out within two bf16 ulps of its largest value and
    ||d||/||ref|| <= 2^-8, lse atol 1e-4."""
    b, length, width = 3, 192, 128
    heads = width // head_dim
    rng = np.random.default_rng(head_dim)
    q, k, v = (rng.standard_normal((b, length, width)).astype(np.float32) for _ in range(3))
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    scale = 1.0 / (np.sqrt(head_dim) * TEMP)
    jlean = jflash(*jargs, heads, temperature=TEMP, block_q=64, block_k=64)
    jout, jlse = _flash_tokens_fwd_lse(*jargs, heads, scale, 64, 64)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    lean = flash_attention_tokens(tq, tk, tv, heads, temperature=TEMP)
    out, lse = attn.flash_attention_tokens_fwd_lse(tq, tk, tv, heads, TEMP)
    assert lean.shape == (b, length, width) and lse.shape == (b, heads, length)
    for got, want in ((lean, jlean), (out, jout)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, atol=2 * ulp, rtol=0)
        assert _rel(got, want) <= 2.0 ** -8
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-4, rtol=0)
