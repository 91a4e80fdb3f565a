"""The port's split flash backward (the `SMOKEPHYS_FUSED_BWD=0` route) and
head-major `flash_attention` against the JAX package, on the CPU: the
plain versions of the dq and dk/dv kernels against `_flash_trainable_bwd`'s
split Pallas kernels, the gradients of the trainable attention under the
split route against `jax.grad`, `flash_attention_reference` against the JAX
`flash_attention` (Pallas kernels in interpret mode, as tests/test_pallas.py
runs them), and the wrappers' refusals. Inputs are made with numpy from a
seed and handed to both.

Tolerances (those of tests/test_torch_attention.py): float32 atol 2e-5 (sums
in another order). bfloat16 gradients: ||d||/||ref|| <= 2^-7 for each of
dq, dk, dv (P and dS are rounded to bf16 once on each side, against other
maxima in the forward). bfloat16 forward: the largest |d| within two bf16
ulps of the largest output and ||d||/||ref|| <= 2^-8 (the probabilities
are rounded against a running max per key block on the JAX side and
against the row's max in the plain version).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
from smokephysai_tpu.ops.pallas.attention import (
    _flash_tokens_fwd_lse,
    _flash_trainable_bwd,
    flash_attention as jflash_hm,
    flash_attention_tokens_trainable as jflash_trainable,
)
from smokephysai_tpu_torch.ops import attention as attn

DTYPES = pytest.mark.parametrize(
    "jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
    ids=["f32", "bf16"])

# tests/test_pallas.py::test_flash_bwd_fused_matches_split's shape
B, L, D, H = 2, 256, 128, 8
BLOCK_Q = 64
TEMP = 0.9


def _arrays(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_grads(got, want, tdtype):
    for name, g, w in zip("qkv", got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if tdtype == torch.float32:
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=name)
        else:
            assert _rel(g, w) <= 2.0 ** -7, (name, _rel(g, w))


@DTYPES
def test_split_references_match_jax(monkeypatch, jdtype, tdtype):
    """`flash_attention_tokens_bwd_dq_reference` and `..._dkv_reference`
    against `_flash_trainable_bwd` with SMOKEPHYS_FUSED_BWD=0 (the split dq
    and dk/dv Pallas kernels) on the same q, k, v and on out and lse from
    `_flash_tokens_fwd_lse`; `flash_attention_tokens_bwd` on CPU tensors,
    under either value of the variable, is those plain versions bit for
    bit."""
    monkeypatch.setenv("SMOKEPHYS_FUSED_BWD", "0")
    q, k, v, g = _arrays(0, (B, L, D), 4)
    jq, jk, jv, jg = (jnp.asarray(a, jdtype) for a in (q, k, v, g))
    scale = 1.0 / (np.sqrt(D // H) * TEMP)
    jout, jlse = _flash_tokens_fwd_lse(jq, jk, jv, H, scale, BLOCK_Q, L)
    bwd = jax.jit(functools.partial(_flash_trainable_bwd, H, TEMP, BLOCK_Q, L))
    jgrads = bwd((jq, jk, jv, jout, jlse), jg)

    tq, tk, tv, tg = (torch.from_numpy(a).to(tdtype) for a in (q, k, v, g))
    tout = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(tdtype)
    tlse = torch.from_numpy(np.array(jlse))
    args = (tq, tk, tv, tout, tlse, tg, H, TEMP)
    dq = attn.flash_attention_tokens_bwd_dq_reference(*args)
    dk, dv = attn.flash_attention_tokens_bwd_dkv_reference(*args)
    assert all(t.dtype == tdtype and t.shape == (B, L, D) for t in (dq, dk, dv))
    _check_grads((dq, dk, dv), jgrads, tdtype)

    for env in ("0", "1"):
        monkeypatch.setenv("SMOKEPHYS_FUSED_BWD", env)
        for a, b in zip(attn.flash_attention_tokens_bwd(*args), (dq, dk, dv)):
            assert torch.equal(a, b), env


@DTYPES
def test_split_trainable_grads_match_jax(monkeypatch, jdtype, tdtype):
    """Under SMOKEPHYS_FUSED_BWD=0, the gradients of sum(flash(q, k, v) * g)
    through the port's `flash_attention_tokens_trainable` (on the CPU, the
    plain backward) against `jax.grad` through the JAX package's
    trainable attention on its split kernels; at 2 heads of 32 and two
    query blocks, a smaller shape than above for the time of the JAX
    compile."""
    monkeypatch.setenv("SMOKEPHYS_FUSED_BWD", "0")
    heads = 2
    q, k, v, g = _arrays(1, (1, 128, 64), 4)
    jargs = [jnp.asarray(a, jdtype) for a in (q, k, v)]
    jg = jnp.asarray(g, jdtype)
    jgrads = jax.grad(
        lambda q_, k_, v_: jnp.sum((jflash_trainable(q_, k_, v_, heads, TEMP,
                                                     block_q=BLOCK_Q) * jg)
                                   .astype(jnp.float32)),
        argnums=(0, 1, 2))(*jargs)
    ts = [torch.from_numpy(a).to(tdtype).requires_grad_() for a in (q, k, v)]
    attn.flash_attention_tokens_trainable(*ts, heads, TEMP).backward(
        torch.from_numpy(g).to(tdtype))
    assert all(t.grad.dtype == tdtype for t in ts)
    _check_grads([t.grad for t in ts], jgrads, tdtype)


# tests/test_pallas.py::test_flash_attention_matches_einsum and
# ::test_flash_attention_temperature
HM_CASES = pytest.mark.parametrize(
    "shape,temperature,blocks", [((2, 4, 256, 64), 1.0, (128, 128)),
                                 ((1, 2, 128, 32), 1.5, (64, 64))],
    ids=["einsum", "temperature"])


@HM_CASES
@DTYPES
def test_flash_attention_reference_matches_jax(jdtype, tdtype, shape, temperature,
                                               blocks):
    """`flash_attention_reference` against the JAX head-major
    `flash_attention` (Pallas, interpret mode) at tests/test_pallas.py's
    two cases; the wrapper on CPU tensors is the plain version bit for
    bit."""
    q, k, v = _arrays(sum(shape), shape, 3)
    want = np.asarray(jflash_hm(*(jnp.asarray(a, jdtype) for a in (q, k, v)),
                                temperature=temperature, block_q=blocks[0],
                                block_k=blocks[1]).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(tdtype) for a in (q, k, v))
    out = attn.flash_attention_reference(tq, tk, tv, temperature)
    assert out.dtype == tdtype and out.shape == shape
    got = out.float().numpy()
    if tdtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, atol=2 * ulp, rtol=0)
        assert _rel(got, want) <= 2.0 ** -8
    assert torch.equal(attn.flash_attention(tq, tk, tv, temperature, *blocks), out)


def test_wrappers_refuse_what_they_do_not_take(monkeypatch):
    """Rank, shape and dtype on every device; the JAX block-size asserts;
    on a non-CPU tensor (the meta device, which carries no data) the
    kernels' own limits: head dims outside HEAD_DIMS and L not a multiple
    of 64. The backward refuses alike on the fused and the split route."""
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match=r"\[B, H, L, D\]"):
        attn.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match=r"\[B, H, L, D\]"):
        attn.flash_attention(q, q[:, :1], q)
    with pytest.raises(TypeError, match="dtype"):
        attn.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="divide"):
        attn.flash_attention(q, q, q, block_q=96)
    with pytest.raises(ValueError, match="divide"):
        attn.flash_attention(q, q, q, block_k=0)
    meta = torch.empty(1, 2, 128, 48, device="meta")
    with pytest.raises(ValueError, match="head_dim 48"):
        attn.flash_attention(meta, meta, meta)
    meta = torch.empty(1, 2, 96, 64, device="meta")
    with pytest.raises(ValueError, match="multiple of 64"):
        attn.flash_attention(meta, meta, meta)

    t = torch.zeros(1, 128, 64)
    lse = torch.zeros(1, 2, 128)
    fn = attn.flash_attention_tokens_bwd
    for env in ("1", "0"):
        monkeypatch.setenv("SMOKEPHYS_FUSED_BWD", env)
        with pytest.raises(ValueError, match="shape"):
            fn(t, t[:, :64], t, t, lse, t, 2)
        with pytest.raises(TypeError, match="dtype"):
            fn(t, t, t, t, lse, t.double(), 2)
        with pytest.raises(ValueError, match="lse"):
            fn(t, t, t, t, lse[:, :1], t, 2)
        m = torch.empty(1, 128, 96, device="meta")
        with pytest.raises(ValueError, match="head_dim 48"):
            fn(m, m, m, m, torch.empty(1, 2, 128, device="meta"), m, 2)
        m = torch.empty(1, 96, 64, device="meta")
        with pytest.raises(ValueError, match="multiple of 64"):
            fn(m, m, m, m, torch.empty(1, 2, 96, device="meta"), m, 2)
