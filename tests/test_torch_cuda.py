"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with a GPU and nvcc:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up JAX, which that machine lacks and
these tests do not use.)

Without a card every test here skips (decided inside the fixture, so every
test process collects the same tests).
"""
import math

import pytest
import torch

from smokephysai_tpu_torch.ops import attention as attn_ops
from smokephysai_tpu_torch.ops import fused_step as step_ops
from smokephysai_tpu_torch.physics import solver

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _state(dev, episodes, seed=0, h=128, w=128):
    g = torch.Generator().manual_seed(seed)
    s = solver.init_state((h, w), device=dev, batch=(episodes,))
    d = s.density
    for _ in range(3):
        x, y = (torch.rand(2, generator=g) * torch.tensor([w, h]) * 0.8 + 8).tolist()
        d = solver.add_smoke_source(d, x, y, radius=8.0, intensity=1.0)
    u = 0.5 * torch.randn(episodes, h + 1, w, generator=g)
    v = 0.5 * torch.randn(episodes, h, w + 1, generator=g)
    return [u.to(dev), v.to(dev), torch.zeros_like(d), d.contiguous()]


@pytest.mark.parametrize("episodes", [1, 4])
@pytest.mark.parametrize("max_disp", [1, 2])
def test_fused_step_kernel_matches_plain(cuda, episodes, max_disp):
    """atol 1e-5 on the fields (the kernel is built without FMA contraction);
    p also rtol 1e-5, since the divergence carries a 1/dt factor."""
    fields = _state(cuda, episodes)
    before = step_ops.LAUNCHES
    out = step_ops.fused_step(*fields, 0.01, 0.001, 20, max_disp)
    assert step_ops.LAUNCHES == before + 1
    ref = step_ops.fused_step_reference(*fields, 0.01, 0.001, 20, max_disp)
    for name, a, b in zip(("u", "v", "p", "density"), out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


def test_fused_step_kernel_odd_sweeps_and_shape(cuda):
    fields = _state(cuda, 2, h=48, w=80)
    out = step_ops.fused_step(*fields, 0.01, 0.001, 7, 1)
    ref = step_ops.fused_step_reference(*fields, 0.01, 0.001, 7, 1)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _bf16_ulp(x):
    """Spacing of bfloat16 numbers (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_kernel_matches_plain(cuda, dtype):
    """float32: atol 1e-5 (sums in another order). bfloat16: the largest |d|
    within two bf16 ulps of the largest output, and ||d|| / ||ref|| within
    2^-8: the kernel rounds P to bf16 against a running max per key tile,
    the plain version against the row's max, which leaves ~sqrt(2) * 2^-9
    of relative noise; one ulp off everywhere gives ~2^-7.5."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(3, 512, 256, generator=g).to(cuda, dtype) for _ in range(3))
    before = attn_ops.LAUNCHES
    out = attn_ops.flash_attention_tokens(q, k, v, 4, temperature=0.8)
    assert attn_ops.LAUNCHES == before + 1
    ref = attn_ops.flash_attention_tokens_reference(q, k, v, 4, temperature=0.8)
    assert out.dtype == dtype
    out, ref = out.float(), ref.float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        return
    atol = 2 * _bf16_ulp(float(ref.abs().max()))
    torch.testing.assert_close(out, ref, atol=atol, rtol=0)
    rel = torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)
    assert float(rel) <= 2.0 ** -8


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 128, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attn_ops.flash_attention_tokens(q, q, q, 2)
    with pytest.raises(ValueError, match="multiple"):
        attn_ops.flash_attention_tokens(q[:, :100], q[:, :100], q[:, :100], 4)
    with pytest.raises(TypeError, match="not supported"):
        attn_ops.flash_attention_tokens(q.half(), q.half(), q.half(), 4)


@pytest.mark.parametrize("episodes", [1, 4])
def test_fused_multi_step_kernel_matches_plain(cuda, episodes):
    """The multi-step kernel against its plain version (20 steps at 128^2):
    trajectory [N, T, H, W] and final state atol 1e-5, p also rtol 1e-5; and
    bit-equal to 20 launches of the single-step kernel, which runs the same
    stages in the same order. The inputs are not modified."""
    fields = _state(cuda, episodes)
    before = [f.clone() for f in fields]
    launches = step_ops.MULTI_LAUNCHES
    final, traj = step_ops.fused_multi_step(*fields, 20, 0.01, 0.001, 20, 1)
    assert step_ops.MULTI_LAUNCHES == launches + 1
    assert traj.shape == (episodes, 20, 128, 128)
    rfinal, rtraj = step_ops.fused_multi_step_reference(*fields, 20, 0.01, 0.001, 20, 1)
    torch.testing.assert_close(traj, rtraj, atol=1e-5, rtol=0)
    for a, b in zip(final, rfinal):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    s = fields
    for t in range(20):
        s = step_ops.fused_step(*s, 0.01, 0.001, 20, 1)
        assert torch.equal(traj[:, t], s[3]), t
    for a, b in zip(final, s):
        assert torch.equal(a, b)
    for a, b in zip(fields, before):
        assert torch.equal(a, b)


def _qkv(dev, dtype, batch=2, length=256, width=256, seed=3):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(batch, length, width, generator=g).to(dev, dtype) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_fwd_lse_kernel_matches_plain(cuda, dtype):
    """The forward-with-logsumexp kernel: out as the lean kernel is held
    (float32 atol 1e-5; bf16 two ulps of the largest output and ||d||/||ref||
    <= 2^-8); lse atol 1e-4 (float32 scores on both sides); the lean
    instantiation's output is unchanged by the variant."""
    q, k, v, _ = _qkv(cuda, dtype)
    before = attn_ops.LSE_LAUNCHES
    out, lse = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, 4, temperature=0.8)
    assert attn_ops.LSE_LAUNCHES == before + 1
    rout, rlse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, 4, 0.8)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    lean = attn_ops.flash_attention_tokens(q, k, v, 4, temperature=0.8)
    assert torch.equal(out, lean)
    out, rout = out.float(), rout.float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, rout, atol=1e-5, rtol=0)
        return
    torch.testing.assert_close(out, rout, atol=2 * _bf16_ulp(float(rout.abs().max())), rtol=0)
    assert float(torch.linalg.vector_norm(out - rout) / torch.linalg.vector_norm(rout)) <= 2.0 ** -8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_bwd_kernel_matches_plain(cuda, dtype):
    """The backward kernel against its plain version on the same forward
    output and lse: float32 ||d||/||ref|| <= 1e-5 for each of dq, dk, dv;
    bf16 <= 2^-10 (both sides round P against the same lse and dS once,
    and sum the products in another order, the kernel's dq by atomics:
    ~1e-4 on the card; one wrong (query, head) row of dq gives ~2^-5.5
    at this shape)."""
    q, k, v, dout = _qkv(cuda, dtype, seed=4)
    out, lse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, 4, 0.8)
    before = attn_ops.BWD_LAUNCHES
    grads = attn_ops.flash_attention_tokens_bwd(q, k, v, out, lse, dout, 4, 0.8)
    assert attn_ops.BWD_LAUNCHES == before + 1
    refs = attn_ops.flash_attention_tokens_bwd_reference(q, k, v, out, lse, dout, 4, 0.8)
    bound = 1e-5 if dtype == torch.float32 else 2.0 ** -10
    for name, a, b in zip("qkv", grads, refs):
        assert a.dtype == dtype and a.shape == b.shape, name
        rel = torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b.float())
        assert float(rel) <= bound, (name, float(rel))


def test_flash_training_gradient_reaches_q_proj(cuda):
    """ChaosAttention with use_flash=True on the card: the attention output
    has a grad_fn, q_proj (and every other projection) gets a nonzero
    gradient through the forward-with-lse and backward kernels, and the lean
    forward refuses an input that needs a gradient."""
    from smokephysai_tpu_torch.models.chaos_attention import ChaosAttention

    torch.manual_seed(0)
    attn = ChaosAttention(128, 2, dtype=torch.bfloat16, use_flash=True)
    for p in attn.parameters():
        torch.nn.init.uniform_(p, -0.1, 0.1)
    attn = attn.to(cuda)
    x = torch.randn(2, 128, 128, device=cuda)
    field = torch.randn(2, 128, 3, device=cuda)
    lse0, bwd0 = attn_ops.LSE_LAUNCHES, attn_ops.BWD_LAUNCHES
    out = attn(x, field)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    assert (attn_ops.LSE_LAUNCHES, attn_ops.BWD_LAUNCHES) == (lse0 + 1, bwd0 + 1)
    for name in ("q_proj", "k_proj", "v_proj", "chaos_proj", "chaos_gate", "out_proj"):
        grad = getattr(attn, name).weight.grad
        assert grad is not None and float(grad.abs().max()) > 0, name
    q = torch.randn(1, 64, 128, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="trainable"):
        attn_ops.flash_attention_tokens(q, q, q, 2)
