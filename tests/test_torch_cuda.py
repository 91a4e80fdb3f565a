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
from smokephysai_tpu_torch.ops import cg3d as cg_ops
from smokephysai_tpu_torch.ops import fused_step as step_ops
from smokephysai_tpu_torch.ops import jacobi as jacobi_ops
from smokephysai_tpu_torch.ops import stencil as stencil_ops
from smokephysai_tpu_torch.physics import solver, solver3d

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# far taps: at dt FAST_DT a divergence-free shear of amplitude SHEAR (u a
# function of the column, v of the row) moves most cells 1 to 3.6 cells a
# step, so every tap of radius 2 and 3 carries weight, across CTA stripes
FAST_DT = 1.0
SHEAR = 3.0


def _state(dev, episodes, seed=0, h=128, w=128, shear=0.0):
    g = torch.Generator().manual_seed(seed)
    s = solver.init_state((h, w), device=dev, batch=(episodes,))
    d = s.density
    for _ in range(3):
        x, y = (torch.rand(2, generator=g) * torch.tensor([w, h]) * 0.8 + 8).tolist()
        d = solver.add_smoke_source(d, x, y, radius=8.0, intensity=1.0)
    u = 0.5 * torch.randn(episodes, h + 1, w, generator=g)
    v = 0.5 * torch.randn(episodes, h, w + 1, generator=g)
    if shear:
        phase = torch.rand(2, episodes, 1, 1, generator=g) * 2 * math.pi
        cols = torch.arange(w, dtype=torch.float32)
        rows = torch.arange(h, dtype=torch.float32)[:, None]
        u = u + shear * torch.sin(2 * math.pi * cols / 37 + phase[0])
        v = v + shear * torch.cos(2 * math.pi * rows / 29 + phase[1])
    return [u.to(dev), v.to(dev), torch.zeros_like(d), d.contiguous()]


def _far_taps_matter(fields, dt, iters, max_disp):
    """The plain step at max_disp - 1 differs from the one at max_disp by
    more than half a cell's density: the outermost taps carry weight."""
    near = step_ops.fused_step_reference(*fields, dt, 0.001, iters, max_disp - 1)
    far = step_ops.fused_step_reference(*fields, dt, 0.001, iters, max_disp)
    return max(float((a - b).abs().max()) for a, b in zip(near, far)) > 0.5


@pytest.mark.parametrize("episodes", [1, 4, 64])
@pytest.mark.parametrize("max_disp,shear", [(1, 0.0), (2, 0.0), (3, 0.0), (2, SHEAR), (3, SHEAR)],
                         ids=["1", "2", "3", "2-far", "3-far"])
def test_fused_step_kernel_matches_plain(cuda, episodes, max_disp, shear):
    """atol 1e-5 on the fields (the kernel is built without FMA contraction);
    p also rtol 1e-5, since the divergence carries a 1/dt factor. 128^2 in
    the shared mode; max_disp 3 takes the runtime-radius instantiation. The
    "far" cases move cells far (dt FAST_DT, the shear), so a tap crosses
    into the neighbouring CTA's stripe and its halo rows (a cluster of
    several CTAs at one episode)."""
    fields = _state(cuda, episodes, shear=shear)
    dt = FAST_DT if shear else 0.01
    plan = step_ops.launch_plan(episodes, 128, 128, max_disp, device=cuda)
    assert plan.mode == "shared" and (episodes > 1 or plan.cluster > 1)
    if shear:
        assert _far_taps_matter(fields, dt, 20, max_disp)
    before = step_ops.LAUNCHES
    out = step_ops.fused_step(*fields, dt, 0.001, 20, max_disp)
    assert step_ops.LAUNCHES == before + 1
    ref = step_ops.fused_step_reference(*fields, dt, 0.001, 20, max_disp)
    for name, a, b in zip(("u", "v", "p", "density"), out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("h,w,iters,max_disp,shear",
                         [(48, 80, 7, 1, 0.0), (3, 70, 20, 1, 0.0), (2, 2, 3, 1, 0.0),
                          (48, 80, 7, 3, SHEAR), (3, 70, 0, 2, SHEAR)],
                         ids=["48x80", "3x70", "2x2", "48x80-r3", "3x70-0sweeps"])
def test_fused_step_kernel_odd_sweeps_and_shape(cuda, h, w, iters, max_disp, shear):
    """Odd and tiny grids, odd and zero sweep counts, two episodes (same
    bounds as above); the radius-3 and radius-2 cases move cells far
    (dt FAST_DT, the shear)."""
    fields = _state(cuda, 2, h=h, w=w, shear=shear)
    dt = FAST_DT if shear else 0.01
    out = step_ops.fused_step(*fields, dt, 0.001, iters, max_disp)
    ref = step_ops.fused_step_reference(*fields, dt, 0.001, iters, max_disp)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size,mode,cluster", [(256, "shared", 16), (1024, "global", 16)])
def test_fused_step_kernel_large_grids(cuda, size, mode, cluster):
    """One episode at 256^2 (state in a cluster of 16 CTAs' shared memory)
    and at 1024^2 (the global mode, still a cluster of 16): the same bounds
    as at 128^2."""
    plan = step_ops.launch_plan(1, size, size, 1, device=cuda)
    assert (plan.mode, plan.cluster) == (mode, cluster)
    fields = _state(cuda, 1, h=size, w=size)
    out = step_ops.fused_step(*fields, 0.01, 0.001, 20, 1)
    ref = step_ops.fused_step_reference(*fields, 0.01, 0.001, 20, 1)
    for name, a, b in zip(("u", "v", "p", "density"), out, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


def test_solver_runs_the_kernels_at_any_tap_radius(cuda):
    """`step` and `multi_step` with use_pallas and max_disp 3 go through the
    fused kernels (one launch each), as the JAX package's do, and agree
    with the plain versions (bounds as above), at 64^2 with cells moving
    far (dt FAST_DT, the shear)."""
    fields = [f[0] for f in _state(cuda, 1, h=64, w=64, shear=SHEAR)]
    assert _far_taps_matter(fields, FAST_DT, 20, 3)
    state = solver.SimState(*fields)
    launches = (step_ops.LAUNCHES, step_ops.MULTI_LAUNCHES)
    out = solver.step(state, dt=FAST_DT, viscosity=0.001, use_pallas=True, max_disp=3)
    final, traj = solver.multi_step(state, 5, dt=FAST_DT, viscosity=0.001, use_pallas=True,
                                    max_disp=3)
    assert (step_ops.LAUNCHES, step_ops.MULTI_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    ref = step_ops.fused_step_reference(*fields, FAST_DT, 0.001, 20, 3)
    for a, b in zip((out.u, out.v, out.p, out.density), ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    rfinal, rtraj = step_ops.fused_multi_step_reference(*fields, 5, FAST_DT, 0.001, 20, 3)
    torch.testing.assert_close(traj, rtraj, atol=1e-5, rtol=0)
    for a, b in zip((final.u, final.v, final.p, final.density), rfinal):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _bf16_ulp(x):
    """Spacing of bfloat16 numbers (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


# (batch, length, head_dim) of the forward tests, width 256: the first is
# each test's shape before the tail cases; then every head dim at L = 64
# and 192, odd counts of 64-row tiles (the bf16 kernel's last 128-query
# tile is half out of range and its last 128-key tile half masked), and
# at 1024; B >= 3, so that a read past a batch element's end would show
FWD_SHAPES = [(3, L, hd) for hd in (16, 32, 64, 128) for L in (64, 192, 1024)]


def _fwd_id(shape):
    return "B{}-L{}-hd{}".format(*shape)


@pytest.mark.parametrize("shape", [(3, 512, 64)] + FWD_SHAPES, ids=_fwd_id)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_kernel_matches_plain(cuda, dtype, shape):
    """float32: atol 1e-5 (sums in another order). bfloat16: the largest |d|
    within two bf16 ulps of the largest output, and ||d|| / ||ref|| within
    2^-8: the kernel rounds P to bf16 against a running max per key tile,
    the plain version against the row's max, which leaves ~sqrt(2) * 2^-9
    of relative noise; one ulp off everywhere gives ~2^-7.5. A second call
    gives the same bits."""
    batch, length, head_dim = shape
    heads = 256 // head_dim
    g = torch.Generator().manual_seed(1 + length + head_dim)
    q, k, v = (torch.randn(batch, length, 256, generator=g).to(cuda, dtype)
               for _ in range(3))
    before = attn_ops.LAUNCHES
    out = attn_ops.flash_attention_tokens(q, k, v, heads, temperature=0.8)
    assert attn_ops.LAUNCHES == before + 1
    assert torch.equal(out, attn_ops.flash_attention_tokens(q, k, v, heads, temperature=0.8))
    ref = attn_ops.flash_attention_tokens_reference(q, k, v, heads, temperature=0.8)
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
    with pytest.raises(ValueError, match="head_dim"):  # 256: no instantiation
        attn_ops.flash_attention_tokens(q, q, q, 1)
    with pytest.raises(ValueError, match="multiple"):
        attn_ops.flash_attention_tokens(q[:, :100], q[:, :100], q[:, :100], 4)
    with pytest.raises(TypeError, match="not supported"):
        attn_ops.flash_attention_tokens(q.half(), q.half(), q.half(), 4)


@pytest.mark.parametrize("episodes", [1, 4])
@pytest.mark.parametrize("max_disp,shear", [(1, 0.0), (3, 0.0), (2, SHEAR), (3, SHEAR)],
                         ids=["1", "3", "2-far", "3-far"])
def test_fused_multi_step_kernel_matches_plain(cuda, episodes, max_disp, shear):
    """The multi-step kernel against its plain version (20 steps at 128^2):
    trajectory [N, T, H, W] and final state atol 1e-5, p also rtol 1e-5; and
    bit-equal to 20 launches of the single-step kernel, which runs the same
    stages in the same order. The inputs are not modified. The "far" cases
    move cells far (dt FAST_DT, the shear)."""
    fields = _state(cuda, episodes, shear=shear)
    dt = FAST_DT if shear else 0.01
    if shear:
        assert _far_taps_matter(fields, dt, 20, max_disp)
    before = [f.clone() for f in fields]
    launches = step_ops.MULTI_LAUNCHES
    final, traj = step_ops.fused_multi_step(*fields, 20, dt, 0.001, 20, max_disp)
    assert step_ops.MULTI_LAUNCHES == launches + 1
    assert traj.shape == (episodes, 20, 128, 128)
    rfinal, rtraj = step_ops.fused_multi_step_reference(*fields, 20, dt, 0.001, 20, max_disp)
    torch.testing.assert_close(traj, rtraj, atol=1e-5, rtol=0)
    for a, b in zip(final, rfinal):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    s = fields
    for t in range(20):
        s = step_ops.fused_step(*s, dt, 0.001, 20, max_disp)
        assert torch.equal(traj[:, t], s[3]), t
    for a, b in zip(final, s):
        assert torch.equal(a, b)
    for a, b in zip(fields, before):
        assert torch.equal(a, b)


def _pressure_inputs(dev, episodes, h, w, seed=5):
    g = torch.Generator().manual_seed(seed)
    p = 0.1 * torch.randn(episodes, h, w, generator=g)
    div = torch.randn(episodes, h, w, generator=g)
    return p.to(dev), div.to(dev)


@pytest.mark.parametrize("iters", [0, 1, 20])
@pytest.mark.parametrize("episodes", [1, 3])
def test_jacobi_kernel_matches_plain(cuda, episodes, iters):
    """The Jacobi kernel at 256^2 (the cluster mode) against its plain
    version: bit-equal (built without FMA contraction, same order of
    additions), one launch, inputs not modified."""
    p, div = _pressure_inputs(cuda, episodes, 256, 256)
    before = (p.clone(), div.clone())
    assert jacobi_ops.launch_plan(episodes, 256, 256, device=cuda).mode == "cluster"
    launches = jacobi_ops.LAUNCHES
    out = jacobi_ops.jacobi_pressure(p, div, iters)
    assert jacobi_ops.LAUNCHES == launches + 1
    assert torch.equal(out, jacobi_ops.jacobi_pressure_reference(p, div, iters))
    assert torch.equal(p, before[0]) and torch.equal(div, before[1])


@pytest.mark.parametrize("h,w,iters", [(37, 53, 20), (2, 2, 3), (3, 70, 1), (101, 67, 45),
                                       (2048, 2048, 20), (3, 8, 5), (33, 260, 7)],
                         ids=["odd", "2x2", "3x70", "two-passes", "2048", "last-stripe-1-row",
                              "260-wide"])
def test_jacobi_kernel_odd_and_large_grids(cuda, h, w, iters):
    """Bit-equal on odd and tiny grids, past MAX_DEPTH sweeps, on a 3 x 8
    grid whose last stripe has one row, at 260 columns (65 quads: a warp's
    ends inside a row, idle lanes past it) and on a
    2048^2 grid, where the TPU kernel tiles; as many launches as the plan
    says (one in the cluster mode, one per pass in the band mode). The band
    mode forced on each grid that has room for a band (the smallest
    shared-memory budget that gives one) through the wrapper's launcher
    gives the same bits (past MAX_DEPTH: two passes through scratch)."""
    p, div = _pressure_inputs(cuda, 2 if h < 2048 else 1, h, w)
    plan = jacobi_ops.launch_plan(p.shape[0], h, w, device=cuda, num_iters=iters)
    assert plan.mode == ("band" if h == 2048 else "cluster")
    launches = jacobi_ops.LAUNCHES
    out = jacobi_ops.jacobi_pressure(p, div, iters)
    assert jacobi_ops.LAUNCHES == launches + plan.launches(iters)
    want = jacobi_ops.jacobi_pressure_reference(p, div, iters)
    assert torch.equal(out, want)
    for band in _forced_bands(p.shape[0], h, w, iters)[:1]:
        assert torch.equal(jacobi_ops._launch(p, div, iters, band), want), band.describe()


def test_jacobi_kernel_unaligned_planes(cuda):
    """Planes that are not 16-byte aligned (views one float into a buffer)
    take one cell a thread whatever the plan's strip: the same bits."""
    g = torch.Generator().manual_seed(8)
    flat = torch.randn(2, 1 + 2 * 256 * 256, generator=g).to(cuda)
    p = flat[0, 1:].view(2, 256, 256)
    div = flat[1, 1:].view(2, 256, 256)
    assert p.data_ptr() % 16 and div.data_ptr() % 16
    assert jacobi_ops.launch_plan(2, 256, 256, device=cuda).strip > 0
    out = jacobi_ops.jacobi_pressure(p, div, 20)
    assert torch.equal(out, jacobi_ops.jacobi_pressure_reference(p, div, 20))


def _card_jacobi_count():
    return jacobi_ops.card_active_clusters(torch.cuda.current_device())


def _forced_bands(episodes, h, w, iters):
    """The band plans the card holds for calls of `iters` sweeps within the
    smallest shared-memory budget a CTA that gives any (several bands on a
    grid that fits one cluster); none where no band fits the grid."""
    count = _card_jacobi_count()
    for rows in range(1, h):
        plans = list(jacobi_ops.band_candidates(episodes, h, w, iters, count,
                                                smem_max=jacobi_ops.stripe_bytes(rows, w)))
        if plans:
            return plans
    return []


@pytest.mark.parametrize("shape", [(1, 256, 256), (3, 256, 256), (2, 37, 53), (1, 512, 512),
                                   (1, 1024, 1024), (1, 2048, 2048), (2, 1100, 900)],
                         ids=["256", "3x256", "odd", "512", "1024", "2048", "1100x900"])
def test_jacobi_kernel_every_plan_bit_equal(cuda, shape):
    """Every cluster plan the card holds (each cluster size and thread shape
    of `plan_candidates`: register strips of 1, 2 or 4 rows where w is a
    multiple of 4, one cell a thread at 37 x 53) and band plans give the
    plain version's bits at 0, 1, 20 and 45 sweeps: at 1024^2, 2048^2 and
    1100 x 900, which take the band mode, every band plan of
    `band_candidates`; on the grids that fit one cluster, those of the
    smallest shared-memory budget that gives any (several bands, and two
    passes at 45 sweeps). At 512^2 only clusters of 16 CTAs fit."""
    p, div = _pressure_inputs(cuda, *shape)
    count = _card_jacobi_count()
    plans = list(jacobi_ops.plan_candidates(*shape, count))
    if shape[1] <= 512:
        assert len({pl.cluster for pl in plans}) > 1 or shape[1] == 512
        assert {pl.strip > 0 for pl in plans} == {shape[2] % 4 == 0}
    else:
        assert not plans
    for iters in (0, 1, 20, 45):
        bands = (_forced_bands(*shape, iters) if plans else
                 list(jacobi_ops.band_candidates(*shape, iters, count)))
        assert bands or shape[1] < 64
        want = jacobi_ops.jacobi_pressure_reference(p, div, iters)
        for plan in plans + bands:
            got = jacobi_ops._launch(p, div, iters, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (iters, plan.describe())


@pytest.mark.parametrize("shape,iters,mode,cluster,clusters", [
    ((1, 256, 256), 20, "cluster", 16, 1), ((8, 256, 256), 20, "cluster", None, 8),
    ((1, 512, 512), 20, "cluster", 16, 1), ((1, 1024, 1024), 20, "band", 16, None),
    ((1, 2048, 2048), 20, "band", 16, None), ((2, 1100, 900), 45, "band", None, None)],
    ids=["256", "8x256", "512", "1024", "2048", "1100x900x45"])
def test_jacobi_kernel_plan_on_the_card(cuda, shape, iters, mode, cluster, clusters):
    """The plan a call takes with the card's occupancy: one cluster of 16
    CTAs for the served 256^2 episode and for the 512^2 plume grid; the
    8-episode chunk in one wave of 8 clusters; 1024^2, 2048^2 and 1100 x
    900 in bands, as their stripes do not fit one cluster's shared memory
    (1024^2 and 2048^2 in clusters of 16 CTAs; 45 sweeps in two passes).
    Each bit-equal, one launch a pass."""
    plan = jacobi_ops.launch_plan(*shape, device=cuda, num_iters=iters)
    assert plan == jacobi_ops.plan_launch(*shape, _card_jacobi_count(), iters)
    assert plan.mode == mode
    if cluster is not None:
        assert plan.cluster == cluster
    if clusters is not None:
        assert plan.clusters == clusters
    p, div = _pressure_inputs(cuda, *shape)
    launches = jacobi_ops.LAUNCHES
    out = jacobi_ops.jacobi_pressure(p, div, iters)
    assert jacobi_ops.LAUNCHES == launches + (2 if iters == 45 else 1)
    assert torch.equal(out, jacobi_ops.jacobi_pressure_reference(p, div, iters))


@pytest.mark.parametrize("field", ["u", "v", "density"])
def test_diffuse_kernel_matches_plain(cuda, field):
    """The diffusion kernel on each staggered field of a 256^2 grid, two
    episodes: bit-equal to its plain version, one launch, input kept."""
    shape = {"u": (257, 256), "v": (256, 257), "density": (256, 256)}[field]
    f = torch.randn(2, *shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    before = f.clone()
    coef = 1e-5 if field != "density" else 1e-6
    launches = stencil_ops.LAUNCHES
    out = stencil_ops.diffuse(f, coef)
    assert stencil_ops.LAUNCHES == launches + 1
    assert torch.equal(out, stencil_ops.diffuse_reference(f, coef))
    assert torch.equal(f, before)


@pytest.mark.parametrize("episodes", [1, 2, 8])
def test_diffuse_fields_kernel_matches_plain(cuda, episodes):
    """The step's three staggered 256^2 fields in one launch: each bit-equal
    to its plain version and to the one-field entry, inputs kept."""
    g = torch.Generator().manual_seed(7)
    fields = [torch.randn(episodes, *shape, generator=g).to(cuda)
              for shape in ((257, 256), (256, 257), (256, 256))]
    before = [f.clone() for f in fields]
    launches = stencil_ops.LAUNCHES
    outs = stencil_ops.diffuse_fields(*fields, 1e-5, 1e-6)
    assert stencil_ops.LAUNCHES == launches + 1
    for f, out, coef in zip(fields, outs, (1e-5, 1e-5, 1e-6)):
        assert torch.equal(out, stencil_ops.diffuse_reference(f, coef))
        assert torch.equal(out, stencil_ops.diffuse(f, coef))
    for f, b in zip(fields, before):
        assert torch.equal(f, b)


def test_stencil_kernels_refuse_bad_inputs(cuda):
    p, div = _pressure_inputs(cuda, 1, 16, 16)
    with pytest.raises(TypeError, match="float32"):
        jacobi_ops.jacobi_pressure(p.double(), div, 20)
    with pytest.raises(ValueError, match="one device"):
        jacobi_ops.jacobi_pressure(p, div.cpu(), 20)
    with pytest.raises(ValueError, match="contiguous"):
        jacobi_ops.jacobi_pressure(p.transpose(-1, -2), div, 20)
    with pytest.raises(TypeError, match="float32"):
        stencil_ops.diffuse(p.half(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        stencil_ops.diffuse(p.transpose(-1, -2), 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        stencil_ops.diffuse(torch.empty(4, 4, device="meta"), 0.1)
    with pytest.raises(ValueError, match="one device"):
        stencil_ops.diffuse_fields(p, p.cpu(), p, 0.1, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        stencil_ops.diffuse_fields(p, p.transpose(-1, -2), p, 0.1, 0.1)


def _qkv(dev, dtype, batch=2, length=256, width=256, seed=3):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(batch, length, width, generator=g).to(dev, dtype) for _ in range(4)]


@pytest.mark.parametrize("shape", [(2, 256, 64)] + FWD_SHAPES, ids=_fwd_id)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_fwd_lse_kernel_matches_plain(cuda, dtype, shape):
    """The forward-with-logsumexp kernel: out as the lean kernel is held
    (float32 atol 1e-5; bf16 two ulps of the largest output and ||d||/||ref||
    <= 2^-8); lse atol 1e-4 (float32 scores on both sides); the lean
    instantiation's output is the same bits (the same code with the lse
    store compiled out), and so is a second call's."""
    batch, length, head_dim = shape
    heads = 256 // head_dim
    q, k, v, _ = _qkv(cuda, dtype, batch=batch, length=length, seed=3 + head_dim)
    before = attn_ops.LSE_LAUNCHES
    out, lse = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads, temperature=0.8)
    assert attn_ops.LSE_LAUNCHES == before + 1
    rout, rlse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads, 0.8)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    lean = attn_ops.flash_attention_tokens(q, k, v, heads, temperature=0.8)
    assert torch.equal(out, lean)
    again, lse_again = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads, temperature=0.8)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    out, rout = out.float(), rout.float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, rout, atol=1e-5, rtol=0)
        return
    torch.testing.assert_close(out, rout, atol=2 * _bf16_ulp(float(rout.abs().max())), rtol=0)
    assert float(torch.linalg.vector_norm(out - rout) / torch.linalg.vector_norm(rout)) <= 2.0 ** -8


# the backward's shapes: the first test's own ([2,256,256], 4 heads of 64),
# then every head dim at L = 64, 192 (the bf16 kernels' last 128-row tile
# half past L) and 1024 with B = 3, width 256
BWD_SHAPES = [(2, 256, 64)] + FWD_SHAPES


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=_fwd_id)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, shape):
    """The backward kernel against its plain version on the same forward
    output and lse: float32 ||d||/||ref|| <= 1e-5 for each of dq, dk, dv;
    bf16 <= 2^-10 (both sides round P against the same lse and dS once,
    and sum the products in another order, the kernel's dq by atomics:
    ~1e-4 on the card; one wrong (query, head) row of dq gives ~2^-5.5
    at [2,256,256])."""
    batch, length, head_dim = shape
    heads = 256 // head_dim
    q, k, v, dout = _qkv(cuda, dtype, batch=batch, length=length, seed=4 + head_dim)
    out, lse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads, 0.8)
    before = attn_ops.BWD_LAUNCHES
    grads = attn_ops.flash_attention_tokens_bwd(q, k, v, out, lse, dout, heads, 0.8)
    assert attn_ops.BWD_LAUNCHES == before + 1
    refs = attn_ops.flash_attention_tokens_bwd_reference(q, k, v, out, lse, dout, heads,
                                                         0.8)
    bound = 1e-5 if dtype == torch.float32 else 2.0 ** -10
    for name, a, b in zip("qkv", grads, refs):
        assert a.dtype == dtype and a.shape == b.shape, name
        rel = torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b.float())
        assert float(rel) <= bound, (name, float(rel))


# the float32 kernels at the model paths' shapes: the 3D trunk at B = 1
# ([1,512,256], 8 heads of 32) and the float32 2D train step and PGD report
# ([8,1024,512], 8 heads of 64)
F32_MODEL_SHAPES = [(1, 512, 256, 8), (8, 1024, 512, 8)]


@pytest.mark.parametrize("batch,length,width,heads", F32_MODEL_SHAPES,
                         ids=["B1-L512-hd32", "B8-L1024-hd64"])
def test_flash_f32_kernels_at_model_shapes(cuda, batch, length, width, heads):
    """The float32 lean and LSE forwards and the fused backward (split TF32
    on the tensor cores) at the shapes the model paths launch, with the
    float32 bounds: out atol 1e-5, lse atol 1e-4, ||d||/||ref|| <= 1e-5 for
    each of dq, dk, dv. The lean output is the LSE forward's to the bit, and
    a second call of each forward gives the same bits."""
    g = torch.Generator().manual_seed(300 + length)
    q, k, v, go = (torch.randn(batch, length, width, generator=g).to(cuda)
                   for _ in range(4))
    lean = attn_ops.flash_attention_tokens(q, k, v, heads)
    out, lse = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)
    assert torch.equal(lean, out)
    assert torch.equal(lean, attn_ops.flash_attention_tokens(q, k, v, heads))
    out2, lse2 = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    rout, rlse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads)
    torch.testing.assert_close(out, rout, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    grads = attn_ops.flash_attention_tokens_bwd(q, k, v, rout, rlse, go, heads)
    refs = attn_ops.flash_attention_tokens_bwd_reference(q, k, v, rout, rlse, go, heads)
    for name, a, b in zip("qkv", grads, refs):
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))


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


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("shape,iters", [((1, 32, 32, 32), 30), ((3, 16, 16, 16), 30),
                                         ((1, 37, 53, 29), 30), ((2, 8, 9, 10), 0),
                                         ((2, 8, 9, 10), 1), ((1, 1, 1, 1), 5),
                                         ((1, 40, 40, 70), 30), ((2, 64, 64, 64), 30),
                                         ((1, 128, 128, 128), 30), ((2, 128, 128, 128), 30),
                                         ((1, 160, 160, 160), 30)],
                         ids=["32cubed", "batch3", "odd", "iters0", "iters1", "one_cell",
                              "cut_zyx", "2x64cubed", "128cubed", "2x128cubed", "160cubed"])
def test_cg_kernel_matches_plain(cuda, shape, iters):
    """The CG kernel against its plain version from a warm p0:
    ||d|| / ||ref|| <= 1e-5 (float32 sums in another order); two runs
    bit-equal; each episode of a batch bit-equal to its solve alone (at
    2 x 128^3 the batch takes two waves); one count per solve; the inputs
    unchanged. 160^3 takes the global mode."""
    g = torch.Generator().manual_seed(sum(shape) + iters)
    div = torch.randn(*shape, generator=g).to(cuda)
    p0 = (0.1 * torch.randn(*shape, generator=g)).to(cuda)
    before = (p0.clone(), div.clone())
    n = cg_ops.LAUNCHES
    out = cg_ops.cg_pressure(p0, div, iters)
    assert cg_ops.LAUNCHES == n + 1
    ref = cg_ops.cg_pressure_reference(p0, div, iters)
    again = cg_ops.cg_pressure(p0, div, iters)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-5 or float((out - ref).abs().max()) == 0.0
    assert torch.equal(out, again)
    for e in range(shape[0]):
        solo = cg_ops.cg_pressure(p0[e:e + 1].contiguous(), div[e:e + 1].contiguous(), iters)
        assert torch.equal(out[e:e + 1], solo)
    assert torch.equal(p0, before[0]) and torch.equal(div, before[1])


def _card_plan(shape, mode=None):
    return cg_ops.plan_launch(*shape, *cg_ops.card_occupancy(torch.cuda.current_device()),
                              mode=mode)


@pytest.mark.parametrize("shape,mode,waves,cuts", [
    ((1, 128, 128, 128), "chip", 1, (16, 8, 1)), ((2, 128, 128, 128), "chip", 2, (16, 8, 1)),
    ((1, 40, 40, 70), "chip", 1, None), ((1, 160, 160, 160), "global", 1, None)],
    ids=["128cubed", "2x128cubed", "cut_zyx", "160cubed"])
def test_cg_kernel_plan_on_the_card(cuda, shape, mode, waves, cuts):
    """The plan a call takes with the card's occupancy: the 128^3 episode
    on chip, one brick of 8 planes x 16 rows x 128 columns per CTA (128
    CTAs of 1024 threads, the volume cut 16 x 8 x 1); two of them do not
    fit at once and take two waves; the 40 x 40 x 70 volume is cut along
    z, y and x; a 160^3 episode does not fit the card's shared memory and
    takes the global mode."""
    plan = cg_ops.launch_plan(*shape, device=cuda)
    assert plan == _card_plan(shape)
    assert (plan.mode, plan.waves) == (mode, waves)
    if mode == "chip":
        got = cg_ops.bricks(cg_ops.Granules(*shape[1:]), plan.brick)
        assert got == cuts if cuts else all(n > 1 for n in got)


@pytest.mark.parametrize("shape", [(1, 40, 40, 70), (1, 128, 128, 128)],
                         ids=["cut_zyx", "128cubed"])
def test_cg_kernel_every_plan_bit_equal(cuda, shape):
    """Every on-chip plan the card holds (each brick cut; at 40 x 40 x 70
    some cut z, y and x, so halos cross CTAs in every direction) and the
    global mode forced through plan_launch's argument give the bits of
    the default plan, 30 iterations from a warm p0; one launch each."""
    g = torch.Generator().manual_seed(11)
    div = torch.randn(*shape, generator=g).to(cuda)
    p0 = (0.1 * torch.randn(*shape, generator=g)).to(cuda)
    want = cg_ops.cg_pressure(p0, div, 30)
    gr = cg_ops.Granules(*shape[1:])
    card = cg_ops.card_occupancy(torch.cuda.current_device())
    plans = list(cg_ops.plan_candidates(*shape, *card))
    assert any(all(n > 1 for n in cg_ops.bricks(gr, pl.brick)) for pl in plans)
    plans.append(_card_plan(shape, mode="global"))
    assert plans[-1].mode == "global"
    for plan in plans:
        got = cg_ops._launch(p0, div, 30, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan.describe()


@pytest.mark.parametrize("shape", [(3, 32, 32, 32), (3, 37, 53, 29), (2, 64, 64, 64)],
                         ids=["batch3", "odd_batch3", "2x64cubed"])
def test_cg_kernel_forced_global_batches_bit_equal(cuda, shape):
    """A batch in the global mode, forced through plan_launch's argument,
    gives the bits of its on-chip plan: every CTA takes the episodes one
    at a time, each episode's barrier on its own flags; 30 iterations from
    a warm p0, twice."""
    g = torch.Generator().manual_seed(13)
    div = torch.randn(*shape, generator=g).to(cuda)
    p0 = (0.1 * torch.randn(*shape, generator=g)).to(cuda)
    want = cg_ops.cg_pressure(p0, div, 30)
    assert cg_ops.launch_plan(*shape, device=cuda).mode == "chip"
    plan = _card_plan(shape, mode="global")
    assert plan.mode == "global" and plan.ctas > 1
    for _ in range(2):
        got = cg_ops._launch(p0, div, 30, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan.describe()


def test_cg_kernel_guards_and_refusals(cuda):
    """Zero divergence from p0 = 0 stays exactly 0 (both guards), and the
    wrapper refuses what the kernel does not take, capture into a CUDA
    graph included (its barrier tags are launch arguments)."""
    z = torch.zeros(2, 8, 8, 8, device=cuda)
    assert torch.equal(cg_ops.cg_pressure(z, z, 30), z)
    with pytest.raises(TypeError, match="float32"):
        cg_ops.cg_pressure(z.double(), z.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        cg_ops.cg_pressure(z.transpose(-1, -2), z, 3)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            y = z + 1.0  # the graph is not empty
            cg_ops.cg_pressure(y, z, 3)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_step3d_kernel_matches_plain(cuda, use_pallas):
    """A 32^3 step with the CG kernel against the plain step: fields within
    atol 1e-5 (p within 1e-5 of its largest |p|); one kernel solve per
    step under use_pallas, none without."""
    g = torch.Generator().manual_seed(5)
    s = solver3d.init_state3d((32, 32, 32), device=cuda, batch=(2,))
    d = solver3d.add_smoke_source3d(s.density, 12.0, 16.0, 10.0, radius=8.0)
    s = s.replace(density=d, u=(0.3 * torch.randn(s.u.shape, generator=g)).to(cuda))
    n = cg_ops.LAUNCHES
    out = solver3d.step3d(s, use_pallas=use_pallas)
    assert cg_ops.LAUNCHES == n + int(use_pallas)
    ref = solver3d.step3d(s, use_pallas=False)
    for name in ("u", "v", "w", "density"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name), atol=1e-5,
                                   rtol=1e-5, msg=name)
    torch.testing.assert_close(out.p, ref.p, rtol=0, atol=1e-5 * float(ref.p.abs().max()))


@pytest.mark.parametrize("head_dim", [16, 32, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_kernels_other_head_dims(cuda, monkeypatch, dtype, head_dim):
    """The lean forward, the forward with logsumexp and the backward at head
    dims 16, 32 and 128 against their plain versions, with the head_dim-64
    tests' bounds: forwards float32 atol 1e-5 (bf16 two ulps and
    ||d||/||ref|| 2^-8), lse 1e-4, backward ||d||/||ref|| 1e-5 (bf16
    2^-10), on the fused route and on the split route (the dq kernel's
    dq also bit-equal on a second call)."""
    heads = 256 // head_dim
    g = torch.Generator().manual_seed(head_dim)
    q, k, v, go = (torch.randn(2, 512, 256, generator=g).to(cuda, dtype) for _ in range(4))
    for out, ref in ((attn_ops.flash_attention_tokens(q, k, v, heads),
                      attn_ops.flash_attention_tokens_reference(q, k, v, heads)),
                     (attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)[0],
                      attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads)[0])):
        out, ref = out.float(), ref.float()
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        else:
            torch.testing.assert_close(out, ref, atol=2 * _bf16_ulp(float(ref.abs().max())),
                                       rtol=0)
            assert _rel(out, ref) <= 2.0 ** -8
    _, lse = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)
    o, rlse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    kg = attn_ops.flash_attention_tokens_bwd(q, k, v, o, rlse, go, heads)
    pg = attn_ops.flash_attention_tokens_bwd_reference(q, k, v, o, rlse, go, heads)
    bound = 1e-5 if dtype == torch.float32 else 2.0 ** -10
    for a, b in zip(kg, pg):
        assert _rel(a.float(), b.float()) <= bound
    monkeypatch.setenv("SMOKEPHYS_FUSED_BWD", "0")
    sg = attn_ops.flash_attention_tokens_bwd(q, k, v, o, rlse, go, heads)
    for name, a, b in zip("qkv", sg, pg):
        assert _rel(a.float(), b.float()) <= bound, (name, _rel(a.float(), b.float()))
    assert torch.equal(sg[0], attn_ops.flash_attention_tokens_bwd(q, k, v, o, rlse, go,
                                                                  heads)[0])


@pytest.mark.parametrize("shape", [(2, 512, hd) for hd in (16, 32, 64, 128)] + FWD_SHAPES,
                         ids=_fwd_id)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_split_bwd_kernels_match_plain(cuda, monkeypatch, dtype, shape):
    """The split dq and dk/dv kernels (`flash_attention_tokens_bwd` under
    SMOKEPHYS_FUSED_BWD=0) against their plain versions on the same
    forward output and lse, with the fused kernel's bounds:
    ||d||/||ref|| <= 1e-5 in float32 and 2^-10 in bf16 for each of dq, dk,
    dv, at head dims 16, 32, 64 and 128 and L = 64, 192, 512 and 1024 (the
    float32 dq kernel's key tiles: 64 keys, 32 at head_dim 128). Neither
    kernel uses atomics, so two runs are bit-equal and each episode of the
    batch is bit-equal to its call alone; one launch of each per call."""
    monkeypatch.setenv("SMOKEPHYS_FUSED_BWD", "0")
    batch, length, head_dim = shape
    heads = 256 // head_dim
    g = torch.Generator().manual_seed(100 + head_dim + length)
    q, k, v, go = (torch.randn(batch, length, 256, generator=g).to(cuda, dtype)
                   for _ in range(4))
    o, lse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads, 0.8)
    args = (q, k, v, o, lse, go, heads, 0.8)
    n = (attn_ops.BWD_DQ_LAUNCHES, attn_ops.BWD_DKV_LAUNCHES, attn_ops.BWD_LAUNCHES)
    dq, dk, dv = attn_ops.flash_attention_tokens_bwd(*args)
    assert (attn_ops.BWD_DQ_LAUNCHES, attn_ops.BWD_DKV_LAUNCHES,
            attn_ops.BWD_LAUNCHES) == (n[0] + 1, n[1] + 1, n[2])
    refs = (attn_ops.flash_attention_tokens_bwd_dq_reference(*args),
            *attn_ops.flash_attention_tokens_bwd_dkv_reference(*args))
    bound = 1e-5 if dtype == torch.float32 else 2.0 ** -10
    for name, a, b in zip("qkv", (dq, dk, dv), refs):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _rel(a.float(), b.float()) <= bound, (name, _rel(a.float(), b.float()))
    for a, b in zip((dq, dk, dv), attn_ops.flash_attention_tokens_bwd(*args)):
        assert torch.equal(a, b)
    for e in range(batch):
        solo = [t[e:e + 1].contiguous() for t in (q, k, v, o, lse, go)]
        for a, b in zip((dq, dk, dv),
                        attn_ops.flash_attention_tokens_bwd(*solo, heads, 0.8)):
            assert torch.equal(a[e:e + 1], b)


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=_fwd_id)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_split_dkv_equals_fused(cuda, monkeypatch, dtype, shape):
    """The split route's dk and dv are the fused route's bits: the dk/dv
    kernel is the fused kernel's code with its dQ step compiled out, and
    dk and dv are summed in the same order in both."""
    batch, length, head_dim = shape
    heads = 256 // head_dim
    q, k, v, go = _qkv(cuda, dtype, batch=batch, length=length, seed=200 + head_dim)
    o, lse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads, 0.8)
    args = (q, k, v, o, lse, go, heads, 0.8)
    monkeypatch.delenv("SMOKEPHYS_FUSED_BWD", raising=False)
    _, fdk, fdv = attn_ops.flash_attention_tokens_bwd(*args)
    monkeypatch.setenv("SMOKEPHYS_FUSED_BWD", "0")
    _, sdk, sdv = attn_ops.flash_attention_tokens_bwd(*args)
    assert torch.equal(fdk, sdk) and torch.equal(fdv, sdv)


def test_flash_split_route_launches(cuda, monkeypatch):
    """SMOKEPHYS_FUSED_BWD selects the backward on every call: unset, one
    fused launch; "0", one dq and one dk/dv launch and no fused one, with
    the split plain versions' bounds; the same through the autograd
    Function (one forward-with-lse launch each way), with the route's
    gradients exactly."""
    q, k, v, go = _qkv(cuda, torch.bfloat16, seed=6)
    o, lse = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, 4)
    args = (q, k, v, o, lse, go, 4)

    def counts():
        return (attn_ops.LSE_LAUNCHES, attn_ops.BWD_LAUNCHES, attn_ops.BWD_DQ_LAUNCHES,
                attn_ops.BWD_DKV_LAUNCHES)

    for env, added in ((None, (0, 1, 0, 0)), ("0", (0, 0, 1, 1))):
        if env is None:
            monkeypatch.delenv("SMOKEPHYS_FUSED_BWD", raising=False)
        else:
            monkeypatch.setenv("SMOKEPHYS_FUSED_BWD", env)
        before = counts()
        grads = attn_ops.flash_attention_tokens_bwd(*args)
        assert tuple(b - a for a, b in zip(before, counts())) == added
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        before = counts()
        attn_ops.flash_attention_tokens_trainable(*ts, 4).backward(go)
        assert tuple(b - a for a, b in zip(before, counts())) == (1, *added[1:])
    refs = (attn_ops.flash_attention_tokens_bwd_dq_reference(*args),
            *attn_ops.flash_attention_tokens_bwd_dkv_reference(*args))
    for a, b in zip(grads, refs):
        assert _rel(a.float(), b.float()) <= 2.0 ** -10
    for t, want in zip(ts, grads):
        assert torch.equal(t.grad, want)


@pytest.mark.parametrize("shape,temperature", [((8, 8, 1024, 64), 1.0),
                                               ((2, 4, 256, 64), 1.0),
                                               ((1, 2, 128, 32), 1.5)],
                         ids=["model", "jax_test", "temperature"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_attention_head_major_matches_plain(cuda, dtype, shape, temperature):
    """The head-major forward (the lean kernel on [B*H, L, D] with one head)
    against its plain version, with the lean kernel's bounds: float32 atol
    1e-5; bf16 two ulps of the largest output and ||d||/||ref|| <= 2^-8;
    one launch, counted as head-major only."""
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(*shape, generator=g).to(cuda, dtype) for _ in range(3))
    n, lean = attn_ops.HM_LAUNCHES, attn_ops.LAUNCHES
    out = attn_ops.flash_attention(q, k, v, temperature=temperature)
    assert (attn_ops.HM_LAUNCHES, attn_ops.LAUNCHES) == (n + 1, lean)
    ref = attn_ops.flash_attention_reference(q, k, v, temperature).float()
    assert out.dtype == dtype and out.shape == shape
    out = out.float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(out, ref, atol=2 * _bf16_ulp(float(ref.abs().max())),
                                   rtol=0)
        assert _rel(out, ref) <= 2.0 ** -8


def test_flash_attention_head_major_refusals(cuda):
    q = torch.randn(1, 2, 128, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        attn_ops.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="divide"):
        attn_ops.flash_attention(q, q, q, block_q=96)
    with pytest.raises(ValueError, match="head_dim"):
        attn_ops.flash_attention(q[..., :48], q[..., :48], q[..., :48])
    short = q[:, :, :100].contiguous()
    with pytest.raises(ValueError, match="multiple"):
        attn_ops.flash_attention(short, short, short)
    with pytest.raises(TypeError, match="not supported"):
        attn_ops.flash_attention(q.half(), q.half(), q.half())
    t = torch.randn(1, 2, 128, 128, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        attn_ops.flash_attention(t, t, t)
    with pytest.raises(RuntimeError, match="gradient"):
        qg = q.clone().requires_grad_()
        attn_ops.flash_attention(qg, q, q)


def test_gate_batches_on_the_card_match_the_cpu_path(cuda):
    """The 128^2 gate's path (config/config.yaml, the committed JAX draws,
    smokephysnet_128_best.npz) on the card against the port's CPU path on the
    same draws, batch by batch for the first three batches: the held-out
    frames (the multi-step kernel against its plain version, 1e-5 as in
    chip_smoke) and the float32 forward on them (outputs in [0, 1] and the
    physics head, 1e-4; TF32 off on both)."""
    import os

    from smokephysai_tpu_torch import benchmark as bench
    from smokephysai_tpu_torch.train.serving import load_model, make_predictor
    from smokephysai_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = load_config(os.path.join(root, "config", "config.yaml"))
    samples = bench.read_samples(
        os.path.join(root, "tests", "goldens", "gate_draws_128x128_n50_s0.npz"), config, 50)
    torch.backends.cudnn.allow_tf32 = False
    sides = {}
    for dev in (cuda, torch.device("cpu")):
        model = load_model(config, os.path.join(root, "checkpoints",
                                                "smokephysnet_128_best.npz"), dev)
        predict = make_predictor(model, chaos_traj=samples["chaos_traj"])
        batches = bench.held_out_batches(config, 50, samples, dev)()
        sides[dev.type] = [(b, predict(b["input"])) for b, _ in zip(batches, range(3))]
    for (gb, gout), (cb, cout) in zip(sides["cuda"], sides["cpu"]):
        for key in ("input", "target"):
            torch.testing.assert_close(gb[key].cpu(), cb[key], atol=1e-5, rtol=0)
        for key in ("reconstructed", "physics_features"):
            torch.testing.assert_close(gout[key].cpu(), cout[key], atol=1e-4, rtol=0)


def test_plume_512_chunk_matches_plain(cuda):
    """config_512_plume.yaml's physics (vorticity_eps 2.0, per-op steps): 2
    episodes of the config's T = 20 steps (the chaos label needs more than
    10) through `simulate_episode` with the Jacobi (cluster mode, strips of
    4 rows) and diffusion kernels against the plain per-op loop, bit-equal;
    one launch of each a step."""
    import os

    from smokephysai_tpu_torch.data.synthetic import sample_source_params
    from smokephysai_tpu_torch.physics.simulator import simulate_episode
    from smokephysai_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = load_config(os.path.join(root, "config", "config_512_plume.yaml"))
    sim, steps = config["simulation"], config["data"]["sequence_length"]
    grid = tuple(sim["grid_size"])
    assert jacobi_ops.launch_plan(2, *grid, device=cuda).strip == 4
    src = {k: v.to(cuda) for k, v in
           sample_source_params(torch.Generator().manual_seed(5), 2, grid).items()}
    args = (src["xy"], src["intensity"], src["active"], grid, steps, sim["dt"],
            sim["viscosity"], sim["num_jacobi_iters"], config["tpu"]["vorticity_eps"])
    j, d = jacobi_ops.LAUNCHES, stencil_ops.LAUNCHES
    seqs, labels = simulate_episode(*args, True)
    assert (jacobi_ops.LAUNCHES - j, stencil_ops.LAUNCHES - d) == (steps, steps)
    assert torch.isfinite(seqs).all() and torch.isfinite(labels).all()
    ref_seqs, ref_labels = simulate_episode(*args, False)
    torch.testing.assert_close(seqs, ref_seqs, rtol=0, atol=0)
    torch.testing.assert_close(labels, ref_labels, rtol=0, atol=0)


def test_mg_on_the_card_matches_the_cpu(cuda):
    """`mg_pressure` (2 V-cycles) on a batch of 2 at 64^3 and on 37x53x29
    (no coarsening) on the card against the CPU: within 1e-5 of the
    largest |p| (the same float32 operations; the block means' sums may be
    taken in another order); `step3d(pressure_solver="mg")` launches no
    kernel."""
    from smokephysai_tpu_torch.physics import multigrid3d

    g = torch.Generator().manual_seed(8)
    for shape in ((2, 64, 64, 64), (1, 37, 53, 29)):
        div = torch.randn(shape, generator=g)
        p0 = 0.1 * torch.randn(shape, generator=g)
        ref = multigrid3d.mg_pressure(p0, div, 2)
        got = multigrid3d.mg_pressure(p0.to(cuda), div.to(cuda), 2).cpu()
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    s = solver3d.init_state3d((32, 32, 32), device=cuda, batch=(1,))
    s = s.replace(density=solver3d.add_smoke_source3d(s.density, 12.0, 16.0, 10.0))
    n = cg_ops.LAUNCHES
    out = solver3d.step3d(s, pressure_solver="mg", use_pallas=True)
    assert cg_ops.LAUNCHES == n and torch.isfinite(out.p).all()


def test_reference_bridge_forward_on_the_card(cuda):
    """The reference state_dict drawn from the golden's recorded keys and
    seed, bridged by `models/torch_port` into the port's SmokePhysNet on the
    card (float32 einsum, TF32 off), against the reference's recorded
    forward: atol 1e-4 on the outputs, 1e-3 on the token features, as
    tests/test_torch_port.py holds the JAX model on the CPU."""
    import json
    import os

    import numpy as np

    from smokephysai_tpu_torch.models import torch_port
    from smokephysai_tpu_torch.models.net import SmokePhysNet

    torch.backends.cudnn.allow_tf32 = False
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                        "model_forward_128.npz")
    with np.load(path) as f:
        gold = {k: f[k] for k in f.files}
    ks = {k: tuple(v) for k, v in json.loads(bytes(gold["keys_shapes"]).decode()).items()}
    model = SmokePhysNet().to(cuda).eval()
    model.load_state_dict(torch_port.convert_torch_state_dict(
        torch_port.synth_torch_state(ks, seed=int(gold["seed"]))), strict=True)
    x = torch.from_numpy(gold["input"]).permute(0, 2, 3, 1).contiguous().to(cuda)
    with torch.no_grad():
        out = model(x, chaos_fields=[torch.from_numpy(f).to(cuda) for f in gold["chaos_fields"]],
                    return_features=True)
    np.testing.assert_allclose(out["reconstructed"].permute(0, 3, 1, 2).cpu().numpy(),
                               gold["reconstructed"], atol=1e-4, rtol=0)
    for key in ("physics_features", "latent_features"):
        np.testing.assert_allclose(out[key].cpu().numpy(), gold[key], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["intermediate_features"].cpu().numpy(),
                               gold["intermediate_features"], atol=1e-3, rtol=0)
