"""The Jacobi kernel's launch plan (ops/jacobi.py, plan_launch), the band
mode's decomposition, and the one-launch diffusion of a step's three fields
(ops/stencil.py, diffuse_fields), on the CPU.

The plan is pure Python: the card's count of the clusters that fit at once
is passed in as a function of the shape (here a fixed number, or a
card-free estimate). The band mode's decomposition is held to the plain
sweep to the bit through `jacobi_pressure_bands`, a plain model of the
kernel's bands. `diffuse_fields` on CPU tensors takes the plain
version three times; it is held to `diffuse_reference` to the bit and to
the JAX package's `diffuse_pallas` (interpret mode, as the JAX tests run
it) within tests/test_torch_vorticity.py's tolerance for it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
from smokephysai_tpu.ops.pallas.stencil import diffuse_pallas
from smokephysai_tpu_torch.ops import jacobi as jacobi_ops
from smokephysai_tpu_torch.ops import stencil as stencil_ops

SMS = 132  # an H100 SXM
SM_SHARED = 233_472  # shared memory of one of its SMs
TOL = dict(atol=2e-5, rtol=1e-4)

GRIDS = [(2, 2), (3, 70), (37, 53), (64, 64), (256, 256), (512, 512), (1024, 1024),
         (2048, 2048)]


def fixed(n):
    """`max_active_clusters` of a card that fits n clusters of any shape."""
    return lambda *_: n


def estimated(sm_count):
    """A card-free estimate of how many clusters fit at once: CTAs per SM
    by threads (2048), registers (64 a thread under the kernel's launch
    bound) and shared memory (1 KB reserved per CTA); no GPC packing."""
    def count(cluster, bx, by, smem_bytes, vec):
        threads = bx * by
        per_sm = min(2048 // threads, 65536 // (64 * threads), 32,
                     SM_SHARED // (smem_bytes + 1024))
        return sm_count * per_sm // cluster
    return count


def _round4(n):
    return -(-n // 4) * 4


def _fits(h, w):
    """Some cluster of at most 16 CTAs cuts the grid into stripes whose
    planes fit one CTA's shared memory (two planes of p with a halo row
    above and below and the rows of div, 4 bytes a cell, the mbarriers)
    and, where w is a multiple of 4, whose rows a CTA of threads of a quad
    column and at most 4 rows each covers."""
    for cluster in range(1, 17):
        rows = -(-h // cluster)
        threads = -(-w // 128) * 32 * -(-rows // 4) if w % 4 == 0 else 32
        floats = 2 * _round4((rows + 2) * w) + _round4(rows * w)
        if threads <= 1024 and 16 + 4 * floats <= 232_448:
            return True
    return False


def _check_shape(plan, w, span, active, items):
    """What both modes share: the CTA's shared memory and threads, and
    stripes of `rows` rows that cover the `span` rows a cluster sweeps,
    one per CTA, none empty; never more clusters than fit, nor than items."""
    assert plan.smem_bytes == jacobi_ops.stripe_bytes(plan.rows, w) <= 232_448
    assert 1 <= plan.cluster <= 16
    assert plan.bx % 32 == 0 and plan.threads <= 1024 and 1 <= plan.by <= plan.rows
    if w % 4 == 0:  # register strips: a quad column a thread, covering the stripe
        assert plan.strip in (1, 2, 4) and 4 * plan.bx >= w > 4 * (plan.bx - 32)
        assert plan.by * plan.strip >= plan.rows > (plan.by - 1) * plan.strip
    else:
        assert plan.strip == 0
    stripes = [(r, min(plan.rows, span - r)) for r in range(0, span, plan.rows)]
    assert len(stripes) == plan.cluster
    assert [r for first, n in stripes for r in range(first, first + n)] == list(range(span))
    assert 1 <= plan.clusters <= min(items, active)


def _check_plan(plan, episodes, h, w, active):
    assert plan.mode == "cluster"
    _check_shape(plan, w, h, active, episodes)
    assert plan.launches(20) == 1 and plan.launches(0) == 1


def _check_band_plan(plan, episodes, h, w, active, num_iters):
    """A band plan: each row of the grid owned by exactly one band, each
    band's owned rows inside its span with at least a pass's sweeps of halo
    rows on each side cut by the span (a side at the grid's edge needs
    none), every span the cluster's stripes; the items in `waves` rounds."""
    assert plan.mode == "band"
    assert plan.span == plan.cluster * plan.rows < h
    _check_shape(plan, w, plan.span, active, episodes * plan.bands)
    sweeps = jacobi_ops.pass_depth(num_iters)
    assert plan.halo == sweeps and plan.band == plan.span - 2 * plan.halo >= 1
    bands = jacobi_ops.band_rows(plan, h)
    assert len(bands) == plan.bands
    assert [r for _, o0, o1 in bands for r in range(o0, o1)] == list(range(h))
    for s0, o0, o1 in bands:
        assert 0 <= s0 <= o0 < o1 <= s0 + plan.span <= h
        assert s0 == 0 or o0 - s0 >= sweeps
        assert s0 + plan.span == h or s0 + plan.span - o1 >= sweeps
    assert plan.waves == -(-episodes * plan.bands // plan.clusters)
    assert plan.swept == plan.bands * plan.span / h
    assert plan.launches(num_iters) == max(1, -(-num_iters // max(sweeps, 1)))


@pytest.mark.parametrize("episodes", [1, 8, 64])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_every_plan_covers_the_grid_within_the_card(grid, episodes):
    """Every plan `plan_candidates` weighs, with a fixed count and with the
    card-free estimate: stripes that cover each row once, at most 16 CTAs a
    cluster and 232,448 B a CTA, no more clusters than fit. The cluster
    mode is taken exactly where some cluster's stripes fit (256^2 and
    512^2 do, 1024^2 and 2048^2 do not); the band mode elsewhere, every
    band plan weighed covering each row once, the chosen one a wave within
    one CTA a SM where there is one and the fewest waves, one launch per
    pass of up to MAX_DEPTH sweeps."""
    h, w = grid
    for count in (fixed(1), fixed(40), estimated(SMS)):
        plans = list(jacobi_ops.plan_candidates(episodes, h, w, count))
        for plan in plans:
            _check_plan(plan, episodes, h, w,
                        count(plan.cluster, plan.bx, plan.by, plan.smem_bytes, plan.strip))
        chosen = jacobi_ops.plan_launch(episodes, h, w, count)
        assert bool(plans) == _fits(h, w) == (chosen.mode == "cluster")
        if plans:
            assert chosen in plans
            best = min(-(-episodes // pl.clusters) for pl in plans)
            assert -(-episodes // chosen.clusters) == best
        else:
            bands = list(jacobi_ops.band_candidates(episodes, h, w, 20, count))
            for plan in bands:
                _check_band_plan(plan, episodes, h, w, count(
                    plan.cluster, plan.bx, plan.by, plan.smem_bytes, plan.strip), 20)
            # a wave one CTA a SM where one is, then the fewest waves
            best = min((pl.ctas > SMS, pl.waves) for pl in bands)
            assert chosen in bands and (chosen.ctas > SMS, chosen.waves) == best
            assert [chosen.launches(k) for k in (0, 1, 20)] == [1, 1, 1]
    assert _fits(h, w) == (h <= 512)


def test_plan_at_the_main_path_shapes():
    """The served 256^2 episode: one cluster of 16 CTAs, 16 rows each, in
    register strips of 2 rows x 4 cells (512 threads: a quad column a
    thread, 8 thread rows); the 8-episode chunk in one wave of 8 such
    clusters (128 CTAs) by the estimate; the 512^2 plume grid at 16 CTAs of
    32 rows (~205 KB each), strips of 4 rows (1024 threads, the only shape
    that fits); a card that runs no cluster has no plan."""
    one = jacobi_ops.plan_launch(1, 256, 256, estimated(SMS))
    assert (one.mode, one.cluster, one.clusters, one.rows, one.strip, one.bx, one.by) == (
        "cluster", 16, 1, 16, 2, 64, 8)
    chunk = jacobi_ops.plan_launch(8, 256, 256, estimated(SMS))
    assert (chunk.cluster, chunk.clusters, chunk.ctas, chunk.strip) == (16, 8, 128, 2)
    plume = jacobi_ops.plan_launch(1, 512, 512, estimated(SMS))
    assert (plume.cluster, plume.rows, plume.smem_bytes, plume.strip, plume.threads) == (
        16, 32, 204_816, 4, 1024)
    with pytest.raises(ValueError, match="no cluster"):
        jacobi_ops.plan_launch(1, 256, 256, fixed(0))
    with pytest.raises(ValueError, match="2x2"):
        jacobi_ops.plan_launch(1, 1, 8, fixed(1))


@pytest.mark.parametrize("episodes,h,w,iters", [
    (1, 1024, 1024, 20), (8, 1024, 1024, 20), (1, 2048, 2048, 20), (2, 1100, 900, 45),
    (1, 1100, 901, 45), (1, 2048, 2048, 0)],
    ids=["1024", "8x1024", "2048", "1100x900x45", "1100x901x45", "2048x0"])
def test_band_plan_covers_each_row_once(episodes, h, w, iters):
    """The band plan of the grids past one cluster's shared memory (the
    streaming grid 1024^2, 2048^2 where the TPU kernel tiles, an odd
    1100 x 900 at 45 sweeps, and 901 columns: one cell a thread), with the
    card-free estimate of an H100: every owned row covered exactly once, a
    halo of at least the pass's sweeps, at most 232,448 B a CTA and 16
    CTAs a cluster. 1024^2 and 2048^2 take bands of 16 CTAs, all of an
    episode's bands at 1024^2 in one wave of 112 CTAs of 12 rows (8
    episodes: 5 waves of 16 rows), at 2048^2 in 3; 45 sweeps in two passes
    of 23 and 22."""
    count = estimated(SMS)
    plan = jacobi_ops.plan_launch(episodes, h, w, count, iters)
    _check_band_plan(plan, episodes, h, w,
                     count(plan.cluster, plan.bx, plan.by, plan.smem_bytes, plan.strip), iters)
    assert plan.launches(iters) == (2 if iters == 45 else 1)
    if (h, w, iters) == (1024, 1024, 20):
        assert (plan.cluster, plan.rows, plan.span, plan.band, plan.bands, plan.strip,
                plan.waves) == ((16, 12, 192, 152, 7, 4, 1) if episodes == 1 else
                                (16, 16, 256, 216, 5, 4, 5))
    if (h, w, iters) == (2048, 2048, 20):
        assert (plan.cluster, plan.rows, plan.span, plan.band, plan.bands, plan.waves) == (
            16, 8, 128, 88, 24, 3)
    assert "cells swept per owned cell" in plan.describe()


# a shared-memory budget that leaves a CTA 5 rows of 192 or 190 columns:
# spans of 80 rows, several bands and passes at 256 rows
SMALL_SMEM = 16_384


@pytest.mark.parametrize("w", [192, 190], ids=["strips", "cells"])
@pytest.mark.parametrize("iters", [25, 45])
def test_band_model_bit_equal(iters, w):
    """The band decomposition at 256 x w, two episodes, with a budget that
    forces bands (9 of 30 rows at 25 sweeps; 8 of 34 in two passes at 45):
    each band's span swept with the plain sweep alone, the rows just outside
    it held, only its owned rows kept, is the plain version's bits. A band
    plan whose halo is short of the pass's sweeps is not (the
    model sees a fault of the plan): bands that reach to two rows of the
    span's cut, where the stale rows arrive after two sweeps."""
    rng = np.random.default_rng(30 + iters)
    p = torch.from_numpy((0.1 * rng.standard_normal((2, 256, w))).astype(np.float32))
    div = torch.from_numpy(rng.standard_normal((2, 256, w)).astype(np.float32))
    plan = jacobi_ops.plan_launch(2, 256, w, fixed(3), iters, smem_max=SMALL_SMEM)
    assert plan.mode == "band" and plan.bands >= 8 and plan.waves > 1
    assert plan.launches(iters) == (2 if iters == 45 else 1)
    want = jacobi_ops.jacobi_pressure_reference(p, div, iters)
    torch.testing.assert_close(jacobi_ops.jacobi_pressure_bands(p, div, iters, plan), want,
                               rtol=0, atol=0)
    short = dataclasses.replace(plan, band=plan.band + plan.halo - 2)
    assert not torch.equal(jacobi_ops.jacobi_pressure_bands(p, div, iters, short), want)


@pytest.mark.parametrize("episodes", [1, 2])
def test_diffuse_fields_matches_pallas(episodes):
    """A step's three staggered fields at 32^2 with the step's coefficients
    (dt * viscosity, a tenth of it for the density): each field to the bit
    of `diffuse_reference`, and within TOL of `diffuse_pallas` (mapped over
    the episodes, one compile a field shape); the inputs are kept."""
    rng = np.random.default_rng(12 + episodes)
    shapes = {"u": (33, 32), "v": (32, 33), "density": (32, 32)}
    fields = {k: rng.random((episodes, *s), dtype=np.float32) for k, s in shapes.items()}
    coef_uv = np.float32(0.01) * np.float32(0.001)
    coef_d = np.float32(0.01) * (np.float32(0.001) * np.float32(0.1))
    tensors = [torch.from_numpy(a.copy()) for a in fields.values()]
    outs = stencil_ops.diffuse_fields(*tensors, coef_uv, coef_d)
    for (name, a), t, out in zip(fields.items(), tensors, outs):
        coef, visc = (coef_d, 0.001 * 0.1) if name == "density" else (coef_uv, 0.001)
        assert out.shape == a.shape
        torch.testing.assert_close(out, stencil_ops.diffuse_reference(torch.from_numpy(a), coef),
                                   rtol=0, atol=0)
        want = np.asarray(jax.jit(jax.vmap(lambda x: diffuse_pallas(x, 0.01, visc)))(
            jnp.asarray(a)))
        np.testing.assert_allclose(out.numpy(), want, **TOL, err_msg=name)
        assert np.array_equal(t.numpy(), a)
    with pytest.raises(ValueError, match="contiguous"):
        stencil_ops.diffuse_fields(tensors[0], tensors[1].transpose(-1, -2), tensors[2],
                                   coef_uv, coef_d)
