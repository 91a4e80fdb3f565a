"""The fused solver kernels' launch plan (ops/fused_step.py, plan_launch)
and the port's fused step at tap radius 3 against the JAX package's, on
the CPU.

The plan is pure Python: the card's count of the clusters that fit at once
is passed in as a function of the shape (here a fixed number, or a
card-free estimate). The JAX side of the last test runs its Pallas kernel
in interpret mode, as the JAX tests do; the port's wrapper takes its plain
version on CPU tensors. Tolerances: atol 2e-5 / rtol 1e-4, as
tests/test_torch_solver.py holds the fused path.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
from smokephysai_tpu.physics import solver as jsolver
from smokephysai_tpu_torch.ops import fused_step as step_ops
from smokephysai_tpu_torch.physics import solver as tsolver
from smokephysai_tpu_torch.physics.state import SimState

SMS = 132  # an H100 SXM
SM_SHARED = 233_472  # shared memory of one of its SMs
TOL = dict(atol=2e-5, rtol=1e-4)

# (episodes, h, w): the served scene and the dataset chunk at 128^2, the
# vorticity grid, an odd grid, the smallest, config_streaming_1024.yaml's
SHAPES = [(1, 128, 128), (64, 128, 128), (1, 256, 256), (1, 48, 80), (1, 2, 2),
          (1, 1024, 1024)]


def fixed(n):
    """`max_active_clusters` of a card that fits n clusters of any shape."""
    return lambda *_: n


def estimated(sm_count):
    """A card-free estimate of how many clusters fit at once: CTAs per SM
    by threads (2048), registers (64 a thread under the kernels' launch
    bound) and shared memory (1 KB reserved per CTA); no GPC packing."""
    def count(cluster, bx, by, smem_bytes, mode):
        threads = bx * by
        per_sm = min(2048 // threads, 65536 // (64 * threads), 32)
        if smem_bytes:
            per_sm = min(per_sm, SM_SHARED // (smem_bytes + 1024))
        return sm_count * per_sm // cluster
    return count


def _check_plan(plan, episodes, h, w, max_disp, active):
    assert plan.smem_bytes <= step_ops.SMEM_MAX
    assert 1 <= plan.cluster <= step_ops.MAX_CLUSTER
    assert plan.rows >= max_disp + 2
    assert plan.threads <= step_ops.MAX_THREADS and plan.bx % 32 == 0
    # the stripes cover the grid exactly, one per CTA, u's row h on the last
    stripes = [(r, min(plan.rows, h - r)) for r in range(0, h, plan.rows)]
    assert len(stripes) == plan.cluster
    assert [r for first, n in stripes for r in range(first, first + n)] == list(range(h))
    assert all(n >= 1 for _, n in stripes) and stripes[-1][0] + stripes[-1][1] == h
    # never more clusters than fit at once, nor than episodes
    assert 1 <= plan.clusters <= min(episodes, active)
    assert plan.ctas == plan.clusters * plan.cluster <= active * plan.cluster
    if plan.mode == "shared":
        assert plan.smem_bytes == step_ops.stripe_bytes(plan.rows, w, max_disp)
        assert plan.scratch_floats == 0
    else:
        assert plan.smem_bytes == 0
        assert plan.scratch_floats == plan.clusters * step_ops.plane_set_floats(h, w)


@pytest.mark.parametrize("max_disp", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_the_grid_within_the_card(shape, max_disp):
    episodes, h, w = shape
    for active in (1, 40, 1000):
        plan = step_ops.plan_launch(episodes, h, w, max_disp, fixed(active))
        _check_plan(plan, episodes, h, w, max_disp, active)
        # a number for every shape: the largest cluster that cuts the grid
        # and the most threads win
        want = max(c for c in range(1, 17)
                   if -(-h // max(-(-h // c), max_disp + 2)) == c)
        assert plan.cluster == want
    # the mode follows the state's size: 128^2 and 256^2 stay in shared
    # memory, 1024^2 takes the global scratch
    assert plan.mode == ("global" if h == 1024 else "shared")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_takes_the_fewest_waves(shape):
    """With the count of fitting clusters a function of the shape (here the
    card-free estimate), the plan launches no more than fit, and no shape
    of its mode would take fewer waves over the episodes."""
    episodes, h, w = shape
    count = estimated(SMS)
    plan = step_ops.plan_launch(episodes, h, w, 1, count)
    active = count(plan.cluster, plan.bx, plan.by, plan.smem_bytes, plan.mode)
    _check_plan(plan, episodes, h, w, 1, active)
    waves = -(-episodes // active)
    for cluster in range(1, 17):
        rows = max(-(-h // cluster), 3)
        smem = step_ops.stripe_bytes(rows, w, 1) if plan.mode == "shared" else 0
        if -(-h // rows) != cluster or smem > step_ops.SMEM_MAX:
            continue
        for by in (1, 2, 4, 8, 16, 32):
            other = count(cluster, plan.bx, by, smem, plan.mode)
            if other >= 1:
                assert -(-episodes // other) >= waves


def test_plan_at_the_main_path_shapes():
    """The served scene (batch 1) and the 64-episode chunk at 128^2: the
    state in shared memory, a cluster of 16 for the scene; the chunk in as
    few waves as the estimate allows."""
    scene = step_ops.plan_launch(1, 128, 128, 1, estimated(SMS))
    assert (scene.mode, scene.cluster, scene.clusters, scene.rows) == ("shared", 16, 1, 8)
    chunk = step_ops.plan_launch(64, 128, 128, 1, estimated(SMS))
    assert chunk.mode == "shared" and chunk.clusters == 64


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="positive integer"):
        step_ops.plan_launch(1, 128, 128, 0, fixed(8))
    with pytest.raises(ValueError, match="2x2"):
        step_ops.plan_launch(1, 1, 128, 1, fixed(8))
    with pytest.raises(ValueError, match="limit"):
        step_ops.plan_launch(1, 128, 128, 2 ** 31 - 2, fixed(8))
    with pytest.raises(ValueError, match="no cluster shape fits"):
        step_ops.plan_launch(1, 128, 128, 1, fixed(0))


def test_step_at_tap_radius_3_matches_jax():
    """Ten steps of `step(..., use_pallas=True, max_disp=3)` on both sides
    at 32^2: the JAX fused kernel at radius 3 and the port's fused path
    (its plain version on the CPU; the kernel's runtime-radius
    instantiation on the card). At dt 1 a divergence-free shear of
    amplitude 3 moves most cells 1 to 3.6 cells a step, so the taps at
    2 and 3 cells carry weight: the radius-1 step differs from it by more
    than a cell's density."""
    rng = np.random.default_rng(3)
    h = w = 32
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.zeros((h, w), np.float32)
    for _ in range(3):
        cy, cx = rng.uniform(0.2, 0.8, 2) * (h, w)
        d += rng.uniform(0.5, 1.5) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    phase = rng.uniform(0, 2 * math.pi, 2)
    shear_u = 3.0 * np.sin(2 * math.pi * np.arange(w) / 37 + phase[0])
    shear_v = 3.0 * np.cos(2 * math.pi * np.arange(h) / 29 + phase[1])
    a = {
        "u": (shear_u[None, :] + 0.3 * rng.standard_normal((h + 1, w))).astype(np.float32),
        "v": (shear_v[:, None] + 0.3 * rng.standard_normal((h, w + 1))).astype(np.float32),
        "p": (0.01 * rng.standard_normal((h, w))).astype(np.float32),
        "density": d,
    }
    dt = 1.0
    js = jsolver.SimState(**{k: jnp.asarray(x) for k, x in a.items()})
    ts = SimState(**{k: torch.from_numpy(x.copy()) for k, x in a.items()})
    near = step_ops.fused_step_reference(ts.u, ts.v, ts.p, ts.density, dt, 0.001, 20, 1)
    far = step_ops.fused_step_reference(ts.u, ts.v, ts.p, ts.density, dt, 0.001, 20, 3)
    assert float((near[3] - far[3]).abs().max()) > 0.5
    for _ in range(10):
        js = jsolver.step(js, dt=dt, viscosity=0.001, use_pallas=True, max_disp=3)
        ts = tsolver.step(ts, dt=dt, viscosity=0.001, use_pallas=True, max_disp=3)
    for name in ("u", "v", "p", "density"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   err_msg=name, **TOL)
