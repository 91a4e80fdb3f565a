"""The port's geometric-multigrid pressure solve (`physics/multigrid3d.py`)
and `step3d(pressure_solver="mg")` against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both. Tolerances,
stated per test: both sides do the same float32 operations in the same
order, but XLA may fuse them (one rounding fewer in places): a V-cycle
agreed within 1.7e-7 of the solution's largest |p| at 16^3, and the
tests hold it to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
from smokephysai_tpu.physics import multigrid3d as jmg
from smokephysai_tpu.physics import solver3d as jsolver
from smokephysai_tpu_torch.physics import multigrid3d as mg
from smokephysai_tpu_torch.physics import solver3d

GRID = (16, 16, 16)
ODD = (9, 10, 7)  # no coarsening: the smoother alone


def _np(t):
    return np.asarray(t, np.float32)


def _system(shape, seed):
    rng = np.random.default_rng(seed)
    div = rng.standard_normal(shape).astype(np.float32)
    p0 = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return p0, div


@pytest.mark.parametrize("shape", [GRID, ODD], ids=["16^3", "9x10x7"])
def test_mg_matches_jax(shape):
    """num_levels equal; one `_vcycle` and `mg_pressure` at 1 and 2 cycles
    from a warm start within atol 1e-6 of the largest |p| of the JAX
    result."""
    assert mg.num_levels(shape) == jmg.num_levels(shape)
    p0, div = _system(shape, 1)
    coarsest = jmg.num_levels(shape) - 1
    b = -div
    want = _np(jax.jit(jmg._vcycle, static_argnums=(2, 3))(
        jnp.asarray(p0), jnp.asarray(b), 0, coarsest))
    got = mg._vcycle(torch.from_numpy(p0), torch.from_numpy(b), 0, coarsest).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    jax_mg = jax.jit(jmg.mg_pressure, static_argnums=2)
    for cycles in (1, 2):
        want = _np(jax_mg(jnp.asarray(p0), jnp.asarray(div), cycles))
        got = mg.mg_pressure(torch.from_numpy(p0), torch.from_numpy(div), cycles).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0,
                                   err_msg=f"{cycles} cycles")


def test_num_levels_shapes():
    """Coarsening while every dim is even and >= 8, as the JAX package's."""
    for shape in ((128, 128, 128), (64, 32, 16), (16, 16, 12), (8, 8, 8), (32, 32, 6),
                  (7, 16, 16)):
        assert mg.num_levels(shape) == jmg.num_levels(shape), shape
    assert mg.num_levels((128, 128, 128)) == 6


def test_vcycle_contraction():
    """A V-cycle contracts the error by < 0.35 a cycle at 16^3 (the bound
    of tests/test_solver3d.py): six cycles on A x = 0 from a random x."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(GRID).astype(np.float32))
    b = torch.zeros(GRID)
    coarsest = mg.num_levels(GRID) - 1
    n0 = float(torch.linalg.vector_norm(x))
    for _ in range(6):
        x = mg._vcycle(x, b, 0, coarsest)
    rho = (float(torch.linalg.vector_norm(x)) / n0) ** (1 / 6)
    assert rho < 0.35, rho


def test_batch_equals_each_episode():
    """[2, 16, 16, 16]: each episode of the batched solve equals its solve
    alone (atol 1e-7: torch may take a batched tensor's sums in another
    order)."""
    p0a, diva = _system(GRID, 4)
    p0b, divb = _system(GRID, 5)
    batch = mg.mg_pressure(torch.from_numpy(np.stack([p0a, p0b])),
                           torch.from_numpy(np.stack([diva, divb])), 2)
    for i, (p0, div) in enumerate(((p0a, diva), (p0b, divb))):
        alone = mg.mg_pressure(torch.from_numpy(p0), torch.from_numpy(div), 2)
        torch.testing.assert_close(batch[i], alone, rtol=0, atol=1e-7)


def test_step3d_mg_matches_jax():
    """Three `step3d(pressure_solver="mg")` steps at 16^3 from a smoke state
    with random velocities (num_cg_iters 30: 2 V-cycles) against the JAX
    step: u, v, w and the density within atol 2e-6 plus rtol 1e-5, p within
    1e-5 of its largest |p|; the mg pressure differs from the CG one."""
    rng = np.random.default_rng(6)
    s = jsolver.init_state3d(GRID)
    dens = s.density
    for x, y, z, a in ((5.0, 6.0, 7.0, 1.0), (10.0, 9.0, 8.0, 1.5)):
        dens = jsolver.add_smoke_source3d(dens, x, y, z, radius=5.0, intensity=a)
    vel = lambda f: (0.3 * rng.standard_normal(f.shape)).astype(np.float32)
    s0 = {"u": vel(s.u), "v": vel(s.v), "w": vel(s.w),
          "p": np.zeros(GRID, np.float32), "density": np.array(dens)}
    js = jsolver.SimState3D(**{k: jnp.asarray(v) for k, v in s0.items()})
    ts = solver3d.SimState3D(**{k: torch.from_numpy(v) for k, v in s0.items()})
    for _ in range(3):
        js = jsolver.step3d(js, dt=0.01, viscosity=0.001, pressure_solver="mg")
        ts = solver3d.step3d(ts, dt=0.01, viscosity=0.001, pressure_solver="mg")
    for name in ("u", "v", "w", "density"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), _np(getattr(js, name)),
                                   atol=2e-6, rtol=1e-5, err_msg=name)
    jp = _np(js.p)
    np.testing.assert_allclose(ts.p.numpy(), jp, atol=1e-5 * np.abs(jp).max(), rtol=0)
    cg = solver3d.SimState3D(**{k: torch.from_numpy(v) for k, v in s0.items()})
    for _ in range(3):
        cg = solver3d.step3d(cg, dt=0.01, viscosity=0.001)
    assert not torch.equal(cg.p, ts.p)
