"""The PyTorch port's solver against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs its Pallas kernels in interpret mode (as the JAX tests do); the
port's fused-step wrapper takes its plain version on CPU tensors. The
simulator's 20-frame sequence with the fractal perturbation is held against
the JAX package's in tests/test_torch_slice.py, and the per-op path with
vorticity confinement and the gather advection in
tests/test_torch_vorticity.py.
Tolerances: atol 2e-5 / rtol 1e-4 on the fields, as tests/test_solver.py
holds the JAX solver to the reference.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
from smokephysai_tpu.ops.pallas.fused_step import fused_step_pallas
from smokephysai_tpu.physics import fractal as jfractal
from smokephysai_tpu.physics import solver as jsolver
from smokephysai_tpu_torch.ops.fused_step import fused_step, fused_step_reference
from smokephysai_tpu_torch.physics import fractal as tfractal
from smokephysai_tpu_torch.physics import solver as tsolver
from smokephysai_tpu_torch.physics.state import SimState

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(atol=2e-5, rtol=1e-4)


def _random_state(h, w, seed):
    """Smoke blobs plus small random velocities and pressure (numpy)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.zeros((h, w), np.float32)
    for _ in range(3):
        cy, cx = rng.uniform(0.2, 0.8, 2) * (h, w)
        d += rng.uniform(0.5, 1.5) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    return {
        "u": (0.5 * rng.standard_normal((h + 1, w))).astype(np.float32),
        "v": (0.5 * rng.standard_normal((h, w + 1))).astype(np.float32),
        "p": (0.01 * rng.standard_normal((h, w))).astype(np.float32),
        "density": d.astype(np.float32),
    }


def _jax_state(a):
    return jsolver.SimState(**{k: jnp.asarray(v) for k, v in a.items()})


def _torch_state(a):
    return SimState(**{k: torch.from_numpy(v.copy()) for k, v in a.items()})


def _assert_state(ts, js, **tol):
    for name in ("u", "v", "p", "density"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            err_msg=name, **tol,
        )


@pytest.mark.parametrize(
    "size,use_pallas",
    [(32, True), (64, True), (32, False), (64, False)],
    ids=["fused-32", "fused-64", "perop-32", "perop-64"],
)
def test_step_matches_jax(size, use_pallas):
    """Ten steps of `step` on both sides: the fused path and the per-op
    path."""
    a = _random_state(size, size, seed=size)
    js, ts = _jax_state(a), _torch_state(a)
    for _ in range(10):
        js = jsolver.step(js, dt=0.01, viscosity=0.001, use_pallas=use_pallas)
        ts = tsolver.step(ts, dt=0.01, viscosity=0.001, use_pallas=use_pallas)
    _assert_state(ts, js, **TOL)


def test_fused_step_reference_matches_pallas():
    """The kernel's plain version against the Pallas kernel, one step."""
    a = _random_state(32, 48, seed=7)
    jout = fused_step_pallas(
        *(jnp.asarray(a[k]) for k in ("u", "v", "p", "density")),
        0.01, 0.001, 20, max_disp=1,
    )
    targs = [torch.from_numpy(a[k]) for k in ("u", "v", "p", "density")]
    tout = fused_step_reference(*targs, 0.01, 0.001, 20, 1)
    for name, t, j in zip(("u", "v", "p", "density"), tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **TOL)
    # a wider tap radius changes nothing while the back-trace moves less
    # than a cell (the extra taps have weight exactly 0)
    for t, w in zip(tout, fused_step_reference(*targs, 0.01, 0.001, 20, 2)):
        torch.testing.assert_close(w, t, rtol=0, atol=0)
    # the wrapper takes the plain version on CPU tensors, batched or not
    batched = fused_step(*(t[None].repeat(2, *([1] * t.ndim)) for t in targs),
                         0.01, 0.001, 20, 1)
    for t, b in zip(tout, batched):
        torch.testing.assert_close(b[1], t, rtol=0, atol=0)


def test_fused_step_wrapper_rejects_bad_inputs():
    a = _random_state(16, 16, seed=1)
    u, v, p, d = (torch.from_numpy(a[k]) for k in ("u", "v", "p", "density"))
    with pytest.raises(ValueError, match="shape"):
        fused_step(u[:-1], v, p, d, 0.01, 0.001)
    with pytest.raises(TypeError, match="float32"):
        fused_step(u.double(), v, p, d, 0.01, 0.001)
    with pytest.raises(ValueError, match="contiguous"):
        fused_step(u, v, p.t(), d, 0.01, 0.001)


def test_golden_five_steps():
    """The port's per-op step against the reference solver's recorded run
    (tests/goldens/solver_64.npz), as test_solver.py holds the JAX one."""
    g = np.load(os.path.join(GOLDENS, "solver_64.npz"))
    s = tsolver.init_state((64, 64), device="cpu")
    d = tsolver.add_smoke_source(s.density, 32.0, 20.0, radius=8.0, intensity=1.5)
    d = tsolver.add_smoke_source(d, 45.0, 40.0, radius=10.0, intensity=0.8)
    np.testing.assert_allclose(d.numpy(), g["density_init"], atol=1e-5)
    s = s.replace(density=d)
    for t in range(5):
        s = tsolver.step(s, dt=0.01, viscosity=0.001)
        for name, key in (("density", "density"), ("u", "u"), ("v", "v"), ("p", "p")):
            np.testing.assert_allclose(
                getattr(s, name).numpy(), g[key][t], err_msg=name, **TOL
            )


def test_fractal_field_matches_jax():
    """Perlin noise agrees to float32 rounding. The Mandelbrot escape count
    may differ on a few pixels of the set's boundary: XLA rewrites the
    arithmetic of jnp.linspace, so the grid coordinates differ in the last
    bit there (at most 0.5% of the pixels)."""
    shape = (64, 64)
    np.testing.assert_allclose(
        tfractal.perlin_noise(shape).numpy(),
        np.asarray(jfractal.perlin_noise(shape)), atol=1e-5, rtol=0,
    )
    tm = tfractal.mandelbrot_field(shape).numpy()
    jm = np.asarray(jfractal.mandelbrot_field(shape))
    assert np.mean(tm != jm) <= 0.005
    full = tfractal.fractal_field(shape, device="cpu").numpy()
    assert np.mean(np.abs(full - jfractal.fractal_field(shape)) > 1e-5) <= 0.005
