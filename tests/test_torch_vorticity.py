"""The port's vorticity-confined per-op solver path against the JAX
package's, on the CPU.

With vorticity confinement on (or the gather advection, max_disp=0) the
step skips the fused kernel and runs per op: confinement, three diffusions
and a Jacobi solve (the stencil and Jacobi kernels under use_pallas, whose
CPU wrappers take their plain versions), then advection. Inputs are made
with numpy from a seed and handed to both packages; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do. Tolerances are
tests/test_torch_solver.py's (atol 2e-5, rtol 1e-4) unless a test states
another.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.tree_util import keystr, tree_flatten_with_path

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
import smokephysai_tpu.models.chaos_attention as jca
from smokephysai_tpu.models import SmokePhysNet as JaxNet
from smokephysai_tpu.ops.pallas import jacobi as pjacobi
from smokephysai_tpu.ops.pallas.stencil import diffuse_pallas
from smokephysai_tpu.physics import simulator as jsimulator
from smokephysai_tpu.physics import solver as jsolver
from smokephysai_tpu_torch import inference
from smokephysai_tpu_torch.models.net import SmokePhysNet
from smokephysai_tpu_torch.ops import jacobi as tjacobi
from smokephysai_tpu_torch.ops import stencil as tstencil
from smokephysai_tpu_torch.physics import simulator as tsimulator
from smokephysai_tpu_torch.physics import solver as tsolver
from test_torch_model import SMALL, random_variables
from test_torch_solver import TOL, _assert_state, _jax_state, _random_state, _torch_state

EPS = 2.0  # tpu.vorticity_eps of the 256^2 configs
VORTICITY = os.path.join(os.path.dirname(__file__), "..", "config",
                         "config_256_vorticity.yaml")


@pytest.mark.parametrize("branch", ["whole", "tiled"])
def test_jacobi_reference_matches_pallas(branch, monkeypatch):
    """20 sweeps of the plain version against `jacobi_pressure_pallas`:
    whole-grid at 64^2, and the tiled stripes at 128x64 with the VMEM
    budget cut to 80 000 B (stripe 64 and 20 halo rows each side). A fresh
    jit of the JAX function, so no trace of another budget is reused. At
    128x64 the port's band decomposition too (its plain model, with a
    shared-memory budget of 4 000 B a CTA: spans of 48 rows, 16 bands of 8
    owned rows), bit-equal to the plain version and so within TOL of the
    JAX kernel's tiled stripes."""
    h, w = (64, 64) if branch == "whole" else (128, 64)
    if branch == "tiled":
        monkeypatch.setattr(pjacobi, "VMEM_BUDGET_BYTES", 80_000)
    stripes = []
    pick = pjacobi._pick_stripe
    monkeypatch.setattr(pjacobi, "_pick_stripe",
                        lambda *a: stripes.append(pick(*a)) or stripes[-1])
    rng = np.random.default_rng(3)
    p = (0.1 * rng.standard_normal((h, w))).astype(np.float32)
    div = rng.standard_normal((h, w)).astype(np.float32)
    fn = jax.jit(pjacobi.jacobi_pressure_pallas.__wrapped__, static_argnames="num_iters")
    want = np.asarray(fn(jnp.asarray(p), jnp.asarray(div), num_iters=20))
    assert stripes == ([] if branch == "whole" else [64])
    got = tjacobi.jacobi_pressure_reference(torch.from_numpy(p), torch.from_numpy(div), 20)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if branch == "tiled":
        plan = tjacobi.plan_launch(1, h, w, lambda *_: 2, 20, smem_max=4_000)
        assert (plan.mode, plan.span, plan.band, plan.bands) == ("band", 48, 8, 16)
        bands = tjacobi.jacobi_pressure_bands(torch.from_numpy(p), torch.from_numpy(div), 20,
                                              plan)
        np.testing.assert_allclose(bands.numpy(), want, **TOL)
        torch.testing.assert_close(bands, got, rtol=0, atol=0)
    # the wrapper takes the plain version on CPU tensors, batched or not
    pair = tjacobi.jacobi_pressure(torch.from_numpy(np.stack([p, p])),
                                   torch.from_numpy(np.stack([div, div])), 20)
    torch.testing.assert_close(pair[1], got, rtol=0, atol=0)


@pytest.mark.parametrize("field", ["u", "v", "density"])
def test_diffuse_reference_matches_pallas(field):
    """One diffusion of each staggered field of a 64^2 grid, with the
    step's coefficient (dt * viscosity, a tenth of it for the density)."""
    a = _random_state(64, 64, seed=4)[field]
    visc = 0.001 * (0.1 if field == "density" else 1.0)
    want = np.asarray(diffuse_pallas(jnp.asarray(a), 0.01, visc))
    coef = np.float32(0.01) * np.float32(visc)
    got = tstencil.diffuse(torch.from_numpy(a), coef)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, tstencil.diffuse_reference(torch.from_numpy(a), coef),
                               rtol=0, atol=0)


def test_wrappers_reject_bad_inputs():
    p = torch.zeros(8, 8)
    with pytest.raises(TypeError, match="float32"):
        tjacobi.jacobi_pressure(p.double(), p, 20)
    with pytest.raises(ValueError, match="contiguous"):
        tjacobi.jacobi_pressure(torch.zeros(8, 16)[:, ::2], p, 20)
    with pytest.raises(ValueError, match="shape"):
        tjacobi.jacobi_pressure(p, p[:-1], 20)
    with pytest.raises(ValueError, match="2x2"):
        tjacobi.jacobi_pressure(p[:1], p[:1], 20)
    with pytest.raises(TypeError, match="float32"):
        tstencil.diffuse(p.double(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tstencil.diffuse(p.t()[:, :4], 0.1)


def test_vorticity_confinement_matches_jax():
    a = _random_state(48, 40, seed=5)
    want = jax.jit(jsolver.vorticity_confinement)(_jax_state(a), 0.01, EPS)
    got = tsolver.vorticity_confinement(_torch_state(a), 0.01, EPS)
    _assert_state(got, want, **TOL)


def test_bilinear_and_gather_advect_match_jax():
    """`bilinear_interpolate` at coordinates inside, on and beyond the
    grid's edges (clamped corners), and the gather advection (max_disp=0)
    of each field, with velocities large enough to move several cells."""
    rng = np.random.default_rng(6)
    a = _random_state(32, 24, seed=6)
    f = a["density"]
    y = rng.uniform(-1.5, 33.5, (20, 30)).astype(np.float32)
    x = rng.uniform(-1.5, 25.5, (20, 30)).astype(np.float32)
    y[0, :4], x[0, :4] = (31.0, 0.0, 31.0, 12.0), (23.0, 23.0, 0.0, 7.0)
    u, v = 300.0 * a["u"], 300.0 * a["v"]  # up to ~6 cells at dt = 0.01
    names = ("u", "v", "density")

    @jax.jit
    def jax_side(f, y, x, fields, u, v):
        return (jsolver.bilinear_interpolate(f, y, x),
                [jsolver.advect(g, u, v, 0.01, max_disp=0) for g in fields])

    want, want_adv = jax_side(*(jnp.asarray(t) for t in (f, y, x)),
                              [jnp.asarray(a[n]) for n in names], jnp.asarray(u),
                              jnp.asarray(v))
    got = tsolver.bilinear_interpolate(torch.from_numpy(f), torch.from_numpy(y),
                                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name, want in zip(names, want_adv):
        got = tsolver.advect(torch.from_numpy(a[name]), torch.from_numpy(u),
                             torch.from_numpy(v), 0.01, max_disp=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)


@functools.lru_cache(maxsize=None)
def _jax_ten_steps(size, eps, max_disp):
    """Ten `jsolver.step`s of the JAX per-op Pallas path (which the JAX
    package's tests hold bit-exact to its XLA path), with the JAX
    simulator's keywords where they apply, so that the slice below reuses
    the compiled step."""
    kw = dict(dt=0.01, viscosity=0.001, num_jacobi_iters=20, vorticity_eps=eps,
              use_pallas=True)
    if max_disp is not None:
        kw["max_disp"] = max_disp
    js = _jax_state(_random_state(size, size, seed=size + 1))
    for _ in range(10):
        js = jsolver.step(js, **kw)
    return js


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize(
    "eps,use_pallas,max_disp",
    [(EPS, True, None), (EPS, False, None), (0.0, True, 0)],
    ids=["vort-kernels", "vort-plain", "gather-kernels"],
)
def test_perop_step_matches_jax(eps, use_pallas, max_disp, size):
    """Ten per-op steps against `jsolver.step`: vorticity confinement through
    the kernels' wrappers (use_pallas) and through the plain functions, and
    the gather advection (max_disp=0, which also skips the fused kernel)."""
    ts = _torch_state(_random_state(size, size, seed=size + 1))
    for _ in range(10):
        ts = tsolver.step(ts, dt=0.01, viscosity=0.001, vorticity_eps=eps,
                          use_pallas=use_pallas, max_disp=max_disp)
    _assert_state(ts, _jax_ten_steps(size, eps, max_disp), **TOL)


def test_simulate_episode_vorticity_matches_jax():
    """Two episodes at 32^2, T = 5, vorticity on, with the same sources: the
    port's batched `simulate_episode` (the per-op loop through the kernels'
    wrappers) against the JAX package's, one episode at a time (one compile
    for both). Sequences within TOL.
    No frame of five is past the labels' 10-frame warm-up, so both
    packages label the episodes NaN (a mean over no frames)."""
    rng = np.random.default_rng(8)
    xy = rng.uniform(8, 24, (2, 3, 2)).astype(np.float32)
    intensity = rng.uniform(0.5, 2.0, (2, 3)).astype(np.float32)
    active = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    fn = jax.jit(functools.partial(jsimulator.simulate_episode, grid_size=(32, 32),
                                   num_steps=5, vorticity_eps=EPS, use_pallas=True))
    jseq, jlab = (np.stack(r) for r in zip(*(fn(xy[i], intensity[i], active[i])
                                             for i in range(2))))
    seq, lab = tsimulator.simulate_episode(
        torch.from_numpy(xy), torch.from_numpy(intensity), torch.from_numpy(active),
        grid_size=(32, 32), num_steps=5, vorticity_eps=EPS, use_pallas=True)
    assert seq.shape == (2, 5, 32, 32)
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), **TOL)
    assert lab.shape == (2, 3) and np.isnan(np.asarray(jlab)).all()
    assert torch.isnan(lab).all()


GRID = 64
MODEL = dict(SMALL, num_layers=1)  # one layer: the JAX forward compiles in half the time


@pytest.fixture(scope="module")
def vorticity_slice(tmp_path_factory):
    """`python -m smokephysai_tpu_torch.inference` with
    config_256_vorticity.yaml cut to a 64^2 grid and a small model (bf16
    compute, einsum attention as the config has it), and the JAX package's
    serving path on the same weights, chaos fields and fractal field."""
    rng = np.random.default_rng(9)
    tmp = tmp_path_factory.mktemp("vorticity_slice")
    variables = random_variables(rng, **MODEL)
    npz = str(tmp / "small.npz")
    np.savez(npz, **{f"{col}/{keystr(p)}": np.asarray(leaf)
                     for col, tree in variables.items()
                     for p, leaf in tree_flatten_with_path(tree)[0]})
    with open(VORTICITY) as f:
        cfg = yaml.safe_load(f)
    cfg["model"] = dict(MODEL)
    cfg["data"]["grid_size"] = cfg["simulation"]["grid_size"] = [GRID, GRID]
    cfg_path = str(tmp / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    jsim = jsimulator.SmokeSimulator(grid_size=(GRID, GRID), use_pallas=True,
                                     vorticity_eps=EPS)
    fractal = np.array(jsim._fractal)
    fields = [(3.0 * rng.standard_normal((19, 1024, 3))).astype(np.float32)
              for _ in range(MODEL["num_layers"])]
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsimulator, "fractal_field",
                   lambda shape, device="cpu": torch.from_numpy(fractal).to(device))
        mp.setattr(SmokePhysNet, "chaos_fields",
                   lambda self, gen, batch, device: [torch.from_numpy(f) for f in fields])
        mp.setattr(inference, "save_figures",
                   lambda sequence, outputs, output_dir: captured.update(
                       sequence=sequence, outputs=outputs))
        inference.main(["--config", cfg_path, "--checkpoint", npz,
                        "--output_dir", str(tmp / "out"), "--device", "cpu"])

    jsim.add_incense_source(inference.TEST_POSITIONS, inference.TEST_INTENSITIES)
    jseq = np.stack([np.asarray(jsim.simulate_step()) for _ in range(20)])
    jmodel = JaxNet(**MODEL, dtype=jnp.bfloat16)
    calls = iter(fields)
    orig = jca.chaos_field
    jca.chaos_field = lambda key, batch, seq_len: jnp.asarray(next(calls))
    try:
        jout = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, rngs={"chaos": jax.random.PRNGKey(0)}
        ))(variables, jnp.asarray(jseq[:-1, ..., None]))
    finally:
        jca.chaos_field = orig
    return {"captured": captured, "jseq": jseq,
            "jout": {k: np.asarray(v, np.float32) for k, v in jout.items()}}


def test_vorticity_slice_sequence_matches_jax(vorticity_slice):
    """The 20 recorded frames (per-op steps with confinement, fractal
    perturbation): within TOL."""
    seq = torch.stack(vorticity_slice["captured"]["sequence"]).numpy()
    assert seq.shape == (20, GRID, GRID)
    np.testing.assert_allclose(seq, vorticity_slice["jseq"], **TOL)


def test_vorticity_slice_forward_matches_jax(vorticity_slice):
    """The bf16 einsum forward on the 19 input frames: within 2e-2, as
    tests/test_torch_slice.py holds the serving forward."""
    out = vorticity_slice["captured"]["outputs"]
    jout = vorticity_slice["jout"]
    assert out["reconstructed"].shape == (19, GRID, GRID, 1)
    for key in ("reconstructed", "physics_features", "latent_features"):
        np.testing.assert_allclose(out[key].float().numpy(), jout[key],
                                   atol=2e-2, rtol=0, err_msg=key)
