"""The port's 3D solver, episode generator, volume chaos features and 3D
dataset against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both. The JAX CG
Pallas kernel runs in interpret mode, as tests/test_pallas.py runs it.
Tolerances, stated per test: the CG's float32 sums are taken in another
order by torch than by XLA (atol 1e-6, as tests/test_pallas.py holds the
two JAX forms to each other); a step and an episode carry that through
the velocity correction and the advection.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
from smokephysai_tpu.data import synthetic3d as jsyn3d
from smokephysai_tpu.ops.pallas.cg3d import cg_pressure_pallas
from smokephysai_tpu.physics import chaos as jchaos
from smokephysai_tpu.physics import solver3d as jsolver
from smokephysai_tpu.physics.simulator3d import simulate_episode3d as jsimulate
from smokephysai_tpu_torch.data import synthetic3d
from smokephysai_tpu_torch.ops import cg3d
from smokephysai_tpu_torch.physics import chaos, solver3d
from smokephysai_tpu_torch.physics.simulator3d import simulate_episode3d

GRID = (16, 16, 16)


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("jax_form", ["xla", "pallas"])
@pytest.mark.parametrize("warm", [False, True], ids=["p0=0", "warm"])
def test_cg_matches_jax(jax_form, warm):
    """The plain CG against the JAX package's XLA `cg_pressure` and its
    Pallas kernel (interpret mode) at (8, 8, 128) x 20 iterations, atol
    1e-6; on CPU tensors the wrapper is the plain version."""
    rng = np.random.default_rng(3)
    div = rng.standard_normal((8, 8, 128)).astype(np.float32)
    p0 = (0.1 * rng.standard_normal(div.shape)).astype(np.float32) if warm \
        else np.zeros_like(div)
    jfn = jsolver.cg_pressure if jax_form == "xla" else cg_pressure_pallas
    want = _np(jax.jit(jfn, static_argnames="num_iters")(
        jnp.asarray(p0), jnp.asarray(div), num_iters=20))
    tp0, tdiv = torch.from_numpy(p0), torch.from_numpy(div)
    got = cg3d.cg_pressure_reference(tp0, tdiv, 20)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    torch.testing.assert_close(cg3d.cg_pressure(tp0, tdiv, 20), got, rtol=0, atol=0)


def test_cg_batched_alpha_beta_per_episode_and_guards():
    """A batch of episodes solves each with its own alpha and beta: each
    equals its solve alone (atol 1e-7: torch may sum a batched tensor in
    another order). Zero divergence from p0 = 0 stays 0, with no NaN (the
    denom > 0 and rs > 0 guards); 0 iterations return p0. The wrapper
    refuses what the kernel does not take."""
    rng = np.random.default_rng(4)
    div = torch.from_numpy(rng.standard_normal((3, 6, 7, 5)).astype(np.float32))
    div[1] *= 50.0  # another scale: shared alphas would be far off
    p0 = torch.from_numpy((0.1 * rng.standard_normal(div.shape)).astype(np.float32))
    batched = cg3d.cg_pressure(p0, div, 12)
    for i in range(3):
        torch.testing.assert_close(batched[i], cg3d.cg_pressure(p0[i], div[i], 12),
                                   rtol=0, atol=1e-7 * float(div[i].abs().max()))
    zero = torch.zeros(2, 4, 4, 4)
    out = cg3d.cg_pressure(zero, zero, 30)
    assert torch.equal(out, zero)
    assert torch.equal(cg3d.cg_pressure(p0, div, 0), p0)
    with pytest.raises(TypeError, match="float32"):
        cg3d.cg_pressure(p0.double(), div.double(), 3)
    with pytest.raises(ValueError, match="shape"):
        cg3d.cg_pressure(p0, div[:, :-1].contiguous(), 3)
    with pytest.raises(ValueError, match="num_iters"):
        cg3d.cg_pressure(p0, div, -1)
    assert cg3d.launches_per_solve(30) == 1  # one cooperative launch a solve


def test_trilinear_shift_sample_matches_gather_and_jax():
    """Coordinates within one cell of each centre: the tent-shift sample
    equals the corner-clamped gather (atol 1e-6, other summation), and each
    matches its JAX counterpart (atol 1e-6). Batched over two episodes."""
    rng = np.random.default_rng(5)
    d, h, w = 6, 7, 8
    field = rng.random((2, d, h, w)).astype(np.float32)
    grids = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    coords = [np.clip(g + rng.uniform(-0.9, 0.9, (2, d, h, w)), 0, n - 1).astype(np.float32)
              for g, n in zip(grids, (d, h, w))]
    tf = torch.from_numpy(field)
    tz, ty, tx = (torch.from_numpy(c) for c in coords)
    shift = solver3d.trilinear_shift_sample(tf, tz, ty, tx, 1)
    gather = solver3d.trilinear_interpolate(tf, tz, ty, tx)
    np.testing.assert_allclose(shift.numpy(), gather.numpy(), atol=1e-6)
    for e in range(2):
        args = [jnp.asarray(field[e])] + [jnp.asarray(c[e]) for c in coords]
        np.testing.assert_allclose(
            shift[e].numpy(), _np(jsolver.trilinear_shift_sample(*args, 1)), atol=1e-6)
        np.testing.assert_allclose(
            gather[e].numpy(), _np(jsolver.trilinear_interpolate(*args)), atol=1e-6)


def _state(rng):
    """A 16^3 state with two sources and a weak random velocity field."""
    s = jsolver.init_state3d(GRID)
    dens = s.density
    for x, y, z, a in ((5.0, 6.0, 7.0, 1.0), (10.0, 9.0, 8.0, 1.5)):
        dens = jsolver.add_smoke_source3d(dens, x, y, z, radius=5.0, intensity=a)
    vel = lambda f: (0.3 * rng.standard_normal(f.shape)).astype(np.float32)
    return {"u": vel(s.u), "v": vel(s.v), "w": vel(s.w),
            "p": np.zeros(GRID, np.float32), "density": np.array(dens)}


@pytest.mark.parametrize("max_disp", [1, 0], ids=["tent", "gather"])
def test_step3d_matches_jax(max_disp):
    """Three steps of `step3d` at 16^3 (the third from the second's warm
    pressure) against the JAX step, for the plain CG and for `use_pallas`
    (here, on CPU tensors, the kernel's plain version): u, v, w and the
    density within atol 2e-6 plus rtol 1e-5; p within 1e-5 of its largest
    |p| (~4 here): 30 CG iterations leave a residual whose float32 sums
    torch and XLA take in other orders."""
    rng = np.random.default_rng(6)
    s0 = _state(rng)
    js = jsolver.SimState3D(**{k: jnp.asarray(v) for k, v in s0.items()})
    for _ in range(3):
        js = jsolver.step3d(js, dt=0.01, viscosity=0.001, max_disp=max_disp)
    for use_pallas in (False, True):
        ts = solver3d.SimState3D(**{k: torch.from_numpy(v) for k, v in s0.items()})
        for _ in range(3):
            ts = solver3d.step3d(ts, dt=0.01, viscosity=0.001, max_disp=max_disp,
                                 use_pallas=use_pallas)
        for name in ("u", "v", "w", "density"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), _np(getattr(js, name)),
                                       atol=2e-6, rtol=1e-5, err_msg=name)
        jp = _np(js.p)
        np.testing.assert_allclose(ts.p.numpy(), jp, atol=1e-5 * np.abs(jp).max(), rtol=0)
    with pytest.raises(ValueError, match="pressure_solver"):
        solver3d.step3d(ts, pressure_solver="jacobi")


def test_simulate_episode3d_matches_jax():
    """Two episodes at 16^3 x T = 12 with injected sources (one and three
    active): each sequence within atol 2e-6 of the JAX episode, each chaos
    label within atol 1e-5 (T < 20: lyapunov 0; the fractal dimension and
    entropy of frames 10 and 11); `use_pallas` gives the same here."""
    xyz = np.array([[[5, 6, 7], [11, 9, 4], [8, 8, 8]],
                    [[4, 11, 6], [10, 5, 9], [7, 7, 11]]], np.float32)
    inten = np.array([[1.2, 0.7, 1.9], [0.6, 1.4, 1.0]], np.float32)
    active = np.array([[1, 0, 0], [1, 1, 1]], np.float32)
    seq, lab = simulate_episode3d(*(torch.from_numpy(a) for a in (xyz, inten, active)),
                                  grid_size=GRID, num_steps=12)
    seq_k, lab_k = simulate_episode3d(*(torch.from_numpy(a) for a in (xyz, inten, active)),
                                      grid_size=GRID, num_steps=12, use_pallas=True)
    assert seq.shape == (2, 12, *GRID) and lab.shape == (2, 3)
    torch.testing.assert_close(seq_k, seq, rtol=0, atol=0)
    torch.testing.assert_close(lab_k, lab, rtol=0, atol=0)
    for e in range(2):
        jseq, jlab = jsimulate(jnp.asarray(xyz[e]), jnp.asarray(inten[e]),
                               jnp.asarray(active[e]), grid_size=GRID, num_steps=12)
        np.testing.assert_allclose(seq[e].numpy(), _np(jseq), atol=2e-6)
        np.testing.assert_allclose(lab[e].numpy(), _np(jlab), atol=1e-5)
    assert float(lab[:, 0].abs().max()) == 0.0


def test_volume_chaos_features_match_jax():
    """Box counts, fractal dimension, entropy and the Lyapunov exponent of
    volumes ([T=22, 12, 16, 20]: every spatial axis distinct, T past the
    20-frame window) against the JAX package's 3D definitions: counts
    exact, the rest atol 1e-5; the 2D default is unchanged."""
    rng = np.random.default_rng(7)
    seq = np.cumsum(0.05 * rng.standard_normal((22, 12, 16, 20)), axis=0).astype(np.float32)
    seq = np.clip(seq + 0.5, -0.2, 1.2).astype(np.float32)
    t = torch.from_numpy(seq)
    binary = (seq[-1] > seq[-1].mean()).astype(np.float32)
    for s in chaos.BOX_SCALES:
        assert float(chaos.box_count(torch.from_numpy(binary), s, spatial_dims=3)) == \
            float(jchaos.box_count(jnp.asarray(binary), s))
    want = jax.jit(lambda s: (
        jchaos.fractal_dimension(s[-1]), jchaos.shannon_entropy(s[-1]),
        jchaos.lyapunov_exponent(s), jchaos.chaos_features_from_sequence(s),
        jchaos.chaos_features(s, 22)))(jnp.asarray(seq))
    got = (chaos.fractal_dimension(t[-1], spatial_dims=3),
           chaos.shannon_entropy(t[-1], spatial_dims=3),
           chaos.lyapunov_exponent(t, spatial_dims=3),
           chaos.chaos_features_from_sequence(t, spatial_dims=3),
           chaos.chaos_features(t, 22, spatial_dims=3))
    pairs = list(zip(got, want))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)
    # [2, T, D, H, W]: a leading episode axis
    both = chaos.chaos_features_from_sequence(torch.stack([t, t.flip(-1)]), spatial_dims=3)
    np.testing.assert_allclose(both[0].numpy(), pairs[3][0].numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="spatial_dims"):
        chaos.fractal_dimension(t[-1], spatial_dims=4)


def test_dataset3d_cache_names_f16_and_batches(tmp_path, monkeypatch):
    """The 3D dataset at 8^3, T = 12: the port writes its cache under the
    JAX package's name tagged `_torch` and reads a file the JAX package
    wrote under its own name; the chunk cap of 8 * 64^3 voxels; at or past
    `DEVICE_BYTES_LIMIT` float32 bytes the sequences are stored float16 and
    batches come back float32; the source margin rule."""
    grid, T = (8, 8, 8), 12
    train, val = synthetic3d.create_data_loaders3d(
        num_train=2, num_val=1, grid_size=grid, cache_dir=str(tmp_path),
        sequence_length=T, seed=0, device="cpu")
    names = sorted(os.listdir(tmp_path))
    assert names == ["train3d_8x8x8_T12_n2_s0_torch.npz", "val3d_8x8x8_T12_n1_s1_torch.npz"]
    assert len(train) == 2 and not train._seq_f16
    b = train.get_batch(torch.tensor([1, 0]), torch.tensor([5, 6]))
    assert b["input"].shape == (2, *grid, 1) and b["sequence"].shape == (2, T, *grid)
    torch.testing.assert_close(b["target"][0, ..., 0], b["sequence"][0, 6])
    assert [x["input"].shape[0] for x in val.epoch_batches(torch.Generator(), 4, False)] == [1]

    # a JAX-named file is read as it is
    jax_name = tmp_path / "train3d_8x8x8_T12_n3_s0.npz"
    np.savez(jax_name, sequences=np.full((3, T, *grid), 0.25, np.float32),
             chaos=np.zeros((3, 3), np.float32))
    t2, _ = synthetic3d.create_data_loaders3d(
        num_train=3, num_val=1, grid_size=grid, cache_dir=str(tmp_path),
        sequence_length=T, seed=0, device="cpu")
    assert len(t2) == 3 and float(t2._sequences.max()) == 0.25

    # float16 storage from the limit on; the chunk cap
    monkeypatch.setattr(synthetic3d.SyntheticSmokeDataset3D, "DEVICE_BYTES_LIMIT",
                        2 * T * 8 ** 3 * 4)
    calls = []
    real = synthetic3d.simulate_episode3d
    monkeypatch.setattr(synthetic3d, "simulate_episode3d",
                        lambda xyz, *a, **k: calls.append(len(xyz)) or real(xyz, *a, **k))
    monkeypatch.setattr(synthetic3d, "CHUNK_VOXELS", 8 ** 3)
    ds = synthetic3d.SyntheticSmokeDataset3D(num_samples=2, grid_size=grid,
                                             sequence_length=T, device="cpu")
    assert calls == [1, 1]
    assert ds._seq_f16 and ds._sequences.dtype == torch.float16
    batch = ds.sample_batch(torch.Generator().manual_seed(0), 3)
    assert batch["input"].dtype == torch.float32 and batch["input"].shape == (3, *grid, 1)

    # source positions: integers in [margin, size - margin), margin = min(20, min // 4)
    p = synthetic3d.sample_source_params3d(torch.Generator().manual_seed(1), 64, (16, 24, 32))
    xyz = p["xyz"]
    for axis, size in enumerate((32, 24, 16)):
        assert 4 <= float(xyz[..., axis].min()) and float(xyz[..., axis].max()) < size - 4
    assert set(p["active"].sum(1).tolist()) <= {1.0, 2.0, 3.0}
    assert jsyn3d.SOURCE_MARGIN == synthetic3d.SOURCE_MARGIN
