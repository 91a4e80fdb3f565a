"""The port's episode generation and dataset against the JAX package, on the
CPU: the multi-step solver, batched episodes with their chaos labels, the
chaos features against the torch reference's goldens, and the npz cache
shared by both packages.

Inputs are made with numpy from a seed (or drawn by the JAX package) and
handed to both; the JAX Pallas kernel runs in interpret mode. Tolerances
are stated per test.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smokephysai_tpu.data import synthetic as jsyn
from smokephysai_tpu.physics import chaos as jchaos
from smokephysai_tpu.physics import solver as jsolver
from smokephysai_tpu.physics.state import SimState as JaxState
from smokephysai_tpu_torch.data import synthetic as syn
from smokephysai_tpu_torch.physics import chaos, solver
from smokephysai_tpu_torch.physics.simulator import SmokeSimulator, simulate_episode
from smokephysai_tpu_torch.physics.state import SimState

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
GRID = (32, 32)
T = 20


def _state(rng, n, h, w):
    """A batch of n states: smoke blobs and random velocities, numpy."""
    d = np.zeros((n, h, w), np.float32)
    yy, xx = np.mgrid[:h, :w]
    for e in range(n):
        for _ in range(2):
            x, y = rng.uniform(8, w - 8), rng.uniform(8, h - 8)
            d[e] += np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 20.0).astype(np.float32)
    return {"u": (0.5 * rng.standard_normal((n, h + 1, w))).astype(np.float32),
            "v": (0.5 * rng.standard_normal((n, h, w + 1))).astype(np.float32),
            "p": np.zeros((n, h, w), np.float32), "density": d}


def test_multi_step_matches_jax():
    """`multi_step(use_pallas=True)` (the multi-step kernel's plain version
    on the CPU) against the JAX package's `multi_step(use_pallas=True)` (its
    Pallas multi-step kernel in interpret mode) on one episode at 32^2,
    T = 6 (batches of episodes are held in test_episodes_match_jax): final state and trajectory atol 1e-5, p also rtol 1e-5 (the
    divergence carries a 1/dt factor). The port's plain per-op path agrees
    with its fused one to the same bound, and the inputs are unchanged."""
    s = _state(np.random.default_rng(0), 1, *GRID)
    jfinal, jtraj = jsolver.multi_step(
        JaxState(**{k: jnp.asarray(v[0]) for k, v in s.items()}), 6, use_pallas=True)
    state = SimState(**{k: torch.from_numpy(v[0].copy()) for k, v in s.items()})
    final, traj = solver.multi_step(state, 6, use_pallas=True)
    assert traj.shape == (6, *GRID)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-5, rtol=0)
    for name in ("u", "v", "p", "density"):
        np.testing.assert_allclose(getattr(final, name).numpy(),
                                   np.asarray(getattr(jfinal, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
        np.testing.assert_array_equal(getattr(state, name).numpy(), s[name][0])
    final2, traj2 = solver.multi_step(state, 6, use_pallas=False, max_disp=1)
    torch.testing.assert_close(traj2, traj, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A JAX-written cache: the JAX package's dataset generates 2 episodes
    at 32^2, T = 20 (XLA path, vmapped `simulate_episode`) and writes them
    under the name its `create_data_loaders` gives the training split; the
    same file stands in for the validation split under that split's name
    (one generation, one compile)."""
    cache_dir = str(tmp_path_factory.mktemp("cache"))
    train = jsyn.SyntheticSmokeDataset(
        num_samples=2, grid_size=GRID, sequence_length=T, seed=0,
        cache_path=os.path.join(cache_dir, f"train_32x32_T{T}_n2_s0.npz"))
    shutil.copy(os.path.join(cache_dir, f"train_32x32_T{T}_n2_s0.npz"),
                os.path.join(cache_dir, f"val_32x32_T{T}_n2_s1.npz"))
    return {"dir": cache_dir, "train": train}


def test_episodes_match_jax(jax_cache):
    """Batched `simulate_episode` on the JAX episodes' source parameters
    (through the fused-step path the card runs) against the JAX package's
    vmapped episodes: sequences atol 1e-5; chaos labels (Lyapunov, fractal
    dimension, entropy) atol 1e-4 as the chaos goldens are held. At 32^2 the
    two Mandelbrot grids agree on every pixel, so no field is injected."""
    data = jax_cache["train"].data
    seqs, labels = simulate_episode(
        *(torch.tensor(data[k]) for k in ("source_xy", "source_intensity", "source_active")),
        grid_size=GRID, num_steps=T, use_pallas=True)
    assert seqs.shape == (2, T, *GRID) and labels.shape == (2, 3)
    np.testing.assert_allclose(seqs.numpy(), data["sequences"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(labels.numpy(), data["chaos"], atol=1e-4, rtol=0)
    # these episodes' Lyapunov labels are clamped at 0 on both sides; on
    # frames whose steps grow the exponent is positive: rtol 1e-5
    growing = torch.tensor(data["sequences"]) * 2.0 ** torch.arange(T)[:, None, None]
    want = jax.vmap(jchaos.lyapunov_exponent)(jnp.asarray(growing.numpy()))
    assert (np.asarray(want) > 0).all()
    np.testing.assert_allclose(chaos.lyapunov_exponent(growing).numpy(), np.asarray(want),
                               rtol=1e-5)


def test_chaos_features_match_goldens():
    """The chaos functions on the torch reference's recorded 64^2 sequence
    (tests/goldens/chaos_64.npz): per-frame features for t = 10..19, the
    episode average, batched over two copies of the sequence, and the
    facade's features after 20 steps; atol 1e-4, rtol 1e-3 as
    tests/test_fractal_chaos.py holds the JAX package."""
    g = np.load(os.path.join(GOLDENS, "chaos_64.npz"))
    seq = torch.from_numpy(g["sequence"])
    for row, t in enumerate(range(10, 20)):
        lyap = float(chaos.lyapunov_exponent(seq[t - 19:t + 1])) if t >= 19 else 0.0
        got = [lyap, float(chaos.fractal_dimension(seq[t])),
               float(chaos.shannon_entropy(seq[t]))]
        np.testing.assert_allclose(got, g["per_step_features"][row], atol=1e-4, rtol=1e-3)
    avg = chaos.chaos_features_from_sequence(torch.stack([seq, seq]))
    assert avg.shape == (2, 3)
    for a in avg.numpy():
        np.testing.assert_allclose(a, g["avg_features"], atol=1e-4, rtol=1e-3)
    sim = SmokeSimulator(grid_size=(64, 64), device="cpu")
    sim.add_incense_source([(32, 20), (45, 40)], [1.5, 0.8])
    assert sim.get_chaos_features() == {}
    for _ in range(20):
        sim.simulate_step()
    feats = sim.get_chaos_features()
    np.testing.assert_allclose(
        [feats["lyapunov_exponent"], feats["fractal_dimension"], feats["entropy"]],
        g["per_step_features"][-1], atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("storage,limit", [("f32", 4e9), ("f16", 1e5), ("host", 5e4)])
def test_cache_gives_jax_batches(jax_cache, monkeypatch, storage, limit):
    """The port's `create_data_loaders` reads the JAX-written cache (its file
    names are the JAX package's: nothing is generated) and, for the same
    episode and frame indices, assembles the JAX dataset's batches exactly:
    float32 on the device, float16 storage (forced by lowering
    DEVICE_BYTES_LIMIT on both classes) and host-resident."""
    monkeypatch.setattr(jsyn.SyntheticSmokeDataset, "DEVICE_BYTES_LIMIT", limit)
    monkeypatch.setattr(syn.SyntheticSmokeDataset, "DEVICE_BYTES_LIMIT", limit)
    files = sorted(os.listdir(jax_cache["dir"]))
    jtrain, _ = jsyn.create_data_loaders(batch_size=2, num_train=2, num_val=2,
                                         grid_size=GRID, cache_dir=jax_cache["dir"],
                                         sequence_length=T, seed=0)
    train, val = syn.create_data_loaders(batch_size=2, num_train=2, num_val=2,
                                         grid_size=GRID, cache_dir=jax_cache["dir"],
                                         sequence_length=T, seed=0, device="cpu")
    assert sorted(os.listdir(jax_cache["dir"])) == files  # both only read it
    np.testing.assert_array_equal(val.data["sequences"],
                                  jax_cache["train"].data["sequences"])
    assert (train._seq_f16, train._on_device) == (storage == "f16", storage != "host")
    assert (jtrain._seq_f16, jtrain._on_device) == (train._seq_f16, train._on_device)
    idx, frames = np.array([1, 0]), np.array([5, 14])
    want = jtrain.get_batch(jnp.asarray(idx), jnp.asarray(frames))
    got = train.get_batch(torch.from_numpy(idx), torch.from_numpy(frames))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_epoch_draws_and_sequence_check():
    """Epoch order is a permutation (in order without shuffling), input
    frames lie in [5, T-5), full batches plus the ragged tail cover every
    episode once; T <= 10 is refused by both packages; source parameters
    have the JAX package's ranges."""
    g = torch.Generator().manual_seed(0)
    order, frames = syn.epoch_order_frames(g, 50, 12, shuffle=True)
    assert sorted(order.tolist()) == list(range(50))
    assert frames.min() >= 5 and frames.max() < 7
    order, _ = syn.epoch_order_frames(g, 7, 20, shuffle=False)
    assert order.tolist() == list(range(7))
    idx, fr, (tail, tail_fr) = syn.epoch_index_arrays(g, 7, 3, 20, shuffle=True)
    assert idx.shape == fr.shape == (2, 3) and tail.shape == tail_fr.shape == (1,)
    assert sorted(idx.flatten().tolist() + tail.tolist()) == list(range(7))
    for check in (syn._check_sequence_length, jsyn._check_sequence_length):
        with pytest.raises(ValueError, match="sequence_length"):
            check(10)
        check(11)
    p = syn.sample_source_params(g, 2000, (128, 96))
    assert p["xy"].shape == (2000, 3, 2)
    xs, ys = p["xy"][..., 0], p["xy"][..., 1]
    assert xs.min() >= 20 and xs.max() < 76 and ys.min() >= 20 and ys.max() < 108
    assert p["intensity"].min() >= 0.5 and p["intensity"].max() < 2.0
    assert sorted(set(p["active"].sum(-1).tolist())) == [1.0, 2.0, 3.0]
    assert (p["active"][:, 0] == 1).all()
    small = syn.sample_source_params(g, 4, GRID)
    assert (small["xy"] == 20).all()  # [20, 12) is empty: jax.random gives 20
