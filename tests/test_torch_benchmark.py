"""The port's benchmark CLI (`smokephysai_tpu_torch/benchmark.py`) against the
root `benchmark.py`, on the CPU.

Small models at 32^2 (16^3 in 3D), their variables from `jax.eval_shape`
filled with numpy draws and carried across with `jax_variables_to_state_dict`,
as tests/test_torch_model.py does; the batches are made with numpy from a
seed. The JAX predictor draws its chaos fields from `PRNGKey(0)` as the JAX
`make_predictor` does; those draws are recorded while its program is traced
and injected into the port's predictor (`make_predictor(chaos_traj=...)`,
the path `--samples` takes), so both models see the same fields.
Tolerances are stated per test.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
import benchmark as jbench
import smokephysai_tpu.models.chaos_attention as jca
from smokephysai_tpu.data.synthetic import epoch_order_frames, sample_source_params
from smokephysai_tpu.models import SmokePhysNet as JaxNet
from smokephysai_tpu.models import net3d as jnet3d
from smokephysai_tpu_torch import benchmark as tbench
from smokephysai_tpu_torch.models.convert import jax_variables_to_state_dict
from smokephysai_tpu_torch.models.net import SmokePhysNet
from smokephysai_tpu_torch.models.net3d import SmokePhysNet3D
from smokephysai_tpu_torch.train.serving import make_predictor
from smokephysai_tpu_torch.utils.config import load_config
from test_torch_model import SMALL, random_variables
from test_torch_net3d import SMALL as SMALL3D
from test_torch_net3d import random_variables as random_variables3d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
DRAWS = {"config/config.yaml": "gate_draws_128x128_n50_s0.npz",
         "config/config_256_vorticity.yaml": "gate_draws_256x256_n50_s0.npz",
         "config/config_512_plume.yaml": "gate_draws_512x512_n100_s0.npz"}


def jax_predictor(model, variables, seed=0):
    """(predict, drawn): the JAX model's jitted eval forward under
    `PRNGKey(seed)`, as the JAX `make_predictor` runs it, and a dict that
    each call fills with the [layers, B, 5, 3] Lorenz trajectories the
    forward drew at its batch B (recorded from `chaos_field` while the
    program is traced and returned as outputs of the same program)."""
    key = jax.random.PRNGKey(seed)

    @jax.jit
    def run(v, x):
        recorded = []
        original = jca.chaos_field

        def recording(k, batch, seq_len):
            field = original(k, batch, seq_len)
            recorded.append(field[:, :jca.LORENZ_STEPS])
            return field

        jca.chaos_field = recording
        try:
            out = model.apply(v, x, train=False, rngs={"chaos": key})
        finally:
            jca.chaos_field = original
        return out, jnp.stack(recorded)

    drawn = {}

    def predict(x):
        out, traj = run(variables, x)
        if not isinstance(traj, jax.core.Tracer):  # not under jax.grad
            drawn[x.shape[0]] = torch.from_numpy(np.array(traj))
        return out

    return predict, drawn


def port_model(cls, variables, **model):
    m = cls(**model)
    m.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return m.eval()


def batches(rng, sizes, frame_shape):
    """numpy batches {input, target, chaos_features} of the given sizes:
    smooth random frames in [0, 1] and the target a shifted, damped copy."""
    out = []
    for n in sizes:
        x = rng.random((n, *frame_shape)).astype(np.float32)
        for ax in range(1, len(frame_shape)):
            x = 0.5 * (x + np.roll(x, 1, axis=ax))
        out.append({"input": x[..., None],
                    "target": (0.95 * np.roll(x, 1, axis=1))[..., None].astype(np.float32),
                    "chaos_features": rng.standard_normal((n, 3)).astype(np.float32)})
    return out


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_evaluate_model_matches_jax():
    """`evaluate_model` at 32^2 over 6 samples (a batch of 4 and the tail of
    2), the same chaos fields: MSE and mean physics correlation within 1e-5
    relative (float32 forwards that agree to ~1e-6 per output element)."""
    rng = np.random.default_rng(0)
    variables = random_variables(rng, **SMALL)
    data = batches(rng, (4, 2), (32, 32))
    jpredict, drawn = jax_predictor(JaxNet(**SMALL), variables)
    want = jbench.evaluate_model(jpredict, [as_jax(b) for b in data])
    predict = make_predictor(port_model(SmokePhysNet, variables, **SMALL), chaos_traj=drawn)
    got = tbench.evaluate_model(predict, [as_torch(b) for b in data])
    assert got["inference_time"] > 0
    for key in ("mse", "physics_correlation"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_flow_baselines_match_jax():
    """The three flow functions and the 2D baseline table on the same uint8
    frames: the same cv2 calls on the same arrays, so the same bits."""
    rng = np.random.default_rng(1)
    data = batches(rng, (2,), (48, 40))
    prev = (data[0]["input"][0, ..., 0] * 255).astype(np.uint8)
    nxt = (data[0]["target"][0, ..., 0] * 255).astype(np.uint8)
    for name in ("farneback_flow", "lucas_kanade_flow"):
        flow = getattr(tbench, name)(prev, nxt)
        np.testing.assert_array_equal(flow, getattr(jbench, name)(prev, nxt), err_msg=name)
        np.testing.assert_array_equal(tbench.warp_with_flow(prev, flow),
                                      jbench.warp_with_flow(prev, flow), err_msg=name)
    got = tbench.evaluate_traditional_cv([as_torch(b) for b in data])
    want = jbench.evaluate_traditional_cv([as_jax(b) for b in data])
    assert {k: v["mse"] for k, v in got.items()} == {k: v["mse"] for k, v in want.items()}


@pytest.mark.parametrize("config", sorted(DRAWS))
def test_gate_draws_are_the_jax_clis(config):
    """Each committed draw file against `sample_source_params` and
    `epoch_order_frames` called afresh with the JAX CLI's keys (seed + 1000
    and PRNGKey(0)), and `read_samples` gives them back with the run's
    config."""
    cfg = load_config(os.path.join(ROOT, config))
    grid, seed = tuple(cfg["data"]["grid_size"]), cfg["tpu"]["seed"]
    with np.load(os.path.join(GOLDENS, DRAWS[config])) as f:
        draws = {k: f[k] for k in f.files}
    n = int(draws["num_samples"])
    params = sample_source_params(jax.random.PRNGKey(seed + 1000), n, grid)
    _, frames = epoch_order_frames(jax.random.PRNGKey(0), n, cfg["data"]["sequence_length"],
                                   shuffle=False)
    for key in ("xy", "intensity", "active"):
        np.testing.assert_array_equal(draws[f"source_{key}"], np.asarray(params[key]))
    np.testing.assert_array_equal(draws["frames"], np.asarray(frames))
    samples = tbench.read_samples(os.path.join(GOLDENS, DRAWS[config]), cfg, n)
    # a batch of 4 and the tail's batch of n % 4 (none at n = 100)
    assert sorted(samples["chaos_traj"]) == sorted({4, n % 4} - {0})
    assert samples["chaos_traj"][4].shape == (cfg["model"]["num_layers"], 4, 5, 3)


def test_samples_of_another_run_are_refused():
    """`--samples` refuses a file whose N, grid or seed is not the run's."""
    path = os.path.join(GOLDENS, DRAWS["config/config.yaml"])
    cfg = load_config(os.path.join(ROOT, "config", "config.yaml"))
    with pytest.raises(ValueError, match="num_samples 50 in the file, 49"):
        tbench.read_samples(path, cfg, 49)
    with pytest.raises(ValueError, match="grid_size"):
        tbench.read_samples(path, load_config(os.path.join(ROOT, "config", "config_64.yaml")), 50)
    cfg["tpu"]["seed"] = 1
    with pytest.raises(ValueError, match="seed"):
        tbench.read_samples(path, cfg, 50)


def test_samples_without_a_batch_shape_are_refused(tmp_path):
    """A draw file that lacks the chaos trajectories of a batch shape the
    run takes is refused when it is read: the 512^2 file's N = 100 needs
    only batches of 4 (no tail), and without them it is refused."""
    path = os.path.join(GOLDENS, DRAWS["config/config_512_plume.yaml"])
    cfg = load_config(os.path.join(ROOT, "config", "config_512_plume.yaml"))
    assert sorted(tbench.read_samples(path, cfg, 100)["chaos_traj"]) == [4]
    with np.load(path) as f:
        cut = {k: f[k] for k in f.files if k != "chaos_traj_b4"}
    np.savez(tmp_path / "cut.npz", **cut)
    with pytest.raises(ValueError, match=r"batches of \[4\]"):
        tbench.read_samples(str(tmp_path / "cut.npz"), cfg, 100)


def test_volumetric_model_row_and_persistence_match_jax(monkeypatch):
    """The 3D protocol at 16^3, 2 volumes at batch 1: the model's MSE and
    correlation within 1e-5 relative (the chaos fields the JAX predictor
    drew, injected), and the baselines (slicewise Farneback and
    persistence) equal; without cv2 only persistence."""
    rng = np.random.default_rng(2)
    variables = random_variables3d(rng, **SMALL3D)
    data = batches(rng, (1, 1), (16, 16, 16))
    jpredict, drawn = jax_predictor(jnet3d.SmokePhysNet3D(**SMALL3D), variables)
    want = jbench.evaluate_model(jpredict, [as_jax(b) for b in data])
    predict = make_predictor(port_model(SmokePhysNet3D, variables, **SMALL3D), chaos_traj=drawn)
    got = tbench.evaluate_model(predict, [as_torch(b) for b in data])
    for key in ("mse", "physics_correlation"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    got_cv = tbench.evaluate_traditional_cv3d([as_torch(b) for b in data])
    want_cv = jbench.evaluate_traditional_cv3d([as_jax(b) for b in data])
    assert {k: v["mse"] for k, v in got_cv.items()} == {k: v["mse"] for k, v in want_cv.items()}
    monkeypatch.setattr(tbench, "have_cv2", lambda: False)  # cv2 absent
    persistence = tbench.evaluate_traditional_cv3d([as_torch(b) for b in data])
    assert persistence == {"Persistence": want_cv["Persistence"]}
