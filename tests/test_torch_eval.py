"""The port's evaluation layer (`eval/robustness.py`, `eval/perturbation.py`),
its evaluate CLI and the attention capture behind `--save_attention`, against
the JAX package's, on the CPU.

One small model at 32^2 (tests/test_torch_model.py's widths), its variables
from `jax.eval_shape` filled with numpy draws, on both sides. The sections
run it at chaos strength 0, so the chaos fields do not enter them (the
benchmark tests and the card's gate hold the port's predictor under the
JAX CLI's fields); the attention test runs it at its chaos strength with
the JAX model's chaos draws injected. Where JAX draws with `jax.random` for
a section (the Gaussian noise, the scenarios' sources), the test injects
JAX's draws into the port by replacing the port's draw functions.
Tolerances are stated per test.
"""
import json
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
from smokephysai_tpu.data.synthetic import sample_source_params as jax_sources
from smokephysai_tpu.eval import PerturbationTester as JaxTester
from smokephysai_tpu.eval import RobustnessEvaluator as JaxEvaluator
from smokephysai_tpu.models import SmokePhysNet as JaxNet
from smokephysai_tpu_torch import evaluate as tevaluate
from smokephysai_tpu_torch.eval import PerturbationTester, RobustnessEvaluator
from smokephysai_tpu_torch.eval import perturbation as tperturbation
from smokephysai_tpu_torch.models.net import SmokePhysNet
from smokephysai_tpu_torch.train.serving import make_predictor
from smokephysai_tpu_torch.utils.config import load_config
from smokephysai_tpu_torch.utils.visualization import SmokeVisualizer
from test_torch_benchmark import jax_predictor, port_model
from test_torch_model import SMALL, random_variables

N = 4  # episodes (frames) per section
GRID = (32, 32)


@pytest.fixture(scope="module")
def setup():
    """The small model at chaos strength 0 on both sides, N smoke-like
    frames and their next frames, chaos labels, and the chaos draws the
    JAX predictor makes at batch N."""
    rng = np.random.default_rng(0)
    variables = random_variables(rng, **SMALL)
    yy, xx = np.mgrid[:GRID[0], :GRID[1]]
    centres = rng.uniform(8, 24, (N, 2, 1, 1))
    frames = np.exp(-((yy - centres[:, 0]) ** 2 + (xx - centres[:, 1]) ** 2) / 30.0)
    x = frames[..., None].astype(np.float32)
    y = (0.97 * np.roll(frames, 1, axis=1))[..., None].astype(np.float32)
    jpredict, drawn = jax_predictor(JaxNet(**SMALL, chaos_strength=0.0), variables)
    jpredict(jnp.asarray(x))  # records the JAX draws at batch N
    model = port_model(SmokePhysNet, variables, **SMALL, chaos_strength=0.0)
    return {"variables": variables, "x": x, "y": y, "jpredict": jpredict, "drawn": drawn,
            "chaos": rng.standard_normal((N, 3)).astype(np.float32),
            "predict": make_predictor(model)}


def test_physics_consistency_matches_jax(setup):
    """Per-feature MAE within 1e-5 relative (float32 forwards)."""
    targets = {"lyapunov": setup["chaos"][:, 0], "fractal_dimension": setup["chaos"][:, 1],
               "entropy": setup["chaos"][:, 2]}
    want = JaxEvaluator().evaluate_physics_consistency(
        setup["jpredict"], jnp.asarray(setup["x"]), targets)
    got = RobustnessEvaluator().evaluate_physics_consistency(
        setup["predict"], torch.from_numpy(setup["x"]), targets)
    assert set(got) == {"lyapunov_mae", "fractal_mae", "entropy_mae"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_reconstruction_matches_jax(setup):
    """SSIM, PSNR and MSE of the predicted next frames within 1e-5
    relative."""
    want = JaxEvaluator().evaluate_reconstruction_quality(
        setup["jpredict"], jnp.asarray(setup["x"]), jnp.asarray(setup["y"]))
    got = RobustnessEvaluator().evaluate_reconstruction_quality(
        setup["predict"], torch.from_numpy(setup["x"]), torch.from_numpy(setup["y"]))
    for key in ("ssim", "psnr", "mse"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_gaussian_noise_matches_jax(setup, monkeypatch):
    """With JAX's noise injected (its N(0, 1) draws from fold_in(key, i),
    one per level, in place of the port's generator): the feature
    stability within 1e-6 absolute (a cosine near 1) and the
    reconstruction MSE within 1e-4 relative plus 1e-11 absolute: at level
    0.01 that MSE is ~1.5e-12, the square of output changes of ~1e-6,
    which float32 rounding of the two sides' outputs (~1e-7 apart) moves
    by ~2e-13."""
    key = jax.random.PRNGKey(3)
    levels = (0.01, 0.2)
    draws = iter([torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), setup["x"].shape))) for i in range(len(levels))])
    monkeypatch.setattr(tperturbation, "unit_noise", lambda gen, shape, device: next(draws))
    want = JaxTester().gaussian_noise_test(setup["jpredict"], jnp.asarray(setup["x"]),
                                           noise_levels=levels, key=key)
    got = PerturbationTester().gaussian_noise_test(setup["predict"],
                                                   torch.from_numpy(setup["x"]),
                                                   noise_levels=levels)
    assert set(got) == {"gaussian_0.01", "gaussian_0.2"}
    for level, r in want.items():
        np.testing.assert_allclose(got[level]["feature_stability"], r["feature_stability"],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[level]["reconstruction_mse"],
                                   r["reconstruction_mse"], rtol=1e-4, atol=1e-11)


def test_adversarial_matches_jax_at_chaos_strength_0(setup):
    """PGD (2 steps of epsilon 0.05 / 2) at chaos strength 0, through
    `torch.autograd` against `jax.grad`: delta moves by epsilon / steps
    along sign(g), and sign(g) may differ where g is within float32
    rounding of 0, each such element changing |delta| by up to 0.05. So
    the norm is held within 2 % relative and the feature stability within
    1e-5 absolute."""
    want = JaxTester().adversarial_test(setup["jpredict"], jnp.asarray(setup["x"]),
                                        epsilon=0.05, num_steps=2)
    got = PerturbationTester().adversarial_test(setup["predict"], torch.from_numpy(setup["x"]),
                                                epsilon=0.05, num_steps=2)
    assert got["adversarial_perturbation_norm"] > 0
    np.testing.assert_allclose(got["adversarial_perturbation_norm"],
                               want["adversarial_perturbation_norm"], rtol=2e-2)
    np.testing.assert_allclose(got["adversarial_feature_stability"],
                               want["adversarial_feature_stability"], atol=1e-5, rtol=0)


def test_physics_scenarios_match_jax(setup, monkeypatch):
    """4 scenarios x T = 12 at 32^2: the JAX test's sources (drawn from its
    key) injected into the port, both simulated by the plain per-op
    solver, the 48 frames predicted in one chunk. Stability within 1e-4
    relative."""
    key = jax.random.PRNGKey(4)
    params = jax_sources(key, 4, GRID)
    monkeypatch.setattr(tperturbation, "sample_source_params", lambda gen, n, grid: {
        k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    want = JaxTester().physics_perturbation_test(setup["jpredict"], grid_size=GRID,
                                                 num_tests=4, num_steps=12, key=key)
    got = PerturbationTester().physics_perturbation_test(setup["predict"], grid_size=GRID,
                                                         num_tests=4, num_steps=12,
                                                         device="cpu")
    assert got["num_tests"] == 4
    np.testing.assert_allclose(got["physics_prediction_stability"],
                               want["physics_prediction_stability"], rtol=1e-4)


def test_run_evaluation_sections_and_partial_file(setup, tmp_path):
    """The evaluate CLI end to end on the small model's checkpoint at 32^2:
    only the sections asked for, the partial report written after each
    section (read as the next stage starts), the final report without the
    partial flag, and an unknown section refused."""
    flat = {f"{col}/{keystr(p)}": np.asarray(leaf)
            for col, tree in setup["variables"].items()
            for p, leaf in tree_flatten_with_path(tree)[0]}
    npz = str(tmp_path / "small.npz")
    np.savez(npz, **flat)
    cfg = {"model": dict(SMALL), "data": {"grid_size": list(GRID), "sequence_length": 12},
           "simulation": {"grid_size": list(GRID)}}
    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = str(tmp_path / "report.json")
    seen = {}

    def progress(stage):
        if os.path.exists(out):
            with open(out) as f:
                seen[stage] = json.load(f)

    config = load_config(cfg_path)
    report = tevaluate.run_evaluation(
        config, npz, num_samples=3, num_physics_tests=2, partial_path=out,
        sections={"physics_consistency", "reconstruction"}, device="cpu", progress=progress)
    assert set(report) == {"physics_consistency", "reconstruction"}
    assert seen["reconstruction"] == {"partial": True,
                                      "physics_consistency": report["physics_consistency"]}
    assert all(np.isfinite(v) for r in report.values() for v in r.values())
    report = tevaluate.main(["--config", cfg_path, "--checkpoint", npz, "--num_samples", "3",
                             "--sections", "gaussian_noise", "--output", out,
                             "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == report
    assert set(report["gaussian_noise"]) == {f"gaussian_{lv}" for lv in (0.01, 0.05, 0.1, 0.2)}
    with pytest.raises(ValueError, match="unknown sections"):
        tevaluate.run_evaluation(config, npz, 3, sections={"robustness"}, device="cpu")


def test_attention_capture_matches_jax_sown_weights(setup, tmp_path):
    """Layer 0's attention probabilities from the port's einsum path (taken
    even with `use_flash`) against the JAX model's sown `attn_weights`, the
    same chaos field injected: within 1e-6 absolute (float32 softmax
    outputs in [0, 1]); then the attention figure is written."""
    x0 = setup["x"][:1]
    field = setup["drawn"][N][:, :1].numpy()  # the JAX draws of the first sample
    fields = np.tile(field, (1, 1, 1024 // 5 + 1, 1))[:, :, :1024]
    calls = {"i": 0}
    original = jca.chaos_field

    def injected(key, batch, seq_len):
        calls["i"] += 1
        return jnp.asarray(fields[calls["i"] - 1])

    jca.chaos_field = injected
    try:
        _, state = jax.jit(lambda v, xx: JaxNet(**SMALL).apply(
            v, xx, False, False, mutable=["intermediates"],
            rngs={"chaos": jax.random.PRNGKey(0)}))(setup["variables"], jnp.asarray(x0))
    finally:
        jca.chaos_field = original
    want = np.asarray(state["intermediates"]["layer_0"]["chaos_attention"]["attn_weights"][0])
    flash = port_model(SmokePhysNet, setup["variables"], **SMALL, use_flash=True)
    with torch.inference_mode():
        got = flash.attention_weights(torch.from_numpy(x0),
                                      chaos_fields=torch.from_numpy(fields))
    assert got.shape == want.shape == (1, SMALL["num_heads"], 1024, 1024)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    path = str(tmp_path / "attention_maps.png")
    SmokeVisualizer().plot_attention_maps(got, x0, save_path=path)
    assert os.path.getsize(path) > 0
