"""The port's serving slice as a whole against the JAX package's, on the CPU.

`python -m smokephysai_tpu_torch.inference --save_attention` runs once on a
small model (the serving config's bf16 + flash + fast_math options at two
layers of width 64) and a 64^2 grid: it simulates the 20-frame test
sequence, predicts the 19 next frames in one batched forward, takes layer
0's attention on the first frame and hands them to the figure writer. The JAX
side simulates with its fused Pallas step (interpret mode) and runs its
model with the same weights. Both get the same chaos fields and the same
fractal field, so what is compared is the port. The JAX model runs its
einsum attention, the plain form of its flash kernel (which
tests/test_torch_attention.py holds the port's flash against).
"""
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
from smokephysai_tpu.physics.simulator import SmokeSimulator as JaxSimulator
from smokephysai_tpu_torch import inference
from smokephysai_tpu_torch.models.net import SmokePhysNet
from smokephysai_tpu_torch.physics import simulator as tsimulator
from test_torch_model import SMALL, random_variables

GRID = 64
SERVING = os.path.join(os.path.dirname(__file__), "..", "config", "config_serving.yaml")


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    rng = np.random.default_rng(0)
    tmp = tmp_path_factory.mktemp("slice")
    variables = random_variables(rng, **SMALL)
    flat = {f"{col}/{keystr(p)}": np.asarray(leaf)
            for col, tree in variables.items()
            for p, leaf in tree_flatten_with_path(tree)[0]}
    npz = str(tmp / "small.npz")
    np.savez(npz, **flat)
    with open(SERVING) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(SMALL)
    cfg["data"]["grid_size"] = cfg["simulation"]["grid_size"] = [GRID, GRID]
    cfg_path = str(tmp / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    jsim = JaxSimulator(grid_size=(GRID, GRID), use_pallas=True)
    fractal = np.array(jsim._fractal)
    fields = [(3.0 * rng.standard_normal((19, 1024, 3))).astype(np.float32)
              for _ in range(SMALL["num_layers"])]

    captured = {}

    def capture(sequence, outputs, output_dir):
        captured.update(sequence=sequence, outputs=outputs, output_dir=output_dir)

    out_dir = str(tmp / "out")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsimulator, "fractal_field",
                   lambda shape, device="cpu": torch.from_numpy(fractal).to(device))
        mp.setattr(SmokePhysNet, "chaos_fields",
                   lambda self, gen, batch, device: [torch.from_numpy(f[:batch])
                                                     for f in fields])
        mp.setattr(inference, "save_figures", capture)
        inference.main(["--config", cfg_path, "--checkpoint", npz,
                        "--output_dir", out_dir, "--device", "cpu", "--save_attention"])

    # the JAX package's serving path on the same inputs
    jsim.reset()
    jsim.add_incense_source(inference.TEST_POSITIONS, inference.TEST_INTENSITIES)
    jseq = np.stack([np.asarray(jsim.simulate_step()) for _ in range(20)])
    # the JAX model's einsum attention (the plain form of its flash kernel;
    # interpret-mode Pallas at B=19 would take most of this file's time)
    jmodel = JaxNet(**SMALL, dtype=jnp.bfloat16, use_flash=False, fast_math=True)
    calls = {"i": 0}
    orig = jca.chaos_field

    def injected(key, batch, seq_len):
        calls["i"] += 1
        return jnp.asarray(fields[calls["i"] - 1])

    jca.chaos_field = injected
    try:
        jout = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, rngs={"chaos": jax.random.PRNGKey(0)}
        ))(variables, jnp.asarray(jseq[:-1, ..., None]))
    finally:
        jca.chaos_field = orig
    return {"captured": captured, "out_dir": out_dir, "jseq": jseq,
            "jout": {k: np.asarray(v, np.float32) for k, v in jout.items()},
            "cfg_path": cfg_path, "npz": npz}


def test_cli_writes_figures(slice_run, tmp_path):
    """The CLI hands its sequence and outputs to `save_figures` (replaced
    by a capture in the fixture); the figures themselves are drawn here
    from the first five frames, which is quicker than nineteen."""
    cap = slice_run["captured"]
    assert cap["output_dir"] == slice_run["out_dir"]
    outputs = {k: v[:4] for k, v in cap["outputs"].items()}
    inference.save_figures(cap["sequence"][:5], outputs, str(tmp_path))
    for name in ("ground_truth.png", "predictions.png", "physics_features.png",
                 "comparison.png", "attention_maps.png"):
        assert os.path.getsize(os.path.join(tmp_path, name)) > 0


def test_slice_sequence_matches_jax(slice_run):
    """The 20 recorded frames: atol 2e-5 / rtol 1e-4, as the solver tests."""
    seq = torch.stack(slice_run["captured"]["sequence"]).numpy()
    assert seq.shape == (20, GRID, GRID)
    np.testing.assert_allclose(seq, slice_run["jseq"], atol=2e-5, rtol=1e-4)


def test_slice_forward_matches_jax(slice_run):
    """The bf16 + flash + fast_math forward on the 19 input frames: within
    2e-2 (a few bf16 ulps of outputs in [0, 1] and of the physics head)."""
    out = slice_run["captured"]["outputs"]
    jout = slice_run["jout"]
    assert out["reconstructed"].shape == (19, GRID, GRID, 1)
    for key in ("reconstructed", "physics_features", "latent_features"):
        np.testing.assert_allclose(out[key].float().numpy(), jout[key],
                                   atol=2e-2, rtol=0, err_msg=key)


def test_save_attention_is_refused(slice_run):
    """`--save_attention` was refused until the port's attention capture
    existed; now the CLI (the fixture's run) hands layer 0's probabilities
    on the first input frame to the figure writer: [1, heads, 1024, 1024],
    bf16 rows summing to 1 within bf16 rounding of 1024 terms
    (test_cli_writes_figures draws them into attention_maps.png)."""
    attn = slice_run["captured"]["outputs"]["attention_weights"]
    assert attn.shape == (1, SMALL["num_heads"], 1024, 1024)
    np.testing.assert_allclose(attn.float().sum(-1).numpy(), 1.0, atol=1e-2)
