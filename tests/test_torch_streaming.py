"""The port's streaming path against the JAX package's, on the CPU: the
rollout and the single streaming step (the per-op solver on both sides, as
tests/test_streaming.py runs the JAX ones), the model's `fast_encoder`, and
the stream CLI.

The JAX variables come from `jax.eval_shape(init)` filled with numpy draws
and carried across with `jax_variables_to_state_dict`; the per-layer chaos
fields are made with numpy from a seed and injected into both packages.
The JAX and port fractal fields differ on a few boundary pixels (XLA's
`linspace`; ROADMAP "Mandelbrot grid"), so the port's rollout is handed the
JAX package's fractal. Tolerances are stated per test.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
import smokephysai_tpu.models.chaos_attention as jca
from smokephysai_tpu.models import SmokePhysNet as JaxNet
from smokephysai_tpu.physics import add_smoke_source as jadd_source
from smokephysai_tpu.physics import init_state as jinit_state
from smokephysai_tpu.physics.fractal import fractal_field as jfractal_field
from smokephysai_tpu.train import streaming as jstreaming
from smokephysai_tpu_torch import stream as stream_cli
from smokephysai_tpu_torch.models.convert import jax_variables_to_state_dict, save_npz_variables
from smokephysai_tpu_torch.models.net import SmokePhysNet
from smokephysai_tpu_torch.physics.solver import add_smoke_source, init_state
from smokephysai_tpu_torch.train import streaming
from smokephysai_tpu_torch.train.loop import build_train_model, init_parameters
from smokephysai_tpu_torch.train.serving import build_model

# tests/test_streaming.py's model: hidden 64, 1 layer, 4 heads, 64^2 frames
SMALL = dict(input_dim=32, hidden_dim=64, num_layers=1, num_heads=4, output_channels=16)
GRID = (64, 64)
FRAMES = 3
VORT_EPS = 2.0  # the streaming step's confinement (the rollout has none)


def random_variables(rng):
    """Variables of the small JAX SmokePhysNet, shaped by `init` through
    jax.eval_shape and filled at an initialised model's scale."""
    shapes = jax.eval_shape(
        JaxNet(**SMALL).init,
        {"params": jax.random.PRNGKey(0), "chaos": jax.random.PRNGKey(1)},
        jnp.zeros((1, *GRID, 1)))

    def fill(path, s):
        name = keystr(path)
        if name.endswith("['mean']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "pos_embedding" in name:
            return rng.standard_normal(s.shape).astype(np.float32)
        fan = s.shape[1] * 16 if name.endswith("['weight']") else int(np.prod(s.shape[:-1]))
        return rng.uniform(-fan ** -0.5, fan ** -0.5, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inject(fields):
    """Context for the JAX model: `chaos_field` returns the given per-layer
    fields in call order (the trace of one frame calls it once a layer)."""
    calls = {"i": 0}

    def injected(key, batch, seq_len):
        f = jnp.asarray(fields[calls["i"] % len(fields)][:, :seq_len])
        calls["i"] += 1
        return f

    class Ctx:
        def __enter__(self):
            self.orig = jca.chaos_field
            jca.chaos_field = injected
            return calls

        def __exit__(self, *exc):
            jca.chaos_field = self.orig

    return Ctx()


def _jax_state():
    s = jinit_state(GRID)
    return s.replace(density=jadd_source(s.density, 32.0, 32.0, radius=8.0, intensity=1.5))


def _port_state():
    s = init_state(GRID, device="cpu")
    return s.replace(density=add_smoke_source(s.density, 32.0, 32.0, radius=8.0,
                                              intensity=1.5))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX rollout, three JAX streaming steps (with confinement and the
    reconstruction) and the `fast_encoder` eval forward of a 64^2 frame, of
    the small model on seeded variables and chaos fields, as numpy; the
    three traced under one jit, so one compile. A chaos seed no other test
    uses keeps the module-level jit cache from serving a trace made without
    the injected fields."""
    rng = np.random.default_rng(11)
    variables = random_variables(rng)
    fields = [(3.0 * rng.standard_normal((1, 1024, 3))).astype(np.float32)
              for _ in range(SMALL["num_layers"])]
    x = rng.random((1, *GRID, 1)).astype(np.float32)
    model, fast = JaxNet(**SMALL), JaxNet(**SMALL, fast_encoder=True)

    def run(variables, x):
        state = _jax_state()
        _, rollout = jstreaming.streaming_rollout(model, variables, state,
                                                  num_frames=FRAMES, use_pallas=False,
                                                  chaos_seed=1234)
        step = jstreaming.make_streaming_step(model, variables, use_pallas=False,
                                              vorticity_eps=VORT_EPS, chaos_seed=1234)
        _, steps = jax.lax.scan(lambda s, _: step(s), state, None, length=FRAMES)
        encoded = fast.apply(variables, x, train=False, rngs={"chaos": jax.random.PRNGKey(0)})
        return rollout, steps, encoded

    with _inject(fields) as calls:
        out = jax.jit(run)(variables, jnp.asarray(x))
        # one trace each of the rollout's frame, the step and the fast forward
        assert calls["i"] == 3 * SMALL["num_layers"]
    rollout, steps, encoded = jax.tree_util.tree_map(np.asarray, out)
    return {"variables": variables, "fields": fields, "rollout": rollout, "steps": steps,
            "x": x, "fast": encoded, "fractal": np.array(jfractal_field(GRID))}


def _port_model(jax_runs, **opts):
    model = SmokePhysNet(**SMALL, **opts)
    model.load_state_dict(jax_variables_to_state_dict(jax_runs["variables"]))
    return model.eval()


def test_rollout_matches_jax(jax_runs, monkeypatch):
    """`streaming_rollout` over 3 frames at 64^2 against the JAX rollout,
    the same variables, chaos fields and fractal: frames atol 1e-5 (the
    per-op solver, as tests/test_torch_solver.py holds it, three steps),
    physics features atol 1e-4 (the eval forward, as
    tests/test_torch_model.py holds it)."""
    monkeypatch.setattr(streaming, "fractal_field",
                        lambda grid, device: torch.from_numpy(jax_runs["fractal"]).to(device))
    fields = [torch.from_numpy(f) for f in jax_runs["fields"]]
    _, outs = streaming.streaming_rollout(_port_model(jax_runs), _port_state(), FRAMES,
                                          use_pallas=False, chaos_fields=fields)
    want = jax_runs["rollout"]
    assert outs["frame"].shape == (FRAMES, *GRID) and outs["physics_features"].shape == (FRAMES, 3)
    np.testing.assert_allclose(outs["frame"].numpy(), want["frame"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(outs["physics_features"].numpy(), want["physics_features"],
                               atol=1e-4, rtol=0)


def test_streaming_step_matches_jax(jax_runs, monkeypatch):
    """`make_streaming_step` with vorticity confinement and the
    reconstruction against three JAX streaming steps: frames atol 1e-5,
    physics features and the reconstruction (resized to the grid) atol
    1e-4."""
    monkeypatch.setattr(streaming, "fractal_field",
                        lambda grid, device: torch.from_numpy(jax_runs["fractal"]).to(device))
    fields = [torch.from_numpy(f) for f in jax_runs["fields"]]
    step = streaming.make_streaming_step(_port_model(jax_runs), use_pallas=False,
                                         vorticity_eps=VORT_EPS, chaos_fields=fields)
    s, want = _port_state(), jax_runs["steps"]
    for t in range(FRAMES):
        s, out = step(s)
        assert set(out) == set(want) == {"physics_features", "frame", "reconstructed"}
        np.testing.assert_allclose(out["frame"].numpy(), want["frame"][t], atol=1e-5, rtol=0,
                                   err_msg=f"frame {t}")
        for k in ("physics_features", "reconstructed"):
            np.testing.assert_allclose(out[k].numpy(), want[k][t], atol=1e-4, rtol=0,
                                       err_msg=f"{k} {t}")


def test_step_and_rollout_agree_and_chaos_is_drawn_once():
    """Port-side: the rollout equals the streaming step run frame by frame
    (no confinement, features without the decoder: atol 1e-6, frames
    bit-equal); a rollout from `chaos_seed` equals one given the fields that
    seed draws once (every frame the same fields) and differs from another
    seed's."""
    model = build_model({"model": {**SMALL, "chaos_strength": 0.5}}, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(3))
    model.eval()
    _, outs = streaming.streaming_rollout(model, _port_state(), FRAMES, use_pallas=False,
                                          chaos_seed=5)
    step = streaming.make_streaming_step(model, use_pallas=False, chaos_seed=5,
                                         return_reconstruction=False)
    s = _port_state()
    for t in range(FRAMES):
        s, o = step(s)
        assert set(o) == {"physics_features", "frame"}
        assert torch.equal(o["frame"], outs["frame"][t])
        torch.testing.assert_close(o["physics_features"], outs["physics_features"][t],
                                   atol=1e-6, rtol=0)
    drawn = model.chaos_fields(torch.Generator().manual_seed(5), 1, "cpu")
    _, given = streaming.streaming_rollout(model, _port_state(), FRAMES, use_pallas=False,
                                           chaos_fields=drawn)
    assert torch.equal(given["physics_features"], outs["physics_features"])
    _, other = streaming.streaming_rollout(model, _port_state(), FRAMES, use_pallas=False,
                                           chaos_seed=6)
    assert not torch.equal(other["physics_features"], outs["physics_features"])
    with pytest.raises(ValueError, match="one episode"):
        streaming.streaming_rollout(model, init_state(GRID, device="cpu", batch=(2,)), 1)


def test_fast_encoder_matches_jax(jax_runs):
    """`fast_encoder` (input_dim 32): on 32^2 frames the model equals the
    plain encoder's bit for bit (the branch does nothing); on 64^2 frames
    it pools to 32^2 before enc_conv1 and agrees with the JAX model's
    `fast_encoder` eval forward, outputs atol 1e-4, and differs from the
    parity path (which pools after enc_conv2)."""
    x = jax_runs["x"]
    tfields = [torch.from_numpy(f) for f in jax_runs["fields"]]
    fast, plain = (_port_model(jax_runs, fast_encoder=f) for f in (True, False))
    with torch.no_grad():
        x32 = torch.from_numpy(x[:, ::2, ::2]).contiguous()
        a, b = fast(x32, chaos_fields=tfields), plain(x32, chaos_fields=tfields)
        for k in a:
            assert torch.equal(a[k], b[k]), k
        got = fast(torch.from_numpy(x), chaos_fields=tfields)
        parity = plain(torch.from_numpy(x), chaos_fields=tfields)
    assert got["reconstructed"].shape == (1, *GRID, 1)
    for k in ("reconstructed", "physics_features", "latent_features"):
        np.testing.assert_allclose(got[k].numpy(), jax_runs["fast"][k], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert float((got["latent_features"] - parity["latent_features"]).abs().max()) > 1e-3


def test_build_model_reads_fast_encoder():
    """`build_model` takes `tpu.fast_encoder` (the 2D model's) and still
    refuses the sequence- and pipeline-parallel trunks; the training model
    never pools first, as the JAX package's `create_train_state`."""
    config = {"model": {**SMALL, "chaos_strength": 0.1}, "tpu": {"fast_encoder": True}}
    assert build_model(config, device="cpu").fast_encoder
    assert not build_train_model(config, device="cpu").fast_encoder
    for key in ("ring_axis", "pipeline_axis"):
        with pytest.raises(NotImplementedError, match=key):
            build_model({**config, "tpu": {key: "space"}}, device="cpu")


def _small_config(tmp_path):
    path = tmp_path / "stream_small.yaml"
    path.write_text(json.dumps({  # JSON is YAML
        "data": {"grid_size": list(GRID)}, "simulation": {"grid_size": list(GRID)},
        "model": {**SMALL, "chaos_strength": 0.1}, "tpu": {"compute_dtype": "float32"}}))
    return str(path)


def test_stream_cli_writes_its_outputs(tmp_path, monkeypatch, capsys):
    """`python -m smokephysai_tpu_torch.stream` on the CPU at 64^2 with a
    small model: from an npz checkpoint it writes physics_features.npy [T,
    3], frames.npy [T, 16, 16] (downsample 4), summary.json with the JAX
    CLI's keys and evolution.png; its features equal `streaming_rollout`
    of the same model from the same source (the CLI's default radius
    max(8, grid/32) at the centre); without a checkpoint it runs random
    weights, and without matplotlib (made unimportable, as on a machine
    that lacks it) it says that it skipped the plot; `--mesh_space 2` is
    refused, naming the roadmap item."""
    config = _small_config(tmp_path)
    model = build_model({"model": {**SMALL, "chaos_strength": 0.1}}, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(4))
    ckpt = save_npz_variables(model, str(tmp_path / "small.npz"))
    out = tmp_path / "out"
    base = ["--config", config, "--frames", str(FRAMES), "--device", "cpu"]
    summary = stream_cli.main(base + ["--checkpoint", ckpt, "--output_dir", str(out)])
    assert set(summary) == {"frames", "grid", "fps_including_compile", "mesh_space",
                            "checkpoint"}
    assert json.loads((out / "summary.json").read_text()) == summary
    feats = np.load(out / "physics_features.npy")
    frames = np.load(out / "frames.npy")
    assert feats.shape == (FRAMES, 3) and frames.shape == (FRAMES, 16, 16)
    assert (out / "evolution.png").exists()
    _, want = streaming.streaming_rollout(model.eval(), _port_state(), FRAMES)
    np.testing.assert_array_equal(feats, want["physics_features"].numpy())
    np.testing.assert_array_equal(frames, want["frame"][:, ::4, ::4].numpy())

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    rand = stream_cli.main(base + ["--output_dir", str(tmp_path / "rand"), "--downsample", "8",
                                   "--source_radius", "5"])
    assert rand["checkpoint"] is None
    assert np.load(tmp_path / "rand" / "frames.npy").shape == (FRAMES, 8, 8)
    assert np.isfinite(np.load(tmp_path / "rand" / "physics_features.npy")).all()
    assert not (tmp_path / "rand" / "evolution.png").exists()
    assert "skipping evolution plot" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A.10"):
        stream_cli.main(base + ["--mesh_space", "2"])
