"""The port's SmokePhysNet against the JAX package's, on the CPU.

Both get the same variables (the tree of the JAX `SmokePhysNet.init`, filled
from a seeded numpy generator, carried across with
`jax_variables_to_state_dict`), the same input made with numpy from a seed,
and the same per-layer chaos fields (injected into the JAX model the way
tests/test_torch_port.py does). Tolerances are stated per test.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
import smokephysai_tpu.models.chaos_attention as jca
from smokephysai_tpu.models import SmokePhysNet as JaxNet
from smokephysai_tpu.models.torch_port import convert_torch_state_dict, synth_torch_state
from smokephysai_tpu.ops import image as jimage
from smokephysai_tpu_torch.models.chaos_attention import chaos_field, lorenz_trajectory
from smokephysai_tpu_torch.models.convert import (
    jax_variables_to_state_dict,
    load_npz_variables,
)
from smokephysai_tpu_torch.models.net import SmokePhysNet
from smokephysai_tpu_torch.ops import image as timage
from smokephysai_tpu_torch.train.serving import build_model, load_model, make_predictor
from smokephysai_tpu_torch.utils.config import load_config

SMALL = dict(input_dim=32, hidden_dim=64, num_layers=2, num_heads=2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "model_forward_128.npz")


def random_variables(rng, **model):
    """Variables of a JAX SmokePhysNet: the tree and shapes its `init`
    gives (from jax.eval_shape, which compiles nothing), filled with numpy
    draws at a trained model's scale: uniform +-1/sqrt(fan_in) weights,
    scales near 1, BatchNorm means near 0 and variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(
        JaxNet(**model).init,
        {"params": jax.random.PRNGKey(0), "chaos": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 1)),
    )

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
        if name.endswith("['weight']"):  # transposed conv: torch fan = C_out*16
            fan = s.shape[1] * 16
        elif name.endswith("['kernel']"):
            fan = int(np.prod(s.shape[:-1]))
        else:
            fan = 64
        return rng.uniform(-fan**-0.5, fan**-0.5, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def small():
    """Variables of the small JAX model (numpy), an input, chaos fields, and
    a cache of the JAX model's outputs per configuration."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 32, 32, 1)).astype(np.float32)
    fields = [(3.0 * rng.standard_normal((2, 1024, 3))).astype(np.float32)
              for _ in range(SMALL["num_layers"])]
    return {"variables": random_variables(rng, **SMALL), "x": x, "fields": fields,
            "jax_out": {}}


def _jax_forward(model, variables, x, fields):
    calls = {"i": 0}
    orig = jca.chaos_field

    def injected(key, batch, seq_len):
        f = jnp.asarray(fields[calls["i"]][:, :seq_len])
        calls["i"] += 1
        return f

    jca.chaos_field = injected
    try:
        out = jax.jit(lambda v, xx: model.apply(
            v, xx, train=False, return_features=True,
            rngs={"chaos": jax.random.PRNGKey(0)},
        ))(variables, jnp.asarray(x))
    finally:
        jca.chaos_field = orig
    assert calls["i"] == len(fields)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def test_state_dict_conversion(small):
    sd = jax_variables_to_state_dict(small["variables"])
    model = SmokePhysNet(**SMALL)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    p = small["variables"]["params"]
    np.testing.assert_array_equal(
        sd["layer_1.chaos_attention.q_proj.weight"].numpy(),
        p["layer_1"]["chaos_attention"]["q_proj"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["enc_conv1.weight"].numpy(),
        p["enc_conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["up1.weight"].numpy(), p["up1"]["weight"])
    np.testing.assert_array_equal(
        sd["enc_bn2.running_var"].numpy(),
        small["variables"]["batch_stats"]["enc_bn2"]["BatchNorm_0"]["var"])
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize(
    "dtype,opts,tol,feat_tol",
    [
        ("f32", dict(), 1e-4, 1e-4),
        ("f32", dict(use_flash=True), 1e-4, 1e-4),
        # bf16 compute, bf16 residual stream, tanh GELU: both sides round to
        # bf16 at different places (torch's GELU and matmuls round once from
        # float32, XLA's CPU bf16 ops may not), so the bound is a few bf16
        # ulps of the outputs (spacing 2^-8 near 0.5) and of the trunk's
        # features (magnitude ~4, spacing 2^-5)
        ("bf16", dict(fast_math=True, use_flash=True), 2e-2, 0.1),
    ],
    ids=["f32-einsum", "f32-flash", "bf16-fastmath-flash"],
)
def test_forward_matches_jax(small, dtype, opts, tol, feat_tol):
    """The port's model against the JAX model's einsum attention path at the
    same dtype and fast_math: the JAX flash kernel agrees with that path to
    float32 rounding (its Pallas kernel is held against the port's flash in
    tests/test_torch_attention.py), and interpreting it here would double
    this file's time."""
    fast = opts.get("fast_math", False)
    key = (dtype, fast)
    if key not in small["jax_out"]:
        jmodel = JaxNet(**SMALL, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32,
                        fast_math=fast)
        small["jax_out"][key] = _jax_forward(jmodel, small["variables"], small["x"],
                                             small["fields"])
    jout = small["jax_out"][key]
    tmodel = SmokePhysNet(**SMALL, dtype=torch.bfloat16 if dtype == "bf16"
                          else torch.float32, **opts).eval()
    tmodel.load_state_dict(jax_variables_to_state_dict(small["variables"]))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(small["x"]),
                      chaos_fields=[torch.from_numpy(f) for f in small["fields"]],
                      return_features=True)
    assert tout["reconstructed"].shape == (2, 32, 32, 1)
    for name in ("reconstructed", "physics_features", "latent_features"):
        np.testing.assert_allclose(tout[name].float().numpy(), jout[name],
                                   atol=tol, rtol=0, err_msg=name)
    np.testing.assert_allclose(tout["intermediate_features"].float().numpy(),
                               jout["intermediate_features"], atol=feat_tol, rtol=0)


def test_image_ops_match_jax():
    """Pooling, resize (up and down) and the transposed conv, NCHW in the
    port against NHWC in the JAX package, atol 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 40, 3)).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    nchw = lambda t: t.permute(0, 2, 3, 1).numpy()
    for out_hw in ((8, 16), (7, 13)):
        np.testing.assert_allclose(
            nchw(timage.adaptive_avg_pool2d(tx, out_hw)),
            np.asarray(jimage.adaptive_avg_pool2d(jnp.asarray(x), out_hw)), atol=1e-5)
    for out_hw in ((48, 80), (10, 17)):
        np.testing.assert_allclose(
            nchw(timage.interpolate_bilinear(tx, out_hw)),
            np.asarray(jimage.interpolate_bilinear(jnp.asarray(x), out_hw)), atol=1e-5)
    w = rng.standard_normal((3, 5, 4, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(
        nchw(timage.conv_transpose_2x(tx, torch.from_numpy(w), torch.from_numpy(b))),
        np.asarray(jimage.conv_transpose_2x(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))),
        atol=1e-4)


def test_lorenz_matches_jax():
    """Same start, same Euler trajectory; the field tiles it along L."""
    key = jax.random.PRNGKey(5)
    init = 0.1 * jax.random.normal(key, (3, 3))
    jtraj = np.asarray(jca.lorenz_trajectory(key, 3))
    ttraj = lorenz_trajectory(torch.from_numpy(np.array(init)))
    np.testing.assert_allclose(ttraj.numpy(), jtraj, atol=1e-6, rtol=1e-5)
    field = chaos_field(torch.Generator().manual_seed(0), 3, 12, device="cpu")
    assert field.shape == (3, 12, 3)
    torch.testing.assert_close(field[:, 5:10], field[:, 0:5], rtol=0, atol=0)


def test_load_npz_and_predictor(small, tmp_path):
    """A flat npz export written as scripts/export_checkpoint.py writes it
    loads back with numpy alone into the JAX tree, and `load_model` +
    `make_predictor` serve it: deterministic per chaos seed."""
    flat = {}
    for col, tree in small["variables"].items():
        for path, leaf in tree_flatten_with_path(tree)[0]:
            flat[f"{col}/{keystr(path)}"] = np.asarray(leaf)
    path = str(tmp_path / "small.npz")
    np.savez_compressed(path, **flat)
    loaded = load_npz_variables(path)
    for col in ("params", "batch_stats"):
        a = tree_flatten_with_path(loaded[col])[0]
        b = tree_flatten_with_path(small["variables"][col])[0]
        assert [keystr(p) for p, _ in a] == [keystr(p) for p, _ in b]
        for (_, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x, y)

    config = load_config(None)
    config["model"].update(SMALL)
    model = load_model(config, path, device="cpu")
    assert isinstance(model, SmokePhysNet) and not model.training
    x = torch.from_numpy(small["x"])
    out1 = make_predictor(model, chaos_seed=0)(x)
    out2 = make_predictor(model, chaos_seed=0)(x)
    out3 = make_predictor(model, chaos_seed=1)(x)
    assert set(out1) == {"reconstructed", "physics_features", "latent_features"}
    assert out1["reconstructed"].shape == (2, 32, 32, 1)
    torch.testing.assert_close(out1["physics_features"], out2["physics_features"])
    assert not torch.equal(out1["physics_features"], out3["physics_features"])


def test_build_model_reads_serving_config():
    config = load_config(os.path.join(os.path.dirname(__file__), "..", "config",
                                      "config_serving.yaml"))
    config["model"].update(SMALL)
    model = build_model(config, device="cpu")
    assert model.dtype == torch.bfloat16
    assert model.layer_0.fast_math and model.layer_0.chaos_attention.use_flash
    config["tpu"]["ring_axis"] = "space"
    with pytest.raises(NotImplementedError):
        build_model(config, device="cpu")


def test_golden_forward_128():
    """The port against the torch reference's recorded full-size eval
    forward (tests/goldens/model_forward_128.npz): its weights regenerated
    from the recorded seed, carried into the JAX tree and on into the port.
    atol 1e-4 on the outputs, 1e-3 on the token features, as
    tests/test_torch_port.py holds the JAX model."""
    with np.load(GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    keys_shapes = json.loads(bytes(g["keys_shapes"]).decode())
    state = synth_torch_state({k: tuple(v) for k, v in keys_shapes.items()},
                              seed=int(g["seed"]))
    model = SmokePhysNet().eval()
    model.load_state_dict(jax_variables_to_state_dict(convert_torch_state_dict(state)))
    x = torch.from_numpy(g["input"]).permute(0, 2, 3, 1)
    with torch.no_grad():
        out = model(x, chaos_fields=[torch.from_numpy(f) for f in g["chaos_fields"]],
                    return_features=True)
    np.testing.assert_allclose(out["reconstructed"].permute(0, 3, 1, 2).numpy(),
                               g["reconstructed"], atol=1e-4, rtol=0)
    for key in ("physics_features", "latent_features"):
        np.testing.assert_allclose(out[key].numpy(), g[key], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["intermediate_features"].numpy(),
                               g["intermediate_features"], atol=1e-3, rtol=0)
