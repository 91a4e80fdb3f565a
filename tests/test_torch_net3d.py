"""The port's SmokePhysNet3D, its layers, its resize, its converter and its
serving entry points against the JAX package's, on the CPU.

The JAX variables come from `jax.eval_shape(init)` filled with numpy draws
(as tests/test_torch_model.py does), carried across with
`jax_variables_to_state_dict`; inputs and per-layer chaos fields are made
with numpy from a seed and injected into both models. Tolerances are
stated per test.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
import smokephysai_tpu.models.chaos_attention as jca
from smokephysai_tpu.models import net3d as jnet3d
from smokephysai_tpu_torch.models.convert import (
    jax_variables_to_state_dict,
    load_npz_variables,
    model_to_flat_variables,
    save_npz_variables,
)
from smokephysai_tpu_torch.models.layers import Conv3D, ConvTranspose3D2x
from smokephysai_tpu_torch.models.net3d import SmokePhysNet3D
from smokephysai_tpu_torch.ops.image import resize_trilinear
from smokephysai_tpu_torch.train.serving import (
    build_model,
    load_model,
    make_chunked_predictor,
    make_predictor,
)
from smokephysai_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config", "config_128cubed.yaml")
CHECKPOINT = os.path.join(ROOT, "checkpoints", "smokephysnet3d_128cubed.npz")
SMALL = dict(hidden_dim=64, num_layers=2, num_heads=4, output_channels=8)


def random_variables(rng, **model):
    """Variables of a JAX SmokePhysNet3D, shaped by `init` through
    jax.eval_shape and filled at a trained model's scale."""
    shapes = jax.eval_shape(
        jnet3d.SmokePhysNet3D(**model).init,
        {"params": jax.random.PRNGKey(0), "chaos": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16, 16, 16, 1)),
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
        if name.endswith("['weight']"):  # transposed conv: fan C_out * 64
            fan = s.shape[1] * 64
        elif name.endswith("['kernel']"):
            fan = int(np.prod(s.shape[:-1]))
        else:
            fan = 64
        return rng.uniform(-fan**-0.5, fan**-0.5, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(0)
    return {
        "variables": random_variables(rng, **SMALL),
        "x": rng.random((2, 16, 16, 16, 1)).astype(np.float32),
        "fields": [(3.0 * rng.standard_normal((2, 512, 3))).astype(np.float32)
                   for _ in range(SMALL["num_layers"])],
    }


def _jax_forward(variables, x, fields, **model):
    calls = {"i": 0}
    orig = jca.chaos_field

    def injected(key, batch, seq_len):
        f = jnp.asarray(fields[calls["i"]][:, :seq_len])
        calls["i"] += 1
        return f

    jca.chaos_field = injected
    try:
        m = jnet3d.SmokePhysNet3D(**model)
        out = jax.jit(lambda v, xx: m.apply(
            v, xx, train=False, return_features=True,
            rngs={"chaos": jax.random.PRNGKey(0)}))(variables, jnp.asarray(x))
    finally:
        jca.chaos_field = orig
    assert calls["i"] == len(fields)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.mark.parametrize("sizes", [(8, 16), (16, 8), (64, 16)], ids=["8to16", "16to8", "64to16"])
def test_resize_matches_jax_image_resize(sizes):
    """`resize_trilinear` against jax.image.resize(method='trilinear'),
    upsampling and (antialiased) downsampling, atol 1e-6 (float32
    contractions in another order)."""
    n, m = sizes
    x = np.random.default_rng(n + m).random((2, n, n, n, 1)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, m, m, m, 1), method="trilinear"))
    got = resize_trilinear(torch.from_numpy(x).permute(0, 4, 1, 2, 3), (m, m, m))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, atol=1e-6)


def test_conv3d_and_transposed_conv_match_jax():
    """Conv3D (DHWIO kernel, symmetric padding) and ConvTranspose3D2x
    (torch-layout weight, k 4, s 2, p 1) against the JAX modules with the
    same parameters, atol 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 5, 4, 3)).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    fill = lambda a: rng.standard_normal(a.shape).astype(np.float32)
    jc = jnet3d.Conv3D(7, 3, padding=1)
    cv = jax.tree_util.tree_map(fill, jax.eval_shape(jc.init, jax.random.PRNGKey(0), x))
    tc = Conv3D(3, 7, 3, padding=1)
    tc.weight.data = torch.from_numpy(cv["params"]["kernel"].transpose(4, 3, 0, 1, 2).copy())
    tc.bias.data = torch.from_numpy(cv["params"]["bias"])
    np.testing.assert_allclose(tc(tx).permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(jax.jit(jc.apply)(cv, x)), atol=1e-5)
    jt = jnet3d.ConvTranspose3D2x(5)
    tv = jax.tree_util.tree_map(fill, jax.eval_shape(jt.init, jax.random.PRNGKey(0), x))
    tt = ConvTranspose3D2x(3, 5)
    tt.weight.data = torch.from_numpy(tv["params"]["weight"])
    tt.bias.data = torch.from_numpy(tv["params"]["bias"])
    got = tt(tx).permute(0, 2, 3, 4, 1).detach().numpy()
    assert got.shape == (2, 12, 10, 8, 5)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jt.apply)(tv, x)), atol=1e-5)


def test_small_model_matches_jax_eval_forward(small):
    """SmokePhysNet3D (16^3 input, hidden 64, 2 layers, 4 heads) against the
    JAX eval forward with the same variables and injected chaos fields:
    outputs atol 1e-4, token features 1e-3 (as test_torch_model.py holds
    the 2D model). The same model with `use_flash` (here the flash plain
    version, head_dim 16) and built in float64 agrees with it within 1e-5."""
    want = _jax_forward(small["variables"], small["x"], small["fields"], **SMALL)
    sd = jax_variables_to_state_dict(small["variables"])
    x = torch.from_numpy(small["x"])
    fields = [torch.from_numpy(f) for f in small["fields"]]
    outs = {}
    for tag, kw in (("einsum", {}), ("flash", {"use_flash": True}),
                    ("float64", {"dtype": torch.float64})):
        model = SmokePhysNet3D(**SMALL, **kw)
        if tag == "float64":
            model = model.double()
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs[tag] = model.eval()(x.to(model.dtype), chaos_fields=fields,
                                     return_features=True)
    got = outs["einsum"]
    assert got["reconstructed"].shape == (2, 16, 16, 16, 1)
    for k in ("reconstructed", "physics_features", "latent_features"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["intermediate_features"].numpy(),
                               want["intermediate_features"], atol=1e-3)
    for tag in ("flash", "float64"):
        for k in ("reconstructed", "physics_features"):
            np.testing.assert_allclose(outs[tag][k].float().numpy(), got[k].numpy(),
                                       atol=1e-5, err_msg=f"{tag} {k}")


def test_real_checkpoint_loads_into_the_full_width_model():
    """`load_model` builds SmokePhysNet3D from config_128cubed.yaml (hidden
    256, 4 layers, 8 heads, 32 output channels) and loads
    smokephysnet3d_128cubed.npz with strict=True: 121 arrays, 3,456,416
    values. No forward."""
    config = load_config(CONFIG)
    model = load_model(config, CHECKPOINT, device="cpu")
    assert isinstance(model, SmokePhysNet3D) and not model.training
    flat = np.load(CHECKPOINT)
    assert len(flat.files) == 121
    assert sum(flat[k].size for k in flat.files) == 3_456_416
    sd = model.state_dict()
    assert sum(v.numel() for v in sd.values()) == 3_456_416
    np.testing.assert_array_equal(
        sd["enc_conv1.weight"].numpy(),
        flat["params/['enc_conv1']['kernel']"].transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sd["up2.weight"].numpy(), flat["params/['up2']['weight']"])
    assert model.layer_0.chaos_attention.num_heads == 8


def test_converter_round_trips_a_3d_model(tmp_path, small):
    """`model_to_flat_variables` gives the JAX export's keys and layouts
    back (DHWIO conv kernels, torch-layout transposed-conv weights,
    BatchNorm_0 levels), and `save_npz_variables` -> `load_npz_variables`
    -> `jax_variables_to_state_dict` restores every tensor exactly."""
    sd = jax_variables_to_state_dict(small["variables"])
    model = SmokePhysNet3D(**SMALL)
    model.load_state_dict(sd, strict=True)
    flat = model_to_flat_variables(model)
    p = small["variables"]["params"]
    np.testing.assert_array_equal(flat["params/['enc_conv2']['kernel']"],
                                  p["enc_conv2"]["kernel"])
    np.testing.assert_array_equal(flat["params/['up3']['weight']"], p["up3"]["weight"])
    np.testing.assert_array_equal(
        flat["batch_stats/['up_bn1']['BatchNorm_0']['var']"],
        small["variables"]["batch_stats"]["up_bn1"]["BatchNorm_0"]["var"])
    path = save_npz_variables(model, str(tmp_path / "m3d.npz"))
    back = jax_variables_to_state_dict(load_npz_variables(path))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_chunked_predictor_equals_one_full_batch(small):
    """At chaos_strength 0 a batch of 5 volumes run in chunks of 1, 2, 3
    (a padded tail) and 7 (one call) equals one full-batch call, atol 1e-6
    (as tests/test_eval.py's TestChunkedPredictor holds the JAX wrapper)."""
    config = {"data": {"grid_size": [16, 16, 16]},
              "model": {**SMALL, "chaos_strength": 0.0}, "tpu": {}}
    model = build_model(config, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(small["variables"]), strict=True)
    predict = make_predictor(model, chaos_seed=0)
    x = torch.from_numpy(np.random.default_rng(2).random((5, 16, 16, 16, 1)).astype(np.float32))
    full = predict(x)
    for chunk in (1, 2, 3, 7):
        out = make_chunked_predictor(predict, chunk)(x)
        assert out.keys() == full.keys()
        for k in full:
            torch.testing.assert_close(out[k], full[k], atol=1e-6, rtol=1e-5,
                                       msg=f"{k} chunk={chunk}")
