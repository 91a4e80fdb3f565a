"""The port's bridge to the reference PyTorch model's state_dict
(`smokephysai_tpu_torch/models/torch_port.py`) against the JAX package's
`models/torch_port.py`, on the CPU, with no JAX compile.

A reference-layout state is drawn by `synth_torch_state` from a seed; the
JAX package converts it to its variable tree, which `models/convert.py`
carries into the port's state_dict: the port's own conversion must give
those bits exactly, and its export the JAX export's. The full-width forward
on the reference's recorded output (tests/goldens/model_forward_128.npz) is
held at tests/test_torch_port.py's tolerances.
"""
import json
import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
from smokephysai_tpu.models import torch_port as jport
from smokephysai_tpu_torch.models import torch_port
from smokephysai_tpu_torch.models.convert import jax_variables_to_state_dict
from smokephysai_tpu_torch.models.net import SmokePhysNet

SMALL = dict(input_dim=32, hidden_dim=64, num_layers=2, num_heads=2)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "model_forward_128.npz")
SKIPPED = {"input_encoder.1.num_batches_tracked": np.array(7),
           "chaos_layers.0.chaos_attention.lorenz_sigma": np.array(10.0, np.float32),
           "physics_regularizer.weight": np.ones(3, np.float32)}


@pytest.fixture(scope="module")
def small_state():
    """A reference state at 2 layers: the keys and shapes of the port's
    small model in the reference's names, drawn from seed 3."""
    sd = SmokePhysNet(**SMALL).state_dict()
    keys_shapes = {k: v.shape for k, v in torch_port.export_torch_state_dict(sd, 2).items()}
    return torch_port.synth_torch_state(keys_shapes, seed=3, num_layers=2)


def test_synth_matches_jax(small_state):
    """The same seed and keys give the JAX package's numbers, bit for bit,
    at 2 layers and at the golden's full width."""
    keys_shapes = {k: v.shape for k, v in small_state.items()}
    want = jport.synth_torch_state(keys_shapes, seed=3, num_layers=2)
    assert sorted(want) == sorted(small_state)
    for k in want:
        np.testing.assert_array_equal(small_state[k], want[k], err_msg=k)
    with np.load(GOLDEN) as f:
        ks = {k: tuple(v) for k, v in json.loads(bytes(f["keys_shapes"]).decode()).items()}
        seed = int(f["seed"])
    got, want = torch_port.synth_torch_state(ks, seed), jport.synth_torch_state(ks, seed)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_convert_and_export_match_jax(small_state):
    """convert: equal, bit for bit and key for key, to the JAX conversion
    carried into the port by `jax_variables_to_state_dict`, and loadable by
    the port's model (strict); the skipped buffers are dropped. export:
    equal to the JAX export of the same weights."""
    state = {**small_state, **SKIPPED}
    got = torch_port.convert_torch_state_dict(state, 2)
    jvars = jport.convert_torch_state_dict(state, 2)
    want = jax_variables_to_state_dict(jvars)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    SmokePhysNet(**SMALL).load_state_dict(got, strict=True)
    exported = torch_port.export_torch_state_dict(got, 2)
    jexported = jport.export_torch_state_dict(jvars, 2)
    assert sorted(exported) == sorted(jexported)
    for k in jexported:
        np.testing.assert_array_equal(exported[k], jexported[k], err_msg=k)


def test_round_trip(small_state):
    """export(convert(s)) gives s back, and convert(export(sd)) a port
    state_dict sd, bit for bit."""
    sd = torch_port.convert_torch_state_dict(small_state, 2)
    back = torch_port.export_torch_state_dict(sd, 2)
    assert sorted(back) == sorted(small_state)
    for k in small_state:
        np.testing.assert_array_equal(back[k], small_state[k], err_msg=k)
    gen = torch.Generator().manual_seed(0)
    model_sd = {k: torch.randn(v.shape, generator=gen)
                for k, v in SmokePhysNet(**SMALL).state_dict().items()}
    again = torch_port.convert_torch_state_dict(
        torch_port.export_torch_state_dict(model_sd, 2), 2)
    assert sorted(again) == sorted(model_sd)
    for k, v in model_sd.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0, msg=k)


def test_refuses_unmapped_key(small_state):
    """A key the table does not map is refused by name; a missing one
    raises KeyError."""
    with pytest.raises(ValueError, match="decoder_extra.weight"):
        torch_port.convert_torch_state_dict(
            {**small_state, "decoder_extra.weight": np.zeros(2, np.float32)}, 2)
    missing = dict(small_state)
    del missing["chaos_layers.1.ffn.3.bias"]
    with pytest.raises(KeyError):
        torch_port.convert_torch_state_dict(missing, 2)


def test_reference_forward_128():
    """The reference's recorded full-width eval forward: its weights drawn
    from the golden's seed, bridged into the port's SmokePhysNet with no
    JAX in the way, on the golden's input and chaos fields; atol 1e-4 on
    the outputs and 1e-3 on the token features, as tests/test_torch_port.py
    holds the JAX model."""
    with np.load(GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    ks = {k: tuple(v) for k, v in json.loads(bytes(g["keys_shapes"]).decode()).items()}
    model = SmokePhysNet().eval()
    model.load_state_dict(torch_port.convert_torch_state_dict(
        torch_port.synth_torch_state(ks, seed=int(g["seed"]))), strict=True)
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
