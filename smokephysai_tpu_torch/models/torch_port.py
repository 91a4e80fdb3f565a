"""The bridge between the reference PyTorch `SmokePhysNet`'s state_dict and
this port's `models/net.SmokePhysNet`.

Counterpart of the JAX package's `models/torch_port.py`, kept as this
package's own copy. The reference model (src/models/smokephys_net.py) and
the port's are the same function with the same tensor layouts (Linear
[out, in], Conv2d OIHW, ConvTranspose2d [in, out, kh, kw], BatchNorm and
LayerNorm weight / bias, running statistics), so the bridge renames keys:

  * input_encoder.{0,1,3,4}        -> enc_conv1, enc_bn1, enc_conv2, enc_bn2
  * output_decoder.{0,2}           -> dec1, dec2
  * reconstruction_head.{0,1,3,4,6} -> up1, up_bn1, up2, up_bn2, recon_out
  * physics_head.{0,2}             -> phys1, phys2
  * chaos_layers.i.{chaos_attention.*, norm1, norm2, ffn.0, ffn.3}
                                   -> layer_i.{chaos_attention.*, norm1, norm2,
                                      ffn_in, ffn_out}

The reference's Lorenz sigma / rho / beta buffers and BatchNorm's
`num_batches_tracked` are constants or unused here and are skipped, as is
the `physics_regularizer` (no weights of the model); any other key the
table does not map is refused.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# reference prefix -> (port module, kind)
_ENCODER = {
    "input_encoder.0": ("enc_conv1", "conv"),
    "input_encoder.1": ("enc_bn1", "bn"),
    "input_encoder.3": ("enc_conv2", "conv"),
    "input_encoder.4": ("enc_bn2", "bn"),
    "feature_proj": ("feature_proj", "linear"),
    "output_decoder.0": ("dec1", "linear"),
    "output_decoder.2": ("dec2", "linear"),
    "reconstruction_head.0": ("up1", "convT"),
    "reconstruction_head.1": ("up_bn1", "bn"),
    "reconstruction_head.3": ("up2", "convT"),
    "reconstruction_head.4": ("up_bn2", "bn"),
    "reconstruction_head.6": ("recon_out", "conv"),
    "physics_head.0": ("phys1", "linear"),
    "physics_head.2": ("phys2", "linear"),
}

_ATTN_LEAVES = ("q_proj", "k_proj", "v_proj", "out_proj", "chaos_proj", "chaos_gate")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_SKIPPED = ("num_batches_tracked", "lorenz_", "physics_regularizer")


def _layer_map(num_layers: int) -> Dict[str, Tuple[str, str]]:
    m: Dict[str, Tuple[str, str]] = {}
    for i in range(num_layers):
        t, f = f"chaos_layers.{i}", f"layer_{i}"
        for leaf in _ATTN_LEAVES:
            m[f"{t}.chaos_attention.{leaf}"] = (f"{f}.chaos_attention.{leaf}", "linear")
        m[f"{t}.norm1"] = (f"{f}.norm1", "ln")
        m[f"{t}.norm2"] = (f"{f}.norm2", "ln")
        m[f"{t}.ffn.0"] = (f"{f}.ffn_in", "linear")
        m[f"{t}.ffn.3"] = (f"{f}.ffn_out", "linear")
    return m


def _key_pairs(num_layers: int):
    """(reference key, port key) for every weight of the model."""
    yield "pos_embedding", "pos_embedding"
    for prefix, (name, kind) in {**_ENCODER, **_layer_map(num_layers)}.items():
        for leaf in _BN_LEAVES if kind == "bn" else ("weight", "bias"):
            yield f"{prefix}.{leaf}", f"{name}.{leaf}"


def _f32(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(value, np.float32))


def convert_torch_state_dict(state: Mapping, num_layers: int = 6) -> Dict[str, torch.Tensor]:
    """{reference key: tensor or array} -> the port's SmokePhysNet
    state_dict (float32 CPU tensors). Refuses a key the table does not map
    (other than the skipped buffers); a missing key raises KeyError."""
    pairs = dict(_key_pairs(num_layers))
    out = {port: _f32(state[ref]) for ref, port in pairs.items()}
    leftovers = [k for k in state
                 if k not in pairs and not any(s in k for s in _SKIPPED)]
    if leftovers:
        raise ValueError(f"unmapped torch keys: {leftovers}")
    return out


def export_torch_state_dict(state_dict: Mapping[str, torch.Tensor],
                            num_layers: int = 6) -> Dict[str, np.ndarray]:
    """The inverse of `convert_torch_state_dict`: the port's SmokePhysNet
    state_dict (for example `model.state_dict()`) -> {reference key: float32
    numpy array}, which the reference's `load_state_dict` takes with
    strict=False (its skipped buffers are not written)."""
    return {ref: _f32(state_dict[port]).numpy() for ref, port in _key_pairs(num_layers)}


def synth_torch_state(
    keys_and_shapes: Dict[str, Tuple[int, ...]], seed: int = 0, num_layers: int = 6
) -> Dict[str, np.ndarray]:
    """A reference-layout state dict drawn from `seed` with realistic scales
    (torch's default uniform(+-1/sqrt(fan_in)) weights, norm weights near 1,
    positive running_var): the same numbers as the JAX package's
    `synth_torch_state`, so the recorded (key, shape, seed) of
    tests/goldens/model_forward_128.npz regenerates the reference's weights."""
    kind_of = {prefix: kind for prefix, (_, kind) in
               {**_ENCODER, **_layer_map(num_layers)}.items()}
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}
    for key in sorted(keys_and_shapes):
        shape = tuple(keys_and_shapes[key])
        if key.endswith(".running_var"):
            state[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif key.endswith(".running_mean"):
            state[key] = (0.2 * rng.standard_normal(shape)).astype(np.float32)
        elif key == "pos_embedding":
            state[key] = rng.standard_normal(shape).astype(np.float32)
        else:
            prefix = key.rsplit(".", 1)[0]
            kind = kind_of.get(prefix, "ln")
            if kind in ("ln", "bn"):
                if key.endswith(".weight"):
                    value = 1.0 + 0.1 * rng.standard_normal(shape)
                else:
                    value = 0.05 * rng.standard_normal(shape)
            else:
                w_shape = tuple(keys_and_shapes[f"{prefix}.weight"])
                # linear: fan_in = in; conv: I * kh * kw; convT: torch's
                # fan of the [in, out, kh, kw] weight, out * kh * kw
                fan = int(np.prod(w_shape[1:]))
                bound = fan ** -0.5
                value = rng.uniform(-bound, bound, shape)
            state[key] = value.astype(np.float32)
    return state
