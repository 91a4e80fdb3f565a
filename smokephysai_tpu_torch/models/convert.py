"""Carry SmokePhysNet and SmokePhysNet3D variables between the JAX package
and this port.

`load_npz_variables` reads the flat npz export (keys such as
``params/['layer_0']['chaos_attention']['q_proj']['kernel']``) with numpy
alone. `jax_variables_to_state_dict` turns the {params, batch_stats} tree
of numpy arrays into the state_dict of `models/net.SmokePhysNet` or
`models/net3d.SmokePhysNet3D`;
`model_to_flat_variables` and `save_npz_variables` go the other way, so a
model the port trained loads through `train/serving.load_model` (and the
JAX package's) like an exported JAX checkpoint:

  * Dense kernel [in, out]           -> Linear weight [out, in]
  * Conv kernel HWIO [kh, kw, I, O]  -> Conv weight OIHW
  * Conv3D kernel DHWIO              -> Conv3D weight OIDHW
  * ConvTranspose weight (2D and 3D) -> kept (both store torch's layout)
  * LayerNorm / BatchNorm scale      -> weight; the BatchNorm_0 level drops
  * batch_stats mean / var           -> running_mean / running_var
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def load_npz_variables(path: str) -> Dict:
    """Flat npz export -> {"params": {...}, "batch_stats": {...}} of numpy
    arrays, nested as the flax variable tree."""
    out: Dict = {"params": {}, "batch_stats": {}}
    with np.load(path) as f:
        for key in f.files:
            col, rest = key.split("/", 1)
            parts = re.findall(r"\['([^']+)'\]", rest)
            node = out.setdefault(col, {})
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(f[key])
    return out


def _walk(tree: Dict, prefix=()):
    for name, node in tree.items():
        if isinstance(node, dict):
            yield from _walk(node, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(node, np.float32)


def jax_variables_to_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """{params, batch_stats} (numpy, or anything np.asarray takes) ->
    {port parameter name: float32 tensor}."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _walk(variables["params"]):
        *mod, leaf = (p for p in path if p != "BatchNorm_0")
        if leaf == "kernel":
            if value.ndim == 2:
                value, leaf = value.T, "weight"
            elif value.ndim == 4:
                value, leaf = value.transpose(3, 2, 0, 1), "weight"
            elif value.ndim == 5:
                value, leaf = value.transpose(4, 3, 0, 1, 2), "weight"
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("bias", "weight", "pos_embedding"):
            raise ValueError(f"unmapped parameter {path}")
        sd[".".join(mod + [leaf])] = torch.from_numpy(np.array(value, np.float32))
    names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _walk(variables.get("batch_stats", {})):
        *mod, leaf = (p for p in path if p != "BatchNorm_0")
        if leaf not in names:
            raise ValueError(f"unmapped batch statistic {path}")
        sd[".".join(mod + [names[leaf]])] = torch.from_numpy(np.array(value, np.float32))
    return sd


def model_to_flat_variables(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of `jax_variables_to_state_dict`, flattened: the model's
    parameters and BatchNorm running statistics as the flat npz keys of
    the JAX export (``{col}/['mod']...['leaf']``), float32 numpy."""
    from .layers import BatchNorm, Conv, Conv3D, LayerNorm, Linear

    kinds = {name: type(mod) for name, mod in model.named_modules()}
    flat: Dict[str, np.ndarray] = {}
    for name, value in model.state_dict().items():
        *mod, leaf = name.split(".")
        kind = kinds.get(".".join(mod))
        value = value.detach().float().cpu().numpy()
        col = "params"
        if leaf == "weight" and kind is Linear:
            value, leaf = value.T, "kernel"
        elif leaf == "weight" and kind is Conv:
            value, leaf = value.transpose(2, 3, 1, 0), "kernel"
        elif leaf == "weight" and kind is Conv3D:
            value, leaf = value.transpose(2, 3, 4, 1, 0), "kernel"
        elif leaf == "weight" and kind in (LayerNorm, BatchNorm):
            leaf = "scale"
        elif leaf in ("running_mean", "running_var"):
            col, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf not in ("bias", "weight", "pos_embedding"):
            raise ValueError(f"unmapped state_dict entry {name}")
        if kind is BatchNorm:
            mod = mod + ["BatchNorm_0"]
        key = col + "/" + "".join(f"['{p}']" for p in mod + [leaf])
        flat[key] = np.ascontiguousarray(value, np.float32)
    return flat


def save_npz_variables(model: torch.nn.Module, path: str) -> str:
    """Write the model as a flat npz export (`load_npz_variables` reads it)."""
    np.savez_compressed(path, **model_to_flat_variables(model))
    return path
