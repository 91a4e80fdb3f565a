"""Training checkpoints: the whole state with `torch.save`, the served
weights as the flat npz export, and JSON metadata.

Under `exp_dir`, `<name>.pt` holds the model's state_dict, the optimizer,
the EMA, the step, the epoch and both generators' states (a resume
continues exactly); `<name>.npz` holds the served weights (the EMA when it
is on) in the JAX package's export format, which `train/serving.load_model`
and `--init_from` read; `meta.json` (best model) or `<name>_meta.json`
holds the metadata. Counterpart of the JAX package's orbax checkpoints.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..models.convert import save_npz_variables

CKPT_NAME = "best_model"
LAST_NAME = "last_model"
META_NAME = "meta.json"


def _meta_name(name: str) -> str:
    return META_NAME if name == CKPT_NAME else f"{name}_meta.json"


def save_checkpoint(exp_dir: str, trainer, data_generator: torch.Generator,
                    meta: Dict[str, Any], name: str = CKPT_NAME) -> str:
    """Write `<name>.pt`, `<name>.npz` and the metadata; returns the .pt
    path."""
    os.makedirs(exp_dir, exist_ok=True)
    path = os.path.join(exp_dir, f"{name}.pt")
    payload = {
        "model": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "ema": trainer.ema,
        "step": trainer.step,
        "epoch": trainer.epoch,
        "generator": trainer.generator.get_state(),
        "data_generator": data_generator.get_state(),
        "meta": meta,
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    export_npz(trainer, os.path.join(exp_dir, f"{name}.npz"))
    with open(os.path.join(exp_dir, _meta_name(name)), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return path


def export_npz(trainer, path: str) -> str:
    """The served weights (EMA parameters when on) with the model's running
    statistics, as a flat npz export."""
    model = trainer.model
    if trainer.ema is None:
        return save_npz_variables(model, path)
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    try:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(trainer.ema[n])
        return save_npz_variables(model, path)
    finally:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(saved[n])


def restore_checkpoint(path: str, trainer, data_generator: torch.Generator) -> Dict[str, Any]:
    """Restore a trainer built from the same config. `path` is a `.pt` file
    or an experiment directory (its best model). Returns the metadata."""
    if os.path.isdir(path):
        path = os.path.join(path, f"{CKPT_NAME}.pt")
    device = next(trainer.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=False)
    trainer.model.load_state_dict(payload["model"])
    trainer.optimizer.load_state_dict(payload["optimizer"])
    if (payload["ema"] is None) != (trainer.ema is None):
        raise ValueError("checkpoint and config disagree on training.ema_decay")
    if trainer.ema is not None:
        for n, t in payload["ema"].items():
            trainer.ema[n].copy_(t)
    trainer.step = int(payload["step"])
    trainer.epoch = int(payload["epoch"])
    trainer.generator.set_state(payload["generator"].cpu())
    data_generator.set_state(payload["data_generator"].cpu())
    return payload["meta"]


def latest_checkpoint(experiments_root: str = "experiments") -> Optional[str]:
    """The last experiment directory (by name: the names are timestamps)
    under `experiments_root` that holds a best-model checkpoint, or None."""
    if not os.path.isdir(experiments_root):
        return None
    found = sorted(d for d in os.listdir(experiments_root)
                   if os.path.isfile(os.path.join(experiments_root, d, f"{CKPT_NAME}.pt")))
    return os.path.join(experiments_root, found[-1]) if found else None
