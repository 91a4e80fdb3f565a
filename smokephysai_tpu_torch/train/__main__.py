"""Training CLI of the PyTorch/CUDA port:

    python -m smokephysai_tpu_torch.train --config config/config_train_fast.yaml \\
        [--set SEC.KEY=VAL ...] [--init_from weights.npz] \\
        [--resume EXP_DIR|CKPT.pt|auto] [--device cpu]

Same flow as the root `train.py`: read the YAML config (with overrides),
generate or load the cached train and validation datasets (volume episodes
for a 3-element `data.grid_size`, which trains SmokePhysNet3D), train with
`train/loop.fit` into experiments/smokephys_<timestamp>/ (best_model.pt and
.npz on each better validation loss, last_model.pt and .npz at the end,
TensorBoard scalars under logs/ where tensorboard is installed).
The .npz files are flat exports that `train/serving.load_model` serves.
`--resume auto` resumes the newest experiment that holds a best model (a
fresh run when there is none).
Runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import os
from datetime import datetime

import torch

from ..data.synthetic import create_data_loaders
from ..data.synthetic3d import create_data_loaders3d
from ..utils.config import apply_overrides, load_config
from .checkpoint import latest_checkpoint
from .loop import fit


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="SmokePhysAI training (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default="config/config.yaml")
    parser.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL",
                        help="config override, e.g. --set training.num_epochs=1")
    parser.add_argument("--init_from", type=str, default=None,
                        help="start from the weights of an .npz export "
                             "(fresh optimizer)")
    parser.add_argument("--resume", type=str, default=None,
                        help="experiment directory or .pt checkpoint to resume, "
                             "or 'auto' for the newest experiment")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    config = apply_overrides(load_config(args.config), args.set)
    if args.set:
        print(f"Config overrides: {args.set}")
    if args.resume == "auto":
        args.resume = latest_checkpoint()
        print(f"Auto-resume from: {args.resume}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to train on the CPU")
    print(f"Using device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    exp_dir = os.path.join("experiments", f"smokephys_{timestamp}")
    os.makedirs(exp_dir, exist_ok=True)
    try:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(os.path.join(exp_dir, "logs"))
    except ImportError:  # tensorboard is optional
        writer = None

    data, tpu = config["data"], config["tpu"]
    common = dict(
        batch_size=config["training"]["batch_size"],
        num_train=data["num_train"],
        num_val=data["num_val"],
        grid_size=tuple(data["grid_size"]),
        cache_dir=data["cache_dir"],
        sequence_length=data["sequence_length"],
        seed=tpu["seed"],
        use_pallas=tpu["use_pallas"],
        device=device,
    )
    if len(data["grid_size"]) == 3:
        train_ds, val_ds = create_data_loaders3d(**common)
    else:
        train_ds, val_ds = create_data_loaders(vorticity_eps=tpu["vorticity_eps"], **common)
    try:
        fit(config, train_ds, val_ds, exp_dir, writer=writer, resume_from=args.resume,
            init_from=args.init_from, device=device)
    finally:
        if writer is not None:
            writer.close()
    print(f"Training completed! Checkpoints in {exp_dir}")
    return exp_dir


if __name__ == "__main__":
    main()
