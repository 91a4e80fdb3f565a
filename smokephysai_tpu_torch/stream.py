"""Streaming CLI of the PyTorch/CUDA port:

    python -m smokephysai_tpu_torch.stream --config config/config_streaming_1024.yaml \\
        --checkpoint checkpoints/smokephysnet_128_best.npz --frames 30 \\
        [--output_dir stream_output] [--downsample 4] [--source_radius R] \\
        [--device cpu]

Same flow as the root `stream.py`: one smoke source at the grid's centre,
then `train/streaming.streaming_rollout` (per frame one solver step, the
fractal perturbation and the model's eval forward, all on the device), and
writes to --output_dir:

  physics_features.npy   [T, 3] chaos features per frame
  frames.npy             [T, H/ds, W/ds] frames, downsampled on the device
  summary.json           frames, grid, fps (the first call included),
                         mesh_space, checkpoint
  evolution.png          a grid of up to 16 frames (where matplotlib is
                         installed; else the run says it skipped it)

Without --checkpoint the model gets random weights (`init_parameters`,
seed 0). `--mesh_space` above 1 asks for the domain-decomposed rollout,
which is not ported. Runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from .physics.solver import add_smoke_source, init_state
from .train.loop import init_parameters
from .train.serving import build_model, load_model
from .train.streaming import streaming_rollout
from .utils.config import load_config


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description="SmokePhysAI streaming (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default="config/config_streaming_1024.yaml")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help=".npz export; random weights if absent")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--output_dir", type=str, default="stream_output")
    parser.add_argument("--downsample", type=int, default=4,
                        help="spatial stride of the saved frames")
    parser.add_argument("--mesh_space", type=int, default=0,
                        help=">1: domain-decompose the solver over this many devices "
                             "(not ported)")
    parser.add_argument("--source_radius", type=float, default=0.0,
                        help="smoke source radius in cells (default grid/32, at least 8)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    if args.mesh_space > 1:
        raise NotImplementedError(
            f"--mesh_space {args.mesh_space}: the domain-decomposed streaming rollout "
            "(streaming_rollout_sharded) waits for the port of the parallel paths "
            "(ROADMAP.md, A.10)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to stream on the CPU")
    config = load_config(args.config)
    grid = tuple(config["simulation"]["grid_size"])

    if args.checkpoint:
        model = load_model(config, args.checkpoint, device)
    else:
        model = init_parameters(build_model(config, device),
                                torch.Generator(device).manual_seed(0))

    state = init_state(grid, device=device)
    state = state.replace(density=add_smoke_source(
        state.density, grid[1] / 2, grid[0] / 2,
        args.source_radius or max(8.0, grid[0] / 32), 1.5))
    sim = config["simulation"]

    t0 = time.perf_counter()
    _, outs = streaming_rollout(
        model, state, num_frames=args.frames, dt=sim["dt"], viscosity=sim["viscosity"],
        num_jacobi_iters=sim.get("num_jacobi_iters", 20),
        use_pallas=config.get("tpu", {}).get("use_pallas", True))
    feats = outs["physics_features"].cpu().numpy()  # waits for the rollout
    wall = time.perf_counter() - t0
    ds = args.downsample
    frames = outs["frame"][:, ::ds, ::ds].cpu().numpy()

    os.makedirs(args.output_dir, exist_ok=True)
    np.save(os.path.join(args.output_dir, "physics_features.npy"), feats)
    np.save(os.path.join(args.output_dir, "frames.npy"), frames)
    summary = {
        "frames": args.frames,
        "grid": list(grid),
        "fps_including_compile": round(args.frames / wall, 2),
        "mesh_space": args.mesh_space,
        "checkpoint": args.checkpoint,
    }
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)

    try:
        from .utils.visualization import SmokeVisualizer

        show = frames[:: max(1, len(frames) // 16)][:16]
        SmokeVisualizer().plot_smoke_evolution(
            list(show), save_path=os.path.join(args.output_dir, "evolution.png"))
    except ImportError as e:  # matplotlib is optional
        print(f"(skipping evolution plot: {e})")

    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
