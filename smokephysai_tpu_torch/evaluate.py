"""Evaluation CLI of the PyTorch/CUDA port: the robustness and perturbation
report of a checkpoint.

    python -m smokephysai_tpu_torch.evaluate --checkpoint checkpoints/smokephysnet_128_best.npz \\
        [--config config/config.yaml] [--num_samples 50] [--num_physics_tests 50] \\
        [--sections reconstruction,adversarial] [--output evaluation_results.json] \\
        [--set SEC.KEY=VAL ...] [--device cpu]

The root `evaluate.py`'s report over held-out episodes (seed + 2), one
mid-sequence frame each with the next frame as target:

  physics_consistency   per-feature MAE of the predicted chaos features
  reconstruction        SSIM / PSNR / MSE against the next frames
  gaussian_noise        latent cosine stability and reconstruction MSE per
                        noise level
  adversarial           PGD feature stability and perturbation norm
  physics_perturbation  prediction stability over random simulated scenarios

The report so far is written to --output after each section (with
"partial": true until the run ends). A volumetric config runs the same
sections over [N, D, H, W, 1] volumes through a chunked predictor. Runs on
the card unless --device cpu is given, in full float32 (no TF32) there.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Set

import numpy as np
import torch

SECTIONS = ("physics_consistency", "reconstruction", "gaussian_noise", "adversarial",
            "physics_perturbation")
HELD_OUT_SEED_OFFSET = 2  # validation uses seed + 1, the benchmark seed + 1000


def run_evaluation(
    config: Dict,
    checkpoint: str,
    num_samples: int = 50,
    num_physics_tests: int = 50,
    partial_path: Optional[str] = None,
    sections: Optional[Set[str]] = None,
    device="cuda",
    progress: Optional[Callable[[str], None]] = None,
) -> Dict:
    """The report's `sections` (all when None) for `checkpoint`. With
    `partial_path` the report so far is written there after each section.
    `progress(stage)` is called as each stage starts ("generate episodes",
    then each section's name, then "done")."""
    from .eval.perturbation import PerturbationTester
    from .eval.robustness import RobustnessEvaluator
    from .train.serving import load_model, make_chunked_predictor, make_predictor

    unknown = set(sections or ()) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}; known: {', '.join(SECTIONS)}")
    t_start = time.time()

    def stage(name):
        print(f"[evaluate] {name} @ {time.time() - t_start:.0f}s", flush=True)
        if progress is not None:
            progress(name)

    device = torch.device(device)
    data, tpu = config["data"], config["tpu"]
    grid_size = tuple(data["grid_size"])
    seq_len = data["sequence_length"]
    seed = tpu.get("seed", 0)
    model = load_model(config, checkpoint, device)
    predict = make_predictor(model, chaos_seed=seed)

    stage("generate episodes")
    if len(grid_size) == 3:
        from .data.synthetic3d import SyntheticSmokeDataset3D

        ds = SyntheticSmokeDataset3D(
            num_samples=num_samples, grid_size=grid_size, sequence_length=seq_len,
            seed=seed + HELD_OUT_SEED_OFFSET, use_pallas=tpu.get("use_pallas", False),
            device=device)
        # inference sections run volume chunks; PGD chunks itself
        grad_chunk = max(1, (4 * 64 ** 3) // int(np.prod(grid_size)) + 1)
        raw_predict, predict = predict, make_chunked_predictor(predict, grad_chunk)
    else:
        from .data.synthetic import SyntheticSmokeDataset

        ds = SyntheticSmokeDataset(
            num_samples=num_samples, grid_size=grid_size, sequence_length=seq_len,
            seed=seed + HELD_OUT_SEED_OFFSET, use_pallas=tpu.get("use_pallas", False),
            vorticity_eps=tpu.get("vorticity_eps", 0.0), device=device)
        raw_predict, grad_chunk = predict, None
    t = seq_len // 2
    seqs = ds.data["sequences"]  # [N, T, (D,) H, W]
    chaos = np.asarray(ds.data["chaos"], np.float32)  # lyapunov, fractal, entropy
    inputs = torch.as_tensor(np.asarray(seqs[:, t], np.float32)[..., None], device=device)
    targets = torch.as_tensor(np.asarray(seqs[:, t + 1], np.float32)[..., None],
                              device=device)

    report = {}

    def flush_partial():
        if partial_path:
            with open(partial_path, "w") as f:
                json.dump({"partial": True, **report}, f, indent=2)

    def want(name):
        return sections is None or name in sections

    evaluator = RobustnessEvaluator()
    tester = PerturbationTester()
    if want("physics_consistency"):
        stage("physics_consistency")
        report["physics_consistency"] = evaluator.evaluate_physics_consistency(
            predict, inputs, {"lyapunov": chaos[:, 0], "fractal_dimension": chaos[:, 1],
                              "entropy": chaos[:, 2]})
        flush_partial()
    if want("reconstruction"):
        stage("reconstruction")
        report["reconstruction"] = evaluator.evaluate_reconstruction_quality(
            predict, inputs, targets)
        flush_partial()
    if want("gaussian_noise"):
        stage("gaussian_noise")
        report["gaussian_noise"] = tester.gaussian_noise_test(
            predict, inputs, generator=torch.Generator().manual_seed(seed))
        flush_partial()
    if want("adversarial"):
        stage("adversarial")
        report["adversarial"] = tester.adversarial_test(raw_predict, inputs,
                                                        chunk_size=grad_chunk)
        flush_partial()
    if want("physics_perturbation"):
        stage("physics_perturbation")
        report["physics_perturbation"] = tester.physics_perturbation_test(
            raw_predict, grid_size=grid_size, num_tests=num_physics_tests,
            num_steps=seq_len, generator=torch.Generator().manual_seed(seed + 3),
            dt=config["simulation"]["dt"], viscosity=config["simulation"]["viscosity"],
            device=device)
    stage("done")
    return report


def main(argv=None) -> Dict:
    from .benchmark import check_device
    from .utils.config import apply_overrides, load_config

    parser = argparse.ArgumentParser(description="SmokePhysAI evaluation (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default="config/config.yaml")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help=".npz checkpoint export")
    parser.add_argument("--num_samples", type=int, default=50,
                        help="evaluation episodes to generate")
    parser.add_argument("--num_physics_tests", type=int, default=50,
                        help="random simulated scenarios of the physics stability test")
    parser.add_argument("--output", type=str, default="evaluation_results.json",
                        help="where to write the JSON report")
    parser.add_argument("--sections", type=str, default="all",
                        help="comma-separated subset of " + ",".join(SECTIONS)
                             + " (default: all)")
    parser.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL",
                        help="config override, e.g. --set tpu.use_flash=true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    config = apply_overrides(load_config(args.config), args.set)
    if args.set:
        print(f"Config overrides: {args.set}")
    device = check_device(args.device)
    print(f"Using device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    report = run_evaluation(
        config, args.checkpoint, args.num_samples, args.num_physics_tests,
        partial_path=args.output,
        sections=None if args.sections == "all" else set(args.sections.split(",")),
        device=device)
    print(json.dumps(report, indent=2))
    with open(args.output, "w") as f:
        json.dump(report, f, indent=2)
    print(f"Report written to {args.output}")
    return report


if __name__ == "__main__":
    main()
