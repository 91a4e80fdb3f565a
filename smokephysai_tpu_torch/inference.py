"""Inference CLI of the PyTorch/CUDA port:

    python -m smokephysai_tpu_torch.inference --config config/config_serving.yaml \\
        --checkpoint checkpoints/smokephysnet_128_best.npz --output_dir out/

Same flow as the root `inference.py`: simulate the 20-frame test sequence
from three fixed sources, predict every next frame and its physics features
in one batched forward, and write ground_truth.png, predictions.png,
physics_features.png and comparison.png to --output_dir. `--save_attention`
also writes attention_maps.png: layer 0's attention probabilities on the
first input frame, from one diagnostic forward on the einsum path. Runs on
the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Tuple

import torch

from .physics.simulator import SmokeSimulator
from .train.serving import load_model, make_predictor
from .utils.config import load_config

TEST_POSITIONS = [(64, 64), (32, 32), (96, 96)]
TEST_INTENSITIES = [1.5, 1.0, 0.8]


def make_simulator(config: Dict, device="cuda") -> SmokeSimulator:
    sim = config["simulation"]
    return SmokeSimulator(
        grid_size=tuple(sim["grid_size"]),
        dt=sim["dt"],
        viscosity=sim["viscosity"],
        use_pallas=config["tpu"]["use_pallas"],
        vorticity_eps=config["tpu"]["vorticity_eps"],
        device=device,
    )


def generate_test_sequence(simulator: SmokeSimulator, sequence_length: int = 20):
    simulator.reset()
    simulator.add_incense_source(TEST_POSITIONS, TEST_INTENSITIES)
    return [simulator.simulate_step() for _ in range(sequence_length)]


def run(
    config: Dict, checkpoint: str, device="cuda", sequence_length: int = 20,
    attention: bool = False,
) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Simulate the test sequence and predict frames 1..T from frames
    0..T-1 in one batched forward. Returns (sequence, outputs). With
    `attention`, outputs also holds "attention_weights": layer 0's
    attention probabilities [1, heads, 1024, 1024] on the first input
    frame, from the einsum path (the flash kernel never forms them)."""
    model = load_model(config, checkpoint, device)
    seed = config["tpu"]["seed"]
    predict = make_predictor(model, chaos_seed=seed)
    sequence = generate_test_sequence(make_simulator(config, device), sequence_length)
    inputs = torch.stack(sequence[:-1])[..., None]  # [T-1, H, W, 1]
    outputs = predict(inputs)
    if attention:
        with torch.inference_mode():
            outputs["attention_weights"] = model.attention_weights(
                inputs[:1], generator=torch.Generator().manual_seed(seed))
    return sequence, outputs


def save_figures(sequence, outputs, output_dir: str) -> None:
    """ground_truth.png, predictions.png, physics_features.png and
    comparison.png, and attention_maps.png where `outputs` holds
    "attention_weights", in `output_dir`."""
    from .utils.visualization import SmokeVisualizer, pyplot

    truth = [f.float().cpu().numpy() for f in sequence]
    preds = list(outputs["reconstructed"][..., 0].float().cpu().numpy())
    phys = outputs["physics_features"].float().cpu().numpy()
    os.makedirs(output_dir, exist_ok=True)
    out = lambda name: os.path.join(output_dir, name)

    visualizer = SmokeVisualizer(figsize=(15, 10))
    visualizer.plot_smoke_evolution(truth[1:], save_path=out("ground_truth.png"))
    visualizer.plot_smoke_evolution(preds, save_path=out("predictions.png"))
    visualizer.plot_chaos_features(
        {"lyapunov_exponent": phys[:, 0].tolist(),
         "fractal_dimension": phys[:, 1].tolist(),
         "entropy": phys[:, 2].tolist()},
        save_path=out("physics_features.png"))
    if "attention_weights" in outputs:
        visualizer.plot_attention_maps(outputs["attention_weights"], truth[0][None, ..., None],
                                       save_path=out("attention_maps.png"))

    plt = pyplot()
    fig, axes = plt.subplots(2, 3, figsize=(18, 12))
    for i, idx in enumerate([0, len(preds) // 2, len(preds) - 1]):
        axes[0, i].imshow(truth[idx + 1], cmap="hot")
        axes[0, i].set_title(f"Ground Truth Frame {idx + 1}")
        axes[0, i].axis("off")
        axes[1, i].imshow(preds[idx], cmap="hot")
        axes[1, i].set_title(f"Predicted Frame {idx + 1}")
        axes[1, i].axis("off")
    plt.tight_layout()
    plt.savefig(out("comparison.png"), dpi=150)
    plt.close(fig)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="SmokePhysAI inference (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default="config/config.yaml")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default=".")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--save_attention", action="store_true",
                        help="also write attention_maps.png: layer 0's attention "
                             "on the first frame")
    args = parser.parse_args(argv)
    config = load_config(args.config)
    sequence, outputs = run(config, args.checkpoint, args.device,
                            attention=args.save_attention)
    save_figures(sequence, outputs, args.output_dir)
    print(f"Visualization results have been saved to {args.output_dir}")


if __name__ == "__main__":
    main()
