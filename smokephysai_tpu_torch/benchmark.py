"""Benchmark CLI of the PyTorch/CUDA port: the model against optical-flow
baselines on held-out episodes.

    python -m smokephysai_tpu_torch.benchmark --config config/config.yaml \\
        --checkpoint checkpoints/smokephysnet_128_best.npz [--num_samples 50] \\
        [--samples tests/goldens/gate_draws_128x128_n50_s0.npz] \\
        [--set SEC.KEY=VAL ...] [--device cpu]

The root `benchmark.py`'s protocol: `--num_samples` held-out episodes from
seed + 1000, visited in order at batch 4 (batch 1 for a volumetric config),
one input frame each; the model's next-frame MSE on [0, 1] frames (the mean
of the batches' MSEs), the per-sample Pearson correlation of the three
physics features with the episode's chaos label, and the seconds per sample
of the predictor (one warm-up per batch shape outside the timed region,
which ends when the card has finished). The Farneback and Lucas-Kanade
baselines warp uint8 frames with cv2 and report MSE on 0-255 frames, the
reference's mixed-scale protocol; a volumetric config gets slicewise
Farneback and persistence (the next volume is the current one).

The port's random streams are not JAX's. `--samples` reads the JAX CLI's
draws (sources, input frames and the per-layer chaos fields at each batch
shape), recorded by `scripts/write_gate_draws.py`, and simulates the
episodes itself; without it the episodes, frames and chaos fields come from
the port's own generators. The model's row is printed before the baselines
run; where cv2 is not installed the flow baselines are skipped, and so
named (persistence needs no cv2). Runs on the card unless --device cpu is
given, in full float32 (no TF32) for a float32 config.
"""
from __future__ import annotations

import argparse
import importlib.util
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from .train.metrics import pearson_per_sample

BATCH_SIZE = 4  # the 2D protocol's batch; volumes go one at a time
HELD_OUT_SEED_OFFSET = 1000


def have_cv2() -> bool:
    return importlib.util.find_spec("cv2") is not None


def farneback_flow(prev_gray, next_gray):
    """Dense Farneback flow with the reference's parameter set."""
    import cv2

    return cv2.calcOpticalFlowFarneback(
        prev_gray, next_gray, None, 0.5, 3, 15, 3, 5, 1.2, 0
    )


def lucas_kanade_flow(prev_gray, next_gray):
    """Sparse Lucas-Kanade flow scattered into a dense field."""
    import cv2

    p0 = cv2.goodFeaturesToTrack(
        prev_gray, mask=None, maxCorners=100, qualityLevel=0.3,
        minDistance=7, blockSize=7,
    )
    flow = np.zeros((*prev_gray.shape, 2), dtype=np.float32)
    if p0 is None:
        return flow
    p1, st, _ = cv2.calcOpticalFlowPyrLK(
        prev_gray, next_gray, p0, None, winSize=(15, 15), maxLevel=2
    )
    if p1 is not None:
        for new, old in zip(p1[st == 1], p0[st == 1]):
            x0, y0 = old.ravel()
            x1, y1 = new.ravel()
            flow[int(y0), int(x0)] = [x1 - x0, y1 - y0]
    return flow


def warp_with_flow(prev_gray, flow):
    """Flow-warp prediction of the next frame."""
    import cv2

    h, w = prev_gray.shape[:2]
    map_x = (np.tile(np.arange(w), (h, 1)) + flow[..., 0]).astype(np.float32)
    map_y = (np.tile(np.arange(h), (w, 1)).T + flow[..., 1]).astype(np.float32)
    return cv2.remap(prev_gray, map_x, map_y, interpolation=cv2.INTER_LINEAR)


def _finish(t: torch.Tensor) -> None:
    """Waits until the card has finished the work queued for `t`."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def evaluate_model(predict: Callable, batches: Iterable[Dict]) -> Dict[str, float]:
    """MSE, mean physics correlation and seconds per sample of `predict`
    over `batches` ({input, target, chaos_features})."""
    total_mse, total_time, n_batches, n_samples = 0.0, 0.0, 0, 0
    corrs = []
    seen_shapes = set()
    for batch in batches:
        inputs = batch["input"]
        if tuple(inputs.shape) not in seen_shapes:  # warm-up, untimed
            predict(inputs)
            _finish(inputs)
            seen_shapes.add(tuple(inputs.shape))
        start = time.perf_counter()
        outputs = predict(inputs)
        _finish(inputs)
        total_time += time.perf_counter() - start

        total_mse += float(((outputs["reconstructed"].float() - batch["target"]) ** 2).mean())
        corrs.extend(pearson_per_sample(outputs["physics_features"].float(),
                                        batch["chaos_features"].float()).tolist())
        n_batches += 1
        n_samples += inputs.shape[0]

    return {
        "mse": total_mse / max(n_batches, 1),
        "physics_correlation": float(np.mean(corrs)) if corrs else float("nan"),
        "inference_time": total_time / max(n_samples, 1),
    }


def _uint8_frames(batch: Dict, key: str) -> np.ndarray:
    return (batch[key][..., 0].float().cpu().numpy() * 255).astype(np.uint8)


def _summary(results: Dict[str, Dict[str, list]]) -> Dict[str, Dict[str, float]]:
    return {
        name: {"mse": float(np.mean(r["mse"])), "inference_time": float(np.mean(r["time"]))}
        for name, r in results.items()
    }


def evaluate_traditional_cv(batches: Iterable[Dict]) -> Dict[str, Dict[str, float]]:
    """Farneback and Lucas-Kanade warps of uint8 frames (needs cv2)."""
    results = {"Farneback": {"mse": [], "time": []},
               "Lucas-Kanade": {"mse": [], "time": []}}
    for batch in batches:
        for prev_gray, next_gray in zip(_uint8_frames(batch, "input"),
                                        _uint8_frames(batch, "target")):
            t0 = time.perf_counter()
            pred_fb = warp_with_flow(prev_gray, farneback_flow(prev_gray, next_gray))
            t_fb = time.perf_counter() - t0
            t0 = time.perf_counter()
            pred_lk = warp_with_flow(prev_gray, lucas_kanade_flow(prev_gray, next_gray))
            t_lk = time.perf_counter() - t0
            truth = next_gray.astype(np.float64)
            results["Farneback"]["mse"].append(float(np.mean((truth - pred_fb) ** 2)))
            results["Farneback"]["time"].append(t_fb)
            results["Lucas-Kanade"]["mse"].append(float(np.mean((truth - pred_lk) ** 2)))
            results["Lucas-Kanade"]["time"].append(t_lk)
    return _summary(results)


def evaluate_traditional_cv3d(batches: Iterable[Dict]) -> Dict[str, Dict[str, float]]:
    """Volumetric baselines on uint8 voxels: per-z-slice Farneback warps
    (where cv2 is installed) and persistence (the next volume is the
    current one)."""
    flow = have_cv2()
    results = {"Persistence": {"mse": [], "time": []}}
    if flow:
        results = {"Farneback-slice": {"mse": [], "time": []}, **results}
    for batch in batches:
        for prev, nxt in zip(_uint8_frames(batch, "input"),
                             _uint8_frames(batch, "target")):  # [D, H, W]
            truth = nxt.astype(np.float64)
            if flow:
                t0 = time.perf_counter()
                pred = np.stack([warp_with_flow(p, farneback_flow(p, n))
                                 for p, n in zip(prev, nxt)])
                results["Farneback-slice"]["time"].append(time.perf_counter() - t0)
                results["Farneback-slice"]["mse"].append(float(np.mean((truth - pred) ** 2)))
            results["Persistence"]["time"].append(0.0)
            results["Persistence"]["mse"].append(
                float(np.mean((truth - prev.astype(np.float64)) ** 2)))
    return _summary(results)


RULE = "=" * 60


def print_model_row(model_results: Dict[str, float]) -> None:
    print("\n" + RULE)
    print(f"{'Model':<20} | {'MSE':<15} | {'Physics Corr':<15} | "
          f"{'Inference Time (ms)':<15}")
    print("-" * 60)
    print(f"{'SmokePhysAI-TPU':<20} | {model_results['mse']:.6f} | "
          f"{model_results['physics_correlation']:.4f} | "
          f"{model_results['inference_time'] * 1000:.2f}", flush=True)


def print_baseline_rows(cv_results: Dict[str, Dict[str, float]]) -> None:
    for method, r in cv_results.items():
        print(f"{method:<20} | {r['mse']:.6f} | {'N/A':<15} | "
              f"{r['inference_time'] * 1000:.2f}")
    print(RULE)
    print("Note: Physics Correlation measures prediction of chaos features")
    print("      (Lyapunov exponent, Fractal dimension, Entropy) vs ground truth")
    print("Note: model MSE is on normalised [0,1] tensors; CV MSE on uint8")
    print("      0-255 frames — the reference's mixed-scale protocol.")


def print_results(model_results: Dict[str, float],
                  cv_results: Dict[str, Dict[str, float]]) -> None:
    """The fixed-width results table."""
    print_model_row(model_results)
    print_baseline_rows(cv_results)


def read_samples(path: str, config: Dict, num_samples: int) -> Dict:
    """The draws of `scripts/write_gate_draws.py` for this run: {source
    params, frames [N] int64, chaos_traj {batch: [layers, B, 5, 3]}}.
    Refuses a file whose grid, sequence length, episode count or seed
    differ from the run's, or that lacks the trajectories of a batch shape
    the run takes (BATCH_SIZE, and the tail's N % BATCH_SIZE where it is
    not 0)."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    want = {"grid_size": tuple(config["data"]["grid_size"]),
            "sequence_length": config["data"]["sequence_length"],
            "num_samples": num_samples, "seed": config["tpu"]["seed"]}
    have = {"grid_size": tuple(int(x) for x in data["grid_size"]),
            "sequence_length": int(data["sequence_length"]),
            "num_samples": int(data["num_samples"]), "seed": int(data["seed"])}
    wrong = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if wrong:
        raise ValueError(f"{path} does not hold this run's draws: "
                         + ", ".join(f"{k} {h} in the file, {w} in the run"
                                     for k, (h, w) in wrong.items()))
    chaos_traj = {int(k[len("chaos_traj_b"):]): torch.from_numpy(v)
                  for k, v in data.items() if k.startswith("chaos_traj_b")}
    missing = sorted({min(BATCH_SIZE, num_samples), num_samples % BATCH_SIZE} - {0}
                     - set(chaos_traj))
    if missing:
        raise ValueError(f"{path} holds no chaos trajectories for batches of {missing}")
    return {
        "source_params": {"xy": data["source_xy"], "intensity": data["source_intensity"],
                          "active": data["source_active"]},
        "frames": torch.from_numpy(data["frames"].astype(np.int64)),
        "chaos_traj": chaos_traj,
    }


def held_out_batches(config: Dict, num_samples: int, samples: Optional[Dict] = None,
                     device="cuda") -> Callable[[], Iterator[Dict]]:
    """A function giving, on each call, one in-order pass over the held-out
    episodes (seed + 1000) in batches: of 4 at 2D, simulated from the
    sources in `samples` where given, else drawn; of 1 volume at 3D."""
    data, tpu = config["data"], config["tpu"]
    grid = tuple(data["grid_size"])
    seed = tpu["seed"] + HELD_OUT_SEED_OFFSET
    if len(grid) == 3:
        if samples is not None:
            raise ValueError("recorded draws are for 2D configs")
        from .data.synthetic3d import SyntheticSmokeDataset3D

        dataset = SyntheticSmokeDataset3D(
            num_samples=num_samples, grid_size=grid,
            sequence_length=data["sequence_length"], seed=seed,
            use_pallas=tpu["use_pallas"], device=device)
        return lambda: dataset.epoch_batches(torch.Generator().manual_seed(0), 1,
                                             shuffle=False)
    from .data.synthetic import SyntheticSmokeDataset

    dataset = SyntheticSmokeDataset(
        num_samples=num_samples, grid_size=grid,
        sequence_length=data["sequence_length"], seed=seed,
        use_pallas=tpu["use_pallas"], vorticity_eps=tpu["vorticity_eps"],
        device=device,
        source_params=None if samples is None else samples["source_params"])
    if samples is None:
        return lambda: dataset.epoch_batches(torch.Generator().manual_seed(0), BATCH_SIZE,
                                             shuffle=False)
    frames = samples["frames"]

    def batches() -> Iterator[Dict]:
        for start in range(0, num_samples, BATCH_SIZE):
            idx = torch.arange(start, min(start + BATCH_SIZE, num_samples))
            yield dataset.get_batch(idx, frames[idx])

    return batches


def check_device(device: str) -> torch.device:
    """The CLIs' device; refuses the card where there is none, and makes
    float32 products and convolutions on the card true float32 (no TF32)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass --device cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def main(argv=None) -> Dict:
    from .train.serving import load_model, make_predictor
    from .utils.config import apply_overrides, load_config

    parser = argparse.ArgumentParser(description="SmokePhysAI benchmark (PyTorch/CUDA)")
    parser.add_argument("--config", type=str, default="config/config.yaml")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--num_samples", type=int, default=50)
    parser.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL",
                        help="config override, e.g. --set tpu.use_flash=true")
    parser.add_argument("--samples", type=str, default=None,
                        help="the JAX CLI's recorded draws "
                             "(scripts/write_gate_draws.py) for this config and N")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    config = apply_overrides(load_config(args.config), args.set)
    if args.set:
        print(f"Config overrides: {args.set}")
    device = check_device(args.device)
    print(f"Using device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    samples = (read_samples(args.samples, config, args.num_samples)
               if args.samples else None)
    model = load_model(config, args.checkpoint, device)
    predict = make_predictor(model, chaos_seed=config["tpu"]["seed"],
                             chaos_traj=None if samples is None else samples["chaos_traj"])
    batches = held_out_batches(config, args.num_samples, samples, device)
    volumetric = len(config["data"]["grid_size"]) == 3

    print("\nEvaluating SmokePhysAI-TPU model...")
    model_results = evaluate_model(predict, batches())
    print_model_row(model_results)

    print("\nEvaluating traditional computer vision methods...")
    if not have_cv2():
        print("cv2 (OpenCV) is not installed: the Farneback"
              + ("-slice" if volumetric else " and Lucas-Kanade") + " baselines are skipped")
    if volumetric:
        cv_results = evaluate_traditional_cv3d(batches())
    else:
        cv_results = evaluate_traditional_cv(batches()) if have_cv2() else {}
    print_baseline_rows(cv_results)
    return {"model": model_results, "baselines": cv_results}


if __name__ == "__main__":
    main()
