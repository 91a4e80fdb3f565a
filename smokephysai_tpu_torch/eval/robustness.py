"""Robustness evaluation: physics-consistency MAE and reconstruction quality.

Counterpart of the JAX package's `eval/robustness.py`, over a predictor such
as `train/serving.make_predictor` returns (NHWC, or NDHWC for volumes), with
the same metric definitions (`train/metrics.py`).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..train import metrics as M

Tensor = torch.Tensor
Predictor = Callable[[Tensor], Dict[str, Tensor]]

FEATURES = (("lyapunov", 0, "lyapunov_mae"), ("fractal_dimension", 1, "fractal_mae"),
            ("entropy", 2, "entropy_mae"))


class RobustnessEvaluator:
    def evaluate_physics_consistency(
        self, predict: Predictor, test_data: Tensor, physics_targets: Dict
    ) -> Dict[str, float]:
        """Per-feature MAE of the predicted chaos features against the
        targets given (numpy or tensors, [N] each)."""
        pred = predict(test_data)["physics_features"].float()
        out = {}
        for key, col, metric_name in FEATURES:
            if key in physics_targets:
                target = torch.as_tensor(np.asarray(physics_targets[key], np.float32),
                                         device=pred.device)
                out[metric_name] = float((pred[:, col] - target).abs().mean())
        return out

    def evaluate_reconstruction_quality(
        self, predict: Predictor, test_data: Tensor, targets: Tensor
    ) -> Dict[str, float]:
        """SSIM, PSNR and MSE of the predicted next frames. Volumes
        ([N, D, H, W, 1]) take SSIM slice by slice: the window runs over
        each z slice and the score averages over all slices."""
        recon = predict(test_data)["reconstructed"].float()
        targets = targets.to(recon)
        if recon.dim() == 5:
            n, d, h, w, c = recon.shape
            recon_s, targets_s = recon.reshape(n * d, h, w, c), targets.reshape(n * d, h, w, c)
        else:
            recon_s, targets_s = recon, targets
        return {
            "ssim": float(M.ssim(recon_s, targets_s)),
            "psnr": float(M.psnr(recon, targets)),
            "mse": float(M.mse(recon, targets)),
        }
