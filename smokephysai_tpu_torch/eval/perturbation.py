"""Perturbation tests: Gaussian input noise, a PGD attack on the input, and
the stability of the physics prediction over random simulated scenarios.

Counterpart of the JAX package's `eval/perturbation.py`. Its draws come from
explicit `torch.Generator`s (the JAX package's from keys), so the noise and
the scenarios' sources are the JAX package's distributions, not its numbers.
The PGD attack differentiates the predictor's forward with respect to the
input with `torch.autograd` and keeps the reference's sign quirk: it steps
along sign(d(-mse)/d(delta)), so it *descends* the reconstruction error
despite the reference's 'maximize' comment.

Scenarios are simulated as the JAX package's are: `simulate_episode` (or
`simulate_episode3d`) without `use_pallas`, so the port's plain per-op
solver (plain CG in 3D) runs them and no kernel of the port is launched
there. The JAX package predicts a 2D test's N x T frames in one batch; at
128^2 and 1000 frames the float32 einsum path's attention scores alone
would take ~34 GB of the card, so the port predicts them in chunks of
`FRAME_CHUNK` frames (a padded last chunk), and the chaos fields are drawn
at the chunk's shape (as `train/serving.make_chunked_predictor` says).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..data.synthetic import sample_source_params
from ..data.synthetic3d import sample_source_params3d
from ..physics.simulator import simulate_episode
from ..physics.simulator3d import simulate_episode3d
from ..train.serving import make_chunked_predictor

Tensor = torch.Tensor
Predictor = Callable[[Tensor], Dict[str, Tensor]]

FRAME_CHUNK = 64  # 2D scenario frames per predictor call


def _cosine_sim(a: Tensor, b: Tensor) -> Tensor:
    num = (a * b).sum(dim=1)
    den = torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(b, dim=1) + 1e-12
    return num / den


def unit_noise(generator: torch.Generator, shape, device) -> Tensor:
    """N(0, 1) float32 noise of `shape` from `generator`, on `device`."""
    return torch.randn(tuple(shape), generator=generator, device=generator.device,
                       dtype=torch.float32).to(device)


class PerturbationTester:
    def gaussian_noise_test(
        self,
        predict: Predictor,
        test_data: Tensor,
        noise_levels: Sequence[float] = (0.01, 0.05, 0.1, 0.2),
        generator: Optional[torch.Generator] = None,
    ) -> Dict:
        """Cosine stability of the latent features and the reconstruction's
        MSE against the clean prediction at each noise level (inputs
        clipped to [0, 1])."""
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        baseline = predict(test_data)
        results = {}
        for level in noise_levels:
            noise = level * unit_noise(generator, test_data.shape, test_data.device)
            pred = predict((test_data + noise).clamp(0.0, 1.0))
            results[f"gaussian_{level}"] = {
                "feature_stability": float(_cosine_sim(
                    baseline["latent_features"].float(),
                    pred["latent_features"].float()).mean()),
                "reconstruction_mse": float(((pred["reconstructed"].float()
                                              - baseline["reconstructed"].float()) ** 2).mean()),
            }
        return results

    def adversarial_test(
        self,
        predict: Predictor,
        test_data: Tensor,
        epsilon: float = 0.1,
        num_steps: int = 10,
        chunk_size: int | None = None,
    ) -> Dict:
        """PGD on the input: `num_steps` steps of epsilon / num_steps along
        sign(d(-mse)/d(delta)) (the reference's direction), delta clipped to
        [-epsilon, epsilon] and the input to [0, 1]. The gradient runs
        through `predict.differentiable` where the predictor has one
        (`make_predictor`'s forward outside inference mode).

        `chunk_size` attacks the samples a chunk at a time (the volumetric
        protocol, where one batch's gradient does not fit the card). The
        loss is a mean of per-sample terms and sign() ignores its 1/N, so
        each sample's delta is the full batch's, up to the chaos draw at the
        chunk's shape; the stability is weighted by chunk size and the norm
        is the root-sum-square of the chunks' norms."""
        n = test_data.shape[0]
        if chunk_size is not None and chunk_size < n:
            stab_sum, sq_norm = 0.0, 0.0
            for s in range(0, n, chunk_size):
                blk = test_data[s:s + chunk_size]
                r = self.adversarial_test(predict, blk, epsilon, num_steps)
                stab_sum += r["adversarial_feature_stability"] * blk.shape[0]
                sq_norm += r["adversarial_perturbation_norm"] ** 2
            return {
                "adversarial_feature_stability": stab_sum / n,
                "adversarial_perturbation_norm": float(sq_norm ** 0.5),
            }

        forward = getattr(predict, "differentiable", predict)
        delta = torch.zeros_like(test_data)
        for _ in range(num_steps):
            delta.requires_grad_(True)
            with torch.enable_grad():
                out = forward((test_data + delta).clamp(0.0, 1.0))
                loss = -((out["reconstructed"].float() - test_data) ** 2).mean()
                (grad,) = torch.autograd.grad(loss, delta)
            delta = (delta.detach() + (epsilon / num_steps) * grad.sign()).clamp(
                -epsilon, epsilon)

        baseline = predict(test_data)
        adv_out = predict((test_data + delta).clamp(0.0, 1.0))
        return {
            "adversarial_feature_stability": float(_cosine_sim(
                baseline["latent_features"].float(),
                adv_out["latent_features"].float()).mean()),
            "adversarial_perturbation_norm": float(torch.linalg.vector_norm(delta)),
        }

    def physics_perturbation_test(
        self,
        predict: Predictor,
        grid_size=(128, 128),
        num_tests: int = 50,
        num_steps: int = 20,
        generator: Optional[torch.Generator] = None,
        dt: float = 0.01,
        viscosity: float = 0.001,
        device="cuda",
    ) -> Dict:
        """Stability 1 / (1 + mean variance) of the per-frame physics
        predictions over `num_tests` random scenarios of `num_steps` frames,
        simulated on `device`."""
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        if len(grid_size) == 3:
            feats = self._physics_scenarios3d(predict, tuple(grid_size), num_tests,
                                              num_steps, generator, dt, viscosity, device)
        else:
            params = sample_source_params(generator, num_tests, tuple(grid_size))
            seqs, _ = simulate_episode(
                params["xy"].to(device), params["intensity"].to(device),
                params["active"].to(device), grid_size=tuple(grid_size),
                num_steps=num_steps, dt=dt, viscosity=viscosity)
            n, t, h, w = seqs.shape
            frames = seqs.reshape(n * t, h, w, 1)
            chunked = make_chunked_predictor(predict, FRAME_CHUNK)
            feats = chunked(frames)["physics_features"].float().reshape(n, t, 3)
        pred_var = feats.var(dim=1, unbiased=False).mean(dim=-1)  # [N]
        avg_variance = float(pred_var.mean())
        return {
            "physics_prediction_stability": 1.0 / (1.0 + avg_variance),
            "num_tests": num_tests,
        }

    @staticmethod
    def _physics_scenarios3d(predict, grid_size, num_tests, num_steps, generator, dt,
                             viscosity, device) -> Tensor:
        """Volumetric scenario features [N, T, 3]: simulated in chunks of at
        most 8 * 64^3 voxels and predicted in fixed-size chunks of volumes."""
        d, h, w = grid_size
        params = sample_source_params3d(generator, num_tests, grid_size)
        sim_chunk = max(1, (8 * 64 ** 3) // (d * h * w))
        feat_chunks = []
        for start in range(0, num_tests, sim_chunk):
            part = slice(start, min(start + sim_chunk, num_tests))
            seqs, _ = simulate_episode3d(
                params["xyz"][part].to(device), params["intensity"][part].to(device),
                params["active"][part].to(device), grid_size=grid_size,
                num_steps=num_steps, dt=dt, viscosity=viscosity)  # [n, T, D, H, W]
            n, t = seqs.shape[:2]
            pc = max(1, min(n * t, (4 * 64 ** 3) // (d * h * w) + 1))
            chunked = make_chunked_predictor(predict, pc)
            feats = chunked(seqs.reshape(n * t, d, h, w, 1))["physics_features"]
            feat_chunks.append(feats.float().reshape(n, t, 3))
        return torch.cat(feat_chunks)
