"""The port's evaluation metrics (`train/metrics.py`) against the reference's
recorded values and against the JAX package's metrics, on the CPU."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
from smokephysai_tpu.train import metrics as jmetrics
from smokephysai_tpu_torch.train import metrics as tmetrics

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "metrics.npz")


def test_ssim_psnr_golden_parity():
    """SSIM and PSNR against the values recorded from the reference
    implementation, with the bounds of tests/test_data_train.py (abs 1e-5
    and 1e-4)."""
    g = np.load(GOLDEN)
    a = torch.from_numpy(g["a"].transpose(0, 2, 3, 1))
    b = torch.from_numpy(g["b"].transpose(0, 2, 3, 1))
    assert float(tmetrics.ssim(a, b)) == pytest.approx(float(g["ssim"]), abs=1e-5)
    assert float(tmetrics.psnr(a, b)) == pytest.approx(float(g["psnr"]), abs=1e-4)


@pytest.mark.parametrize("shape", [(3, 24, 20, 1), (2, 9, 13, 2)], ids=["24x20", "9x13x2"])
def test_metrics_match_jax(shape):
    """All four metrics on random NHWC pairs made with numpy: float32 on
    both sides, so the bound is a few float32 ulps of each value (rtol
    1e-5; the 9x13 frames are narrower than the window, so SSIM's pool sees
    zero padding on both sides)."""
    rng = np.random.default_rng(sum(shape))
    pred = rng.random(shape).astype(np.float32)
    target = np.clip(pred + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    feats = rng.standard_normal((7, 3)).astype(np.float32)
    labels = rng.standard_normal((7, 3)).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    for name in ("ssim", "psnr", "mse"):
        np.testing.assert_allclose(float(getattr(tmetrics, name)(tp, tt)),
                                   float(getattr(jmetrics, name)(jp, jt)),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        tmetrics.pearson_per_sample(torch.from_numpy(feats), torch.from_numpy(labels)).numpy(),
        np.asarray(jmetrics.pearson_per_sample(jnp.asarray(feats), jnp.asarray(labels))),
        rtol=1e-5, atol=1e-6)
