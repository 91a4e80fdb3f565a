"""Matplotlib figures: frame grids, the chaos features over time, and the
attention triptych.

Counterpart of the JAX package's `utils/visualization.py` (`SmokeVisualizer`,
the same figures on a dark background). matplotlib is imported when a figure
is drawn, with the Agg backend, so the package imports without it. Arrays
may be numpy arrays or tensors on any device.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.style.use("dark_background")
    return plt


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


class SmokeVisualizer:
    def __init__(self, figsize: tuple = (12, 8)):
        self.figsize = figsize

    @staticmethod
    def _finish(plt, fig, save_path: Optional[str]):
        plt.tight_layout()
        if save_path:
            plt.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)

    def plot_smoke_evolution(self, density_sequence: List, save_path: Optional[str] = None):
        """The frames in a grid of at most 8 per row."""
        plt = pyplot()
        frames = [_numpy(d) for d in density_sequence]
        n = len(frames)
        cols = min(8, n)
        rows = -(-n // cols)
        fig, axes = plt.subplots(rows, cols, figsize=(cols * 2, rows * 2), squeeze=False)
        for i in range(rows * cols):
            ax = axes[divmod(i, cols)]
            if i < n:
                ax.imshow(frames[i], cmap="hot", interpolation="bilinear")
                ax.set_title(f"Frame {i}")
            ax.axis("off")
        self._finish(plt, fig, save_path)

    def plot_chaos_features(self, chaos_metrics: Dict[str, List[float]],
                            save_path: Optional[str] = None):
        """The three chaos features over time, side by side."""
        plt = pyplot()
        fig, axes = plt.subplots(1, 3, figsize=self.figsize)
        names = ["lyapunov_exponent", "fractal_dimension", "entropy"]
        titles = ["Lyapunov Exponent", "Fractal Dimension", "Entropy"]
        for ax, name, title in zip(axes, names, titles):
            if name in chaos_metrics:
                ax.plot(chaos_metrics[name], "o-", linewidth=2, markersize=4)
                ax.set_title(title)
                ax.set_xlabel("Time Step")
                ax.grid(True, alpha=0.3)
        self._finish(plt, fig, save_path)

    def plot_attention_maps(self, attention_weights, input_image,
                            save_path: Optional[str] = None):
        """Input | attention matrix of the first sample's first head | its
        mean over queries on the token grid."""
        plt = pyplot()
        attn = _numpy(attention_weights)[0, 0]
        img = _numpy(input_image)
        if img.ndim == 4:  # one NHWC or NCHW sample
            img = img[0, ..., 0] if img.shape[-1] == 1 else img[0, 0]

        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        axes[0].imshow(img, cmap="hot")
        axes[0].set_title("Input Smoke")
        axes[0].axis("off")
        im1 = axes[1].imshow(attn, cmap="viridis")
        axes[1].set_title("Attention Matrix")
        axes[1].set_xlabel("Key Position")
        axes[1].set_ylabel("Query Position")
        plt.colorbar(im1, ax=axes[1])
        avg = attn.mean(axis=0)
        side = int(np.sqrt(len(avg)))
        if side * side == len(avg):
            im2 = axes[2].imshow(avg.reshape(side, side), cmap="plasma")
            axes[2].set_title("Average Attention")
            axes[2].axis("off")
            plt.colorbar(im2, ax=axes[2])
        self._finish(plt, fig, save_path)
