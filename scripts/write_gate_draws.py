#!/usr/bin/env python
"""Record the JAX benchmark CLI's random draws for the 50-sample quality gate.

    python scripts/write_gate_draws.py [--config config/config.yaml ...]
        [--num_samples 50] [--out_dir tests/goldens]

`benchmark.py` draws its held-out episodes and its chaos fields from JAX's
threefry streams, which PyTorch cannot reproduce:

- the sources from `PRNGKey(seed + 1000)` through the dataset
  (`sample_source_params`);
- the input frames from `epoch_batches(PRNGKey(0), batch_size=4,
  shuffle=False)` (`epoch_order_frames`; the order is 0..N-1);
- the per-layer chaos fields from `PRNGKey(seed)` on every predictor call,
  at the call's batch shape: 4, and the tail batch of N % 4.

This script makes those draws on the CPU with the JAX package's own functions
and writes them to `<out_dir>/gate_draws_<H>x<W>_n<N>_s<seed>.npz`, which the
port's benchmark CLI reads with `--samples` and simulates itself. A chaos
field repeats every 5 tokens, so each batch shape keeps its [layers, B, 5, 3]
Lorenz trajectories, captured from an un-jitted `model.apply` (zero weights:
the draws do not depend on them). Threefry draws depend on the shape, so a
file serves only its own N. By default it writes the files of
config/config.yaml (128^2) and config/config_256_vorticity.yaml (256^2).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import smokephysai_tpu.models.chaos_attention as chaos_attention  # noqa: E402
from smokephysai_tpu.data.synthetic import (  # noqa: E402
    epoch_order_frames,
    sample_source_params,
)
from smokephysai_tpu.train.serving import build_model  # noqa: E402
from smokephysai_tpu.utils.config import load_config  # noqa: E402

BATCH_SIZE = 4  # benchmark.py's 2D batch
LORENZ_STEPS = chaos_attention.LORENZ_STEPS
DEFAULT_CONFIGS = ("config/config.yaml", "config/config_256_vorticity.yaml")


def chaos_trajectories(model, grid, batch: int, seed: int) -> np.ndarray:
    """[layers, batch, 5, 3]: the Lorenz trajectories the model draws from
    `PRNGKey(seed)` at this batch, recorded as `chaos_field` returns them."""
    shapes = jax.eval_shape(
        model.init, {"params": jax.random.PRNGKey(0), "chaos": jax.random.PRNGKey(1)},
        jnp.zeros((1, *grid, 1)))
    variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    recorded = []
    original = chaos_attention.chaos_field

    def recording(key, b, seq_len):
        field = original(key, b, seq_len)
        recorded.append(np.asarray(field)[:, :LORENZ_STEPS])
        return field

    chaos_attention.chaos_field = recording
    try:
        model.apply(variables, jnp.zeros((batch, *grid, 1)), train=False,
                    rngs={"chaos": jax.random.PRNGKey(seed)})
    finally:
        chaos_attention.chaos_field = original
    return np.stack(recorded).astype(np.float32)


def write_draws(config_path: str, num_samples: int, out_dir: str) -> str:
    config = load_config(config_path)
    grid = tuple(config["data"]["grid_size"])
    if len(grid) != 2:
        raise ValueError(f"{config_path}: the gate draws are for 2D configs")
    seq_len = config["data"]["sequence_length"]
    seed = config["tpu"]["seed"]
    params = sample_source_params(jax.random.PRNGKey(seed + 1000), num_samples, grid)
    order, frames = epoch_order_frames(jax.random.PRNGKey(0), num_samples, seq_len,
                                       shuffle=False)
    assert np.array_equal(np.asarray(order), np.arange(num_samples))
    model = build_model(config)
    out = {
        "source_xy": np.asarray(params["xy"]),
        "source_intensity": np.asarray(params["intensity"]),
        "source_active": np.asarray(params["active"]),
        "frames": np.asarray(frames).astype(np.int64),
        "grid_size": np.asarray(grid, np.int64),
        "sequence_length": np.int64(seq_len),
        "num_samples": np.int64(num_samples),
        "seed": np.int64(seed),
        "batch_size": np.int64(BATCH_SIZE),
    }
    for batch in sorted({min(BATCH_SIZE, num_samples), num_samples % BATCH_SIZE} - {0}):
        out[f"chaos_traj_b{batch}"] = chaos_trajectories(model, grid, batch, seed)
    path = os.path.join(out_dir, f"gate_draws_{grid[0]}x{grid[1]}_n{num_samples}_s{seed}.npz")
    np.savez(path, **out)
    return path


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", action="append", default=None,
                        help="2D config (repeatable; default: the two gate configs)")
    parser.add_argument("--num_samples", type=int, default=50)
    parser.add_argument("--out_dir", type=str,
                        default=os.path.join(ROOT, "tests", "goldens"))
    args = parser.parse_args()
    for config_path in args.config or [os.path.join(ROOT, c) for c in DEFAULT_CONFIGS]:
        print(f"wrote {write_draws(config_path, args.num_samples, args.out_dir)}")


if __name__ == "__main__":
    main()
