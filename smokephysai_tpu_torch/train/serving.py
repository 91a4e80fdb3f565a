"""Inference-side model building, loading and a batched predictor.

Counterpart of the JAX package's `train/serving.py`: `build_model` reads the
same config keys (a 3-element `data.grid_size` builds the volumetric
SmokePhysNet3D), `load_model` restores the JAX package's flat npz export,
`make_predictor` returns a batched eval forward with a fixed chaos stream
(the same fields on every call), and `make_chunked_predictor` runs a batch
through it in fixed-size chunks.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.chaos_attention import tile_trajectory
from ..models.convert import jax_variables_to_state_dict, load_npz_variables
from ..models.net import TOKEN_GRID, SmokePhysNet
from ..models.net3d import TOKEN_GRID_3D, SmokePhysNet3D

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(config: Dict, device="cuda") -> SmokePhysNet | SmokePhysNet3D:
    """SmokePhysNet from config, or SmokePhysNet3D for a 3-element
    `data.grid_size`: `tpu.compute_dtype`, `tpu.use_flash`,
    `tpu.fast_math` and (2D only) `tpu.fast_encoder` as in the JAX package.
    The sequence- and pipeline-parallel trunks are not ported and are
    refused."""
    mc = config["model"]
    tpu = config.get("tpu", {})
    for key in ("ring_axis", "pipeline_axis"):
        if tpu.get(key):
            raise NotImplementedError(f"tpu.{key} is not ported")
    dtype_name = tpu.get("compute_dtype", "float32")
    if dtype_name not in _DTYPES:
        raise ValueError(f"tpu.compute_dtype {dtype_name!r} not supported")
    dtype = _DTYPES[dtype_name]
    if len(config.get("data", {}).get("grid_size", (0, 0))) == 3:
        model = SmokePhysNet3D(
            hidden_dim=mc["hidden_dim"],
            num_layers=mc["num_layers"],
            num_heads=mc["num_heads"],
            output_channels=mc.get("output_channels", 32),
            chaos_strength=mc["chaos_strength"],
            dtype=dtype,
            fast_math=tpu.get("fast_math", False),
            use_flash=tpu.get("use_flash", False),
        )
        return model.to(device).eval()
    model = SmokePhysNet(
        input_dim=mc["input_dim"],
        hidden_dim=mc["hidden_dim"],
        num_layers=mc["num_layers"],
        num_heads=mc["num_heads"],
        output_channels=mc.get("output_channels", 64),
        chaos_strength=mc["chaos_strength"],
        dtype=dtype,
        fast_math=tpu.get("fast_math", False),
        use_flash=tpu.get("use_flash", False),
        fast_encoder=tpu.get("fast_encoder", False),
    )
    return model.to(device).eval()


def load_model(config: Dict, checkpoint_path: str,
               device="cuda") -> SmokePhysNet | SmokePhysNet3D:
    """Model from config with the weights of a flat .npz export."""
    if not checkpoint_path.endswith(".npz"):
        raise ValueError("only the flat .npz export is read by the port")
    model = build_model(config, device)
    sd = jax_variables_to_state_dict(load_npz_variables(checkpoint_path))
    model.load_state_dict(sd, strict=True)
    return model


def make_predictor(
    model: SmokePhysNet | SmokePhysNet3D, chaos_seed: int = 0,
    chaos_traj: Dict[int, torch.Tensor] | None = None,
) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """Batched eval forward: NHWC [B, H, W, 1] (NDHWC [B, D, H, W, 1] for
    the volumetric model) -> {reconstructed, physics_features,
    latent_features}. Every call draws its chaos fields from a generator
    seeded with `chaos_seed`, so a call is deterministic.

    `chaos_traj` maps a batch size to given per-layer Lorenz trajectories
    [layers, B, 5, 3] (such as the JAX package's draws that
    `scripts/write_gate_draws.py` records): a call at that batch size runs
    under them, tiled along the tokens, and a call at any other batch size
    is refused. `predict.differentiable` is the same forward outside
    inference mode, for gradients with respect to the input."""
    model.eval()
    tokens = TOKEN_GRID_3D ** 3 if isinstance(model, SmokePhysNet3D) else TOKEN_GRID ** 2

    def forward(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if chaos_traj is None:
            return model(x, generator=torch.Generator().manual_seed(chaos_seed))
        traj = chaos_traj.get(x.shape[0])
        if traj is None:
            raise ValueError(f"no chaos trajectories for a batch of {x.shape[0]} "
                             f"(given for {sorted(chaos_traj)})")
        return model(x, chaos_fields=tile_trajectory(traj, tokens, x.device))

    predict = torch.inference_mode()(forward)
    predict.differentiable = forward
    return predict


def make_chunked_predictor(
    predict: Callable[[torch.Tensor], Dict[str, torch.Tensor]], chunk_size: int
) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """`predict` over a batch in chunks of `chunk_size`, the outputs
    concatenated (the volumetric evaluation's protocol, which runs 128^3
    volumes one at a time). A ragged last chunk is padded by repeating its
    last sample, so `predict` always sees one batch shape, and the padding
    is dropped. The chaos fields are drawn per call at the chunk's batch
    shape, so the result equals one full-batch call only at chaos_strength
    0, as in the JAX package."""
    if chunk_size < 1:
        raise ValueError("make_chunked_predictor: chunk_size must be >= 1")

    def predict_chunked(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        n = x.shape[0]
        if n <= chunk_size:
            return predict(x)
        outs = []
        for s in range(0, n, chunk_size):
            blk = x[s:s + chunk_size]
            real = blk.shape[0]
            if real < chunk_size:
                blk = torch.cat([blk, blk[-1:].expand(chunk_size - real, *blk.shape[1:])])
            outs.append({k: v[:real] for k, v in predict(blk).items()})
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    return predict_chunked
