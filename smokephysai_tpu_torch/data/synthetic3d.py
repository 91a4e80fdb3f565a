"""3D synthetic smoke dataset for the volumetric configuration.

Counterpart of the JAX package's `data/synthetic3d.py`: volume episodes
from `physics.simulator3d.simulate_episode3d`, generated in chunks capped at
8 * 64^3 voxels (one episode at a time at 128^3), with the 2D dataset's
sampling (a frame t in [5, T-5) as input, t+1 as target, the episode's
chaos label and the whole sequence). Sequences are stored as float16 when
their float32 bytes reach `DEVICE_BYTES_LIMIT`, cast chunk by chunk on the
host as they are generated (batches are cast back to float32).

Source randomisation has the JAX package's distributions, drawn from an
explicit `torch.Generator`: 1-3 sources, integer positions in
[margin, size - margin) with margin min(20, min(grid) // 4), intensity
U(0.5, 2.0). `use_pallas` (the config's `tpu.use_pallas`) solves each
step's pressure with the CG kernel; the JAX package's 3D episodes always
take its XLA CG. The npz cache has the JAX package's keys (sequences, chaos)
plus the source parameters; the port reads a file the JAX package wrote
under its name, and writes its own under that name tagged `_torch`.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..physics.simulator3d import simulate_episode3d
from .synthetic import (
    CACHE_TAG,
    FRAME_RANGE,
    INTENSITY_RANGE,
    MAX_SOURCES,
    SOURCE_MARGIN,
    _check_sequence_length,
    epoch_index_arrays,
)

Tensor = torch.Tensor

CHUNK_VOXELS = 8 * 64 ** 3  # episodes per chunk: at most this many voxels


def sample_source_params3d(
    generator: torch.Generator, num_samples: int, grid_size: Tuple[int, int, int]
) -> Dict[str, Tensor]:
    """{xyz [N, 3, 3] (x, y, z), intensity [N, 3], active [N, 3]}, float32
    on the generator's device. An empty position range gives the margin
    itself, as jax.random.randint does."""
    d, h, w = grid_size
    dev = generator.device
    margin = min(SOURCE_MARGIN, min(grid_size) // 4)
    num_sources = torch.randint(1, MAX_SOURCES + 1, (num_samples,),
                                generator=generator, device=dev)

    def position(size: int) -> Tensor:
        hi = max(size - margin, margin + 1)
        return torch.randint(margin, hi, (num_samples, MAX_SOURCES),
                             generator=generator, device=dev).float()

    xs, ys, zs = position(w), position(h), position(d)
    intensity = torch.empty(num_samples, MAX_SOURCES, device=dev).uniform_(
        *INTENSITY_RANGE, generator=generator)
    active = (torch.arange(MAX_SOURCES, device=dev)[None, :]
              < num_sources[:, None]).float()
    return {"xyz": torch.stack([xs, ys, zs], dim=-1), "intensity": intensity,
            "active": active}


class SyntheticSmokeDataset3D:
    """Volume episodes generated (or read from the npz cache) once and kept
    on the device, float16 from `DEVICE_BYTES_LIMIT` float32 bytes on."""

    DEVICE_BYTES_LIMIT = 4_000_000_000

    def __init__(
        self,
        num_samples: int = 32,
        grid_size: Tuple[int, int, int] = (64, 64, 64),
        sequence_length: int = 20,
        cache_path: Optional[str] = None,
        seed: int = 0,
        chunk_size: int = 8,
        use_pallas: bool = False,
        device="cuda",
    ):
        self.grid_size = tuple(grid_size)
        self.sequence_length = sequence_length
        self.device = torch.device(device)
        _check_sequence_length(sequence_length)

        if cache_path and os.path.exists(cache_path):
            with np.load(cache_path) as f:
                self.data = {k: f[k] for k in f.files}
        else:
            voxels = int(np.prod(self.grid_size))
            chunk_size = max(1, min(chunk_size, CHUNK_VOXELS // voxels))
            params = sample_source_params3d(
                torch.Generator().manual_seed(seed), num_samples, self.grid_size)
            # decided from the predicted float32 bytes, before generating
            gen_f16 = num_samples * sequence_length * voxels * 4 >= self.DEVICE_BYTES_LIMIT
            seqs, labels = [], []
            for start in range(0, num_samples, chunk_size):
                chunk = slice(start, min(start + chunk_size, num_samples))
                s, l = simulate_episode3d(
                    params["xyz"][chunk].to(self.device),
                    params["intensity"][chunk].to(self.device),
                    params["active"][chunk].to(self.device),
                    grid_size=self.grid_size, num_steps=sequence_length,
                    use_pallas=use_pallas)
                s = s.cpu().numpy()
                seqs.append(s.astype(np.float16) if gen_f16 else s)
                labels.append(l.cpu().numpy())
            self.data = {
                "sequences": np.concatenate(seqs),
                "chaos": np.concatenate(labels),
                "source_xyz": params["xyz"].numpy(),
                "source_intensity": params["intensity"].numpy(),
                "source_active": params["active"].numpy(),
            }
            if cache_path:
                os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
                np.savez(cache_path, **self.data)

        seqs = self.data["sequences"]
        self._seq_f16 = seqs.dtype == np.float16 or seqs.nbytes >= self.DEVICE_BYTES_LIMIT
        self._sequences = torch.from_numpy(seqs).to(
            self.device, torch.float16 if self._seq_f16 else torch.float32)
        self._chaos = torch.from_numpy(np.asarray(self.data["chaos"], np.float32)).to(
            self.device)

    def __len__(self) -> int:
        return self._sequences.shape[0]

    def get_batch(self, sample_idx: Tensor, frame_idx: Tensor) -> Dict[str, Tensor]:
        """Episodes `sample_idx` at input frames `frame_idx`: input and
        target NDHWC [B, D, H, W, 1] float32, the chaos labels and the
        sequences [B, T, D, H, W] float32."""
        sample_idx = sample_idx.to(self.device)
        frame_idx = frame_idx.to(self.device)
        seqs = self._sequences[sample_idx].float()
        rows = torch.arange(seqs.shape[0], device=self.device)
        return {
            "input": seqs[rows, frame_idx][..., None],
            "target": seqs[rows, frame_idx + 1][..., None],
            "chaos_features": self._chaos[sample_idx],
            "sequence": seqs,
        }

    def sample_batch(self, generator: torch.Generator, batch_size: int) -> Dict[str, Tensor]:
        """`batch_size` episodes and input frames drawn with replacement."""
        dev = generator.device
        idx = torch.randint(0, len(self), (batch_size,), generator=generator, device=dev)
        frames = torch.randint(FRAME_RANGE[0], self.sequence_length + FRAME_RANGE[1],
                               (batch_size,), generator=generator, device=dev)
        return self.get_batch(idx, frames)

    def epoch_batches(
        self, generator: torch.Generator, batch_size: int, shuffle: bool = True
    ) -> Iterator[Dict[str, Tensor]]:
        """One pass over all episodes: shuffled for training (the ragged
        tail dropped), in order for validation (the tail kept)."""
        idx, frames, (tail, tail_frames) = epoch_index_arrays(
            generator, len(self), batch_size, self.sequence_length, shuffle)
        for b in range(idx.shape[0]):
            yield self.get_batch(idx[b], frames[b])
        if not shuffle and len(tail):
            yield self.get_batch(tail, tail_frames)


def create_data_loaders3d(
    batch_size: int = 1,
    num_train: int = 16,
    num_val: int = 4,
    grid_size: Tuple[int, int, int] = (128, 128, 128),
    cache_dir: Optional[str] = None,
    sequence_length: int = 20,
    seed: int = 0,
    use_pallas: bool = False,
    device="cuda",
) -> Tuple[SyntheticSmokeDataset3D, SyntheticSmokeDataset3D]:
    """Train and validation volume datasets (seeds `seed` and `seed + 1`),
    cached under `cache_dir` as {split}3d_{d}x{h}x{w}_T{T}_n{n}_s{s}.npz: the
    JAX package's file is read when it exists, else the port's own (the
    same name tagged `_torch`) is read or written."""

    def cache_path(split: str, n: int, s: int) -> Optional[str]:
        if not cache_dir:
            return None
        d, h, w = grid_size
        tag = f"{split}3d_{d}x{h}x{w}_T{sequence_length}_n{n}_s{s}"
        jax_written = os.path.join(cache_dir, f"{tag}.npz")
        if os.path.exists(jax_written):
            return jax_written
        return os.path.join(cache_dir, f"{tag}{CACHE_TAG}.npz")

    common = dict(grid_size=grid_size, sequence_length=sequence_length,
                  use_pallas=use_pallas, device=device)
    train = SyntheticSmokeDataset3D(num_samples=num_train, seed=seed,
                                    cache_path=cache_path("train", num_train, seed),
                                    **common)
    val = SyntheticSmokeDataset3D(num_samples=num_val, seed=seed + 1,
                                  cache_path=cache_path("val", num_val, seed + 1),
                                  **common)
    return train, val
