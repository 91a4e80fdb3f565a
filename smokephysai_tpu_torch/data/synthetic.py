"""Synthetic smoke dataset: batched episode generation on the card.

Counterpart of the JAX package's `data/synthetic.py`. Episodes are
generated in chunks of 64 by `physics.simulator.simulate_episode`, one
multi-step kernel launch per chunk with `use_pallas`. Source
randomisation has the JAX package's (and the reference's) distributions:
1-3 sources (inactive slots masked), positions uniform over the integers
of [20, size-20), intensity U(0.5, 2.0); the draws come from an explicit
`torch.Generator`, so they are not the JAX package's numbers. The npz cache
has the JAX package's keys and file names, so one cache serves both
packages.

A sample is a frame t in [5, T-5) as input, frame t+1 as target, the
episode's chaos label and either the whole sequence (for the continuity
term) or, where the sequence is not kept in float32 on the device, that
term precomputed per episode.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..physics.simulator import simulate_episode

Tensor = torch.Tensor

MAX_SOURCES = 3
SOURCE_MARGIN = 20
INTENSITY_RANGE = (0.5, 2.0)
FRAME_RANGE = (5, -5)
CHUNK_SIZE = 64


def _check_sequence_length(sequence_length: int) -> None:
    """The frame window [5, T-5) is empty for T <= 10: refuse it."""
    lo, hi = FRAME_RANGE[0], sequence_length + FRAME_RANGE[1]
    if hi <= lo:
        raise ValueError(
            f"sequence_length={sequence_length} leaves no valid input frame in "
            f"[{lo}, {hi}): need sequence_length > {lo - FRAME_RANGE[1]}"
        )


def epoch_order_frames(
    generator: torch.Generator, n: int, sequence_length: int, shuffle: bool
) -> Tuple[Tensor, Tensor]:
    """Episode visit order and per-episode input-frame draws for one epoch
    (int64, on the generator's device): a permutation when shuffling, then
    one frame in [5, T-5) per episode."""
    dev = generator.device
    order = (torch.randperm(n, generator=generator, device=dev) if shuffle
             else torch.arange(n, device=dev))
    frames = torch.randint(FRAME_RANGE[0], sequence_length + FRAME_RANGE[1], (n,),
                           generator=generator, device=dev)
    return order, frames


def epoch_index_arrays(
    generator: torch.Generator, n: int, batch_size: int, sequence_length: int,
    shuffle: bool,
) -> Tuple[Tensor, Tensor, Tuple[Tensor, Tensor]]:
    """[num_full_batches, B] episode and frame indices of one epoch, and
    the ragged tail's ([n % B] episodes and frames), which the shuffled
    training pass drops and validation serves as a last, smaller batch."""
    order, frames = epoch_order_frames(generator, n, sequence_length, shuffle)
    num_full = n // batch_size
    idx = order[: num_full * batch_size].reshape(num_full, batch_size)
    tail = order[num_full * batch_size:]
    return idx, frames[idx], (tail, frames[tail])


def sample_source_params(
    generator: torch.Generator, num_samples: int, grid_size: Tuple[int, int]
) -> Dict[str, Tensor]:
    """Random source configurations: {xy [N, 3, 2] (x, y), intensity
    [N, 3], active [N, 3]}, float32 on the generator's device. On a grid
    of 40 cells or fewer the position range [20, size-20) is empty and
    every position is 20, as jax.random.randint gives there."""
    h, w = grid_size
    dev = generator.device
    num_sources = torch.randint(1, MAX_SOURCES + 1, (num_samples,),
                                generator=generator, device=dev)

    def position(size: int) -> Tensor:
        hi = max(size - SOURCE_MARGIN, SOURCE_MARGIN + 1)
        return torch.randint(SOURCE_MARGIN, hi, (num_samples, MAX_SOURCES),
                             generator=generator, device=dev).float()

    xs, ys = position(w), position(h)
    intensity = torch.empty(num_samples, MAX_SOURCES, device=dev).uniform_(
        *INTENSITY_RANGE, generator=generator)
    active = (torch.arange(MAX_SOURCES, device=dev)[None, :]
              < num_sources[:, None]).float()
    return {"xy": torch.stack([xs, ys], dim=-1), "intensity": intensity,
            "active": active}


def generate_dataset(
    generator: torch.Generator,
    num_samples: int,
    grid_size: Tuple[int, int] = (128, 128),
    sequence_length: int = 20,
    dt: float = 0.01,
    viscosity: float = 0.001,
    chunk_size: int = CHUNK_SIZE,
    use_pallas: bool = False,
    vorticity_eps: float = 0.0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """`num_samples` episodes, simulated on `device` in chunks of
    `chunk_size`. Returns host arrays {sequences [N, T, H, W], chaos
    [N, 3], source_xy, source_intensity, source_active} (the cache's keys)."""
    params = sample_source_params(generator, num_samples, grid_size)
    seqs, labels = [], []
    for start in range(0, num_samples, chunk_size):
        chunk = slice(start, min(start + chunk_size, num_samples))
        s, l = simulate_episode(
            params["xy"][chunk].to(device), params["intensity"][chunk].to(device),
            params["active"][chunk].to(device), grid_size=tuple(grid_size),
            num_steps=sequence_length, dt=dt, viscosity=viscosity,
            use_pallas=use_pallas, vorticity_eps=vorticity_eps,
        )
        seqs.append(s.cpu().numpy())
        labels.append(l.cpu().numpy())
    return {
        "sequences": np.concatenate(seqs),
        "chaos": np.concatenate(labels),
        "source_xy": params["xy"].cpu().numpy(),
        "source_intensity": params["intensity"].cpu().numpy(),
        "source_active": params["active"].cpu().numpy(),
    }


def gather_device_batch(
    sequences: Tensor, chaos: Tensor, continuity: Tensor,
    sample_idx: Tensor, frame_idx: Tensor, seq_f16: bool,
) -> Dict[str, Tensor]:
    """A batch from the dataset's device tensors: input and target frames
    NHWC [B, H, W, 1] float32, the chaos labels, the per-episode continuity
    term and, for float32 storage, the whole sequences [B, T, H, W]."""
    sample_idx = sample_idx.to(sequences.device)
    frame_idx = frame_idx.to(sequences.device)
    seqs = sequences[sample_idx]
    rows = torch.arange(seqs.shape[0], device=seqs.device)
    batch = {
        "input": seqs[rows, frame_idx][..., None].float(),
        "target": seqs[rows, frame_idx + 1][..., None].float(),
        "chaos_features": chaos[sample_idx],
        "continuity": continuity[sample_idx],
    }
    if not seq_f16:
        batch["sequence"] = seqs
    return batch


class SyntheticSmokeDataset:
    """Episodes generated (or read from the npz cache) once, kept on the
    device when they fit: float32 under `DEVICE_BYTES_LIMIT` bytes, float16
    storage when only half the bytes fit (the frames are cast back to
    float32 per batch and the continuity term comes from float32
    per-episode constants), on the host otherwise."""

    DEVICE_BYTES_LIMIT = 4e9

    def __init__(
        self,
        num_samples: int = 1000,
        grid_size: Tuple[int, int] = (128, 128),
        sequence_length: int = 20,
        cache_path: Optional[str] = None,
        seed: int = 0,
        use_pallas: bool = False,
        vorticity_eps: float = 0.0,
        device="cuda",
    ):
        self.num_samples = num_samples
        self.grid_size = tuple(grid_size)
        self.sequence_length = sequence_length
        self.device = torch.device(device)
        _check_sequence_length(sequence_length)

        if cache_path and os.path.exists(cache_path):
            with np.load(cache_path) as f:
                self.data = {k: f[k] for k in f.files}
            print(f"Loaded synthetic data from {cache_path}")
        else:
            self.data = generate_dataset(
                torch.Generator().manual_seed(seed), num_samples, self.grid_size,
                sequence_length, use_pallas=use_pallas,
                vorticity_eps=vorticity_eps, device=self.device,
            )
            if cache_path:
                os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
                np.savez(cache_path, **self.data)
                print(f"Saved synthetic data to {cache_path}")

        seqs = self.data["sequences"]
        fits_f32 = seqs.nbytes < self.DEVICE_BYTES_LIMIT
        self._seq_f16 = (not fits_f32) and seqs.nbytes / 2 < self.DEVICE_BYTES_LIMIT
        self._on_device = fits_f32 or self._seq_f16
        if self._on_device:
            self._sequences = torch.from_numpy(seqs).to(
                self.device, torch.float16 if self._seq_f16 else torch.float32)
        else:
            self._sequences = seqs
        continuity = (
            np.mean(np.abs(np.diff(seqs, axis=1)), axis=(1, 2, 3))
            if seqs.shape[1] > 1 else np.zeros(seqs.shape[0], np.float32)
        )
        self._chaos = torch.from_numpy(np.asarray(self.data["chaos"], np.float32)).to(self.device)
        self._continuity = torch.from_numpy(np.asarray(continuity, np.float32)).to(self.device)

    def __len__(self) -> int:
        return self._sequences.shape[0]

    def get_batch(self, sample_idx: Tensor, frame_idx: Tensor) -> Dict[str, Tensor]:
        """The batch of episodes `sample_idx` at input frames `frame_idx`
        (int64). Host-resident datasets send only the two frames, the labels
        and the continuity term to the device, no sequence."""
        if self._on_device:
            return gather_device_batch(self._sequences, self._chaos, self._continuity,
                                       sample_idx, frame_idx, self._seq_f16)
        si, fi = np.asarray(sample_idx.cpu()), np.asarray(frame_idx.cpu())
        frames = torch.from_numpy(np.stack(
            [self._sequences[si, fi], self._sequences[si, fi + 1]], axis=-1)).to(self.device)
        idx = sample_idx.to(self.device)
        return {
            "input": frames[..., :1],
            "target": frames[..., 1:],
            "chaos_features": self._chaos[idx],
            "continuity": self._continuity[idx],
        }

    def epoch_batches(
        self, generator: torch.Generator, batch_size: int, shuffle: bool = True
    ) -> Iterator[Dict[str, Tensor]]:
        """One pass over all episodes in batches: shuffled for training
        (the ragged tail dropped), in order for validation (the tail
        kept)."""
        idx, frames, (tail, tail_frames) = epoch_index_arrays(
            generator, len(self), batch_size, self.sequence_length, shuffle)
        for b in range(idx.shape[0]):
            yield self.get_batch(idx[b], frames[b])
        if not shuffle and len(tail):
            yield self.get_batch(tail, tail_frames)


def create_data_loaders(
    batch_size: int = 16,
    num_train: int = 800,
    num_val: int = 200,
    grid_size: Tuple[int, int] = (128, 128),
    cache_dir: Optional[str] = None,
    sequence_length: int = 20,
    seed: int = 0,
    use_pallas: bool = False,
    vorticity_eps: float = 0.0,
    device="cuda",
) -> Tuple[SyntheticSmokeDataset, SyntheticSmokeDataset]:
    """Train and validation datasets (seeds `seed` and `seed + 1`), cached
    under `cache_dir` with the JAX package's file names, which encode the
    grid, sequence length, size, seed and vorticity."""

    def cache_path(split: str, n: int, s: int) -> Optional[str]:
        if not cache_dir:
            return None
        h, w = grid_size
        tag = f"{split}_{h}x{w}_T{sequence_length}_n{n}_s{s}"
        if vorticity_eps:
            tag += f"_vort{vorticity_eps:g}"
        return os.path.join(cache_dir, f"{tag}.npz")

    common = dict(grid_size=grid_size, sequence_length=sequence_length,
                  use_pallas=use_pallas, vorticity_eps=vorticity_eps, device=device)
    train = SyntheticSmokeDataset(num_samples=num_train, seed=seed,
                                  cache_path=cache_path("train", num_train, seed),
                                  **common)
    val = SyntheticSmokeDataset(num_samples=num_val, seed=seed + 1,
                                cache_path=cache_path("val", num_val, seed + 1),
                                **common)
    return train, val
