"""Training: losses, the optimizer, train and eval steps, and `fit`.

Counterpart of the JAX package's `train/loop.py`, as a plain PyTorch loop:
loss = recon MSE + 0.1 chaos MSE + 0.05 physics, global-norm clipping at
1.0 then AdamW(lr, weight_decay) with the per-epoch cosine schedule, the
optional input noise (`training.noise_std`) and parameter EMA
(`training.ema_decay`), best-val and last checkpoints, `init_from` and a
resume that restores everything. The JAX package's fused, staged and
prefetched epoch programs are TPU dispatch workarounds and are not ported.

Random streams: one `torch.Generator` seeded with `tpu.seed` on the
training device draws the initial weights and then every step's chaos
fields, dropout masks and input noise; a host generator with the same seed
draws the epoch order and input frames. Neither gives the JAX package's
threefry numbers.
"""
from __future__ import annotations

import copy
import math
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from ..models.convert import jax_variables_to_state_dict, load_npz_variables
from ..models.layers import BatchNorm, Conv, ConvTranspose2x, LayerNorm, Linear
from ..models.net import SmokePhysNet
from ..models.regularizer import physics_losses
from .checkpoint import LAST_NAME, restore_checkpoint, save_checkpoint
from .serving import build_model

Tensor = torch.Tensor

CHAOS_LOSS_WEIGHT = 0.1
PHYSICS_LOSS_WEIGHT = 0.05
GRAD_CLIP_NORM = 1.0
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def cosine_epoch_schedule(
    base_lr: float, num_epochs: int, steps_per_epoch: int,
    schedule_epochs: int | None = None, epoch_offset: int = 0,
) -> Callable[[int], float]:
    """lr(step) = base * 0.5 * (1 + cos(pi * e / T)), e = the step's epoch
    plus `epoch_offset`, capped at T = `schedule_epochs` (default
    `num_epochs`): a cosine annealed once per epoch."""
    T = schedule_epochs or num_epochs

    def schedule(step: int) -> float:
        epoch = min(step // max(steps_per_epoch, 1) + epoch_offset, T)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / T))

    return schedule


def init_parameters(model: SmokePhysNet, generator: torch.Generator) -> SmokePhysNet:
    """Initial weights as the JAX package's layers draw them (torch's
    defaults): kernels and biases uniform in +-1/sqrt(fan_in) (fan_in of a
    transposed conv = C_out * 16), norm scales 1 and shifts 0, running
    statistics 0 and 1, the positional embedding N(0, 1)."""
    dev = generator.device

    def uniform_(t: Tensor, fan_in: int):
        bound = fan_in ** -0.5
        t.copy_(torch.rand(t.shape, generator=generator, device=dev) * (2 * bound) - bound)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Linear, Conv)):
                fan_in = mod.weight[0].numel()
                uniform_(mod.weight, fan_in)
                uniform_(mod.bias, fan_in)
            elif isinstance(mod, ConvTranspose2x):
                fan_in = mod.weight.shape[1] * 16
                uniform_(mod.weight, fan_in)
                uniform_(mod.bias, fan_in)
            elif isinstance(mod, (LayerNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
        model.pos_embedding.copy_(torch.randn(model.pos_embedding.shape,
                                              generator=generator, device=dev))
    return model


def build_train_model(config: Dict, device="cuda") -> SmokePhysNet:
    """SmokePhysNet from config in training mode: compute type
    `tpu.train_compute_dtype`, `tpu.use_flash` and `tpu.fast_math` as the
    JAX package's `create_train_state` reads them."""
    cfg = copy.deepcopy(config)
    tpu = cfg.setdefault("tpu", {})
    tpu["compute_dtype"] = tpu.get("train_compute_dtype", "float32")
    return build_model(cfg, device).train()


def compute_losses(
    outputs: Dict[str, Tensor], batch: Dict[str, Tensor], physics_cfg: Dict
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """total = recon + 0.1 chaos + 0.05 physics. The physics term sees the
    predicted and target densities and, where the batch carries it, the
    whole sequence; a batch without the sequence adds its precomputed
    per-episode continuity term instead (the same value)."""
    recon_loss = torch.mean((outputs["reconstructed"] - batch["target"]) ** 2)
    chaos_loss = torch.mean((outputs["physics_features"] - batch["chaos_features"]) ** 2)
    preds = {"density": outputs["reconstructed"]}
    if "sequence" in batch:
        preds["density_sequence"] = batch["sequence"]
    phys = physics_losses(
        preds, {"density": batch["target"]},
        conservation_weight=physics_cfg["conservation_weight"],
        continuity_weight=physics_cfg["continuity_weight"],
        energy_weight=physics_cfg["energy_weight"],
        mass_reduce="mean" if outputs["reconstructed"].dim() == 5 else "sum",
    )
    physics_loss = phys["total_physics_loss"]
    if "sequence" not in batch and "continuity" in batch:
        physics_loss = physics_loss + physics_cfg["continuity_weight"] * torch.mean(
            batch["continuity"])
    total = recon_loss + CHAOS_LOSS_WEIGHT * chaos_loss + PHYSICS_LOSS_WEIGHT * physics_loss
    return total, {"total_loss": total, "recon_loss": recon_loss,
                   "chaos_loss": chaos_loss, "physics_loss": physics_loss}


def clip_by_global_norm(grads: Sequence[Tensor], max_norm: float) -> Tensor:
    """optax's clip_by_global_norm, in place: g * min(1, max_norm / norm)
    with norm the global norm (clip_grad_norm_ would add 1e-6 to it). Two
    multi-tensor launches, whatever the number of gradients. Returns the
    norm (a device tensor: no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


class Trainer:
    """A model in training mode, its AdamW state, the optional EMA of its
    parameters and the step's random streams."""

    def __init__(self, model: SmokePhysNet, config: Dict, steps_per_epoch: int,
                 generator: torch.Generator):
        tc = config["training"]
        self.model = model
        self.physics_cfg = config["physics"]
        self.generator = generator
        self.noise_std = float(tc.get("noise_std", 0.0))
        self.ema_decay = float(tc.get("ema_decay", 0.0))
        self.schedule = cosine_epoch_schedule(
            tc["learning_rate"], tc["num_epochs"], steps_per_epoch,
            tc.get("schedule_epochs"), tc.get("schedule_epoch_offset", 0))
        self.optimizer = torch.optim.AdamW(
            model.parameters(), lr=self.schedule(0), betas=ADAM_BETAS,
            eps=ADAM_EPS, weight_decay=tc["weight_decay"])
        self.ema: Optional[Dict[str, Tensor]] = (
            {n: p.detach().clone() for n, p in model.named_parameters()}
            if self.ema_decay else None)
        self.step = 0
        self.epoch = 0

    def train_step(self, batch: Dict[str, Tensor],
                   chaos_fields: Sequence[Tensor] | None = None) -> Dict[str, Tensor]:
        """One optimizer step on `batch`. The chaos fields (unless given),
        the input noise and the dropout masks are drawn from the generator,
        in that order. Returns the losses and the global gradient norm
        before clipping, as device tensors."""
        model = self.model
        model.train()
        inp = batch["input"]
        if chaos_fields is None:
            chaos_fields = model.chaos_fields(self.generator, inp.shape[0], inp.device)
        if self.noise_std > 0.0:
            inp = inp + self.noise_std * torch.randn(
                inp.shape, generator=self.generator, device=inp.device)
        self.optimizer.zero_grad(set_to_none=True)
        outputs = model(inp, generator=self.generator, chaos_fields=chaos_fields)
        total, metrics = compute_losses(outputs, batch, self.physics_cfg)
        total.backward()
        metrics["grad_norm"] = self.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    def apply_gradients(self) -> Tensor:
        """The optimizer step on the parameters' `.grad`: clip by global
        norm, AdamW at the schedule's lr for this step, the EMA update.
        Returns the global norm before clipping."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        params = [p for p in self.model.parameters() if p.grad is not None]
        norm = clip_by_global_norm([p.grad for p in params], GRAD_CLIP_NORM)
        self.optimizer.step()
        if self.ema is not None:
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    e = self.ema[name]
                    e.copy_(e + (1.0 - self.ema_decay) * (p - e))
        self.step += 1
        return norm

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Losses of the eval-mode forward (running BatchNorm statistics, no
        dropout, the lean flash kernel) with the served parameters."""
        model = self.model
        model.eval()
        try:
            inp = batch["input"]
            fields = model.chaos_fields(self.generator, inp.shape[0], inp.device)
            if self.ema is None:
                outputs = model(inp, chaos_fields=fields)
            else:
                outputs = functional_call(model, self.ema, (inp,),
                                          {"chaos_fields": fields})
            _, metrics = compute_losses(outputs, batch, self.physics_cfg)
        finally:
            model.train()
        return metrics


def evaluate(trainer: Trainer, val_ds, batch_size: int,
             data_generator: torch.Generator) -> float:
    """Mean total loss over the validation set in order (the ragged tail
    kept), one eval step per batch."""
    losses = [trainer.eval_step(b)["total_loss"]
              for b in val_ds.epoch_batches(data_generator, batch_size, shuffle=False)]
    return float(torch.stack(losses).mean()) if losses else 0.0


def fit(
    config: Dict,
    train_ds,
    val_ds,
    exp_dir: str,
    resume_from: Optional[str] = None,
    init_from: Optional[str] = None,
    print_fn: Callable = print,
    device="cuda",
) -> Trainer:
    """Train for `training.num_epochs` epochs: each epoch a shuffled pass of
    train steps and an in-order validation pass, a best-val checkpoint when
    the validation loss improves and a last checkpoint at the end (each a
    `torch.save` of the whole state plus the npz export of the served
    weights). `init_from` starts from an npz export's weights with a fresh
    optimizer; `resume_from` (an experiment directory or a checkpoint
    file) restores everything and continues with the next epoch."""
    tc = config["training"]
    batch_size = tc["batch_size"]
    seed = int(config.get("tpu", {}).get("seed", 0))
    device = torch.device(device)
    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    gen = torch.Generator(device).manual_seed(seed)
    model = init_parameters(build_train_model(config, device), gen)
    if init_from:
        model.load_state_dict(jax_variables_to_state_dict(load_npz_variables(init_from)))
        print_fn(f"Initialised params from {init_from}")
    data_gen = torch.Generator().manual_seed(seed)
    trainer = Trainer(model, config, steps_per_epoch, gen)
    if trainer.ema_decay:
        print_fn(f"EMA enabled (decay {trainer.ema_decay})")
    if trainer.noise_std:
        print_fn(f"Input-noise augmentation (std {trainer.noise_std})")

    start_epoch = 0
    best_val_loss = val_loss = float("inf")
    if resume_from:
        meta = restore_checkpoint(resume_from, trainer, data_gen)
        start_epoch = int(meta.get("epoch", 0)) + 1
        best = meta.get("best_val_loss", meta.get("val_loss"))
        best_val_loss = float("inf") if best is None else float(best)
        print_fn(f"Resumed from {resume_from} at epoch {start_epoch}")

    for epoch in range(start_epoch, tc["num_epochs"]):
        t0 = time.time()
        train_losses = [
            trainer.train_step(b)["total_loss"]
            for b in train_ds.epoch_batches(data_gen, batch_size, shuffle=True)
        ]
        train_loss = float(torch.stack(train_losses).mean()) if train_losses else 0.0
        val_loss = evaluate(trainer, val_ds, batch_size, data_gen)
        trainer.epoch = epoch
        print_fn(f"Epoch {epoch + 1}/{tc['num_epochs']}: train {train_loss:.4f} "
                 f"val {val_loss:.4f} lr {trainer.schedule(trainer.step):.6f} "
                 f"({time.time() - t0:.1f}s)")
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            save_checkpoint(exp_dir, trainer, data_gen,
                            {"epoch": epoch, "val_loss": val_loss,
                             "best_val_loss": best_val_loss, "config": config})
    save_checkpoint(
        exp_dir, trainer, data_gen,
        {"epoch": trainer.epoch,
         "val_loss": val_loss if math.isfinite(val_loss) else None,
         "best_val_loss": best_val_loss if math.isfinite(best_val_loss) else None,
         "config": config},
        name=LAST_NAME,
    )
    return trainer
