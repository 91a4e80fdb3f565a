"""Training: losses, the optimizer, train and eval steps, and `fit`.

Counterpart of the JAX package's `train/loop.py`, as a plain PyTorch loop:
loss = recon MSE + 0.1 chaos MSE + 0.05 physics, global-norm clipping at
1.0 then AdamW(lr, weight_decay) with the per-epoch cosine schedule, the
optional input noise (`training.noise_std`) and parameter EMA
(`training.ema_decay`), best-val and last checkpoints, `init_from`, a
resume that restores everything, the JAX trainer's TensorBoard
scalars through an optional `writer`, and a line of JSON per epoch in
<exp_dir>/epochs.jsonl. A 3-element `data.grid_size` trains
the volumetric SmokePhysNet3D through the same loop. The JAX package's
fused, staged and prefetched epoch programs are TPU dispatch workarounds
and are not ported.

Random streams: one `torch.Generator` seeded with `tpu.seed` on the
training device draws the initial weights and then every step's chaos
fields, dropout masks and input noise; a host generator with the same seed
draws the epoch order and input frames. Neither gives the JAX package's
threefry numbers.
"""
from __future__ import annotations

import copy
import json
import math
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from ..models.convert import jax_variables_to_state_dict, load_npz_variables
from ..models.layers import (
    BatchNorm,
    Conv,
    Conv3D,
    ConvTranspose2x,
    ConvTranspose3D2x,
    LayerNorm,
    Linear,
)
from ..models.net import SmokePhysNet
from ..models.net3d import SmokePhysNet3D
from ..models.regularizer import physics_losses
from .checkpoint import LAST_NAME, restore_checkpoint, save_checkpoint
from .serving import build_model

Tensor = torch.Tensor

CHAOS_LOSS_WEIGHT = 0.1
PHYSICS_LOSS_WEIGHT = 0.05
GRAD_CLIP_NORM = 1.0
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# fit's per-batch TensorBoard scalars: (tag, metric), as the JAX trainer's
BATCH_SCALARS = (("Train/Batch_Total_Loss", "total_loss"),
                 ("Train/Batch_Recon_Loss", "recon_loss"),
                 ("Train/Batch_Physics_Loss", "physics_loss"),
                 ("Train/Batch_Chaos_Loss", "chaos_loss"))
# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's truncated_normal)
TRUNCATED_NORMAL_STD = 0.87962566103423978


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


def init_parameters(model: SmokePhysNet | SmokePhysNet3D,
                    generator: torch.Generator) -> SmokePhysNet | SmokePhysNet3D:
    """Initial weights as the JAX package's layers draw them. Kernels and
    biases of the torch-style layers (all of the 2D model's, and the 3D
    model's convs, transposed convs and trunk) uniform in +-1/sqrt(fan_in)
    (fan_in of a transposed conv = C_out * 16 in 2D, C_out * 64 in 3D); the
    3D model's flax `nn.Dense` layers as flax draws them: `feature_proj` a
    uniform kernel and a zero bias, `dec`, `phys1` and `phys2` a
    lecun-normal kernel (normal truncated at two standard deviations, of
    variance 1 / fan_in) and a zero bias. Norm scales 1 and shifts 0,
    running statistics 0 and 1, the positional embedding N(0, 1)."""
    dev = generator.device

    def uniform_(t: Tensor, fan_in: int):
        bound = fan_in ** -0.5
        t.copy_(torch.rand(t.shape, generator=generator, device=dev) * (2 * bound) - bound)

    def lecun_normal_(t: Tensor, fan_in: int):
        # jax.random.truncated_normal(-2, 2) by the inverse CDF, scaled so
        # that the truncated distribution's variance is 1 / fan_in
        lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
        u = torch.rand(t.shape, generator=generator, device=dev) * (hi - lo) + lo
        std = fan_in ** -0.5 / TRUNCATED_NORMAL_STD
        t.copy_(math.sqrt(2.0) * torch.erfinv(u) * std)

    flax_dense = ({"feature_proj", "dec", "phys1", "phys2"}
                  if isinstance(model, SmokePhysNet3D) else set())
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (Linear, Conv, Conv3D)):
                fan_in = mod.weight[0].numel()
                if name in flax_dense:
                    (uniform_ if name == "feature_proj" else lecun_normal_)(mod.weight, fan_in)
                    mod.bias.zero_()
                else:
                    uniform_(mod.weight, fan_in)
                    uniform_(mod.bias, fan_in)
            elif isinstance(mod, (ConvTranspose2x, ConvTranspose3D2x)):
                fan_in = mod.weight[0].numel()  # C_out * the kernel's taps
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


def _refuse_mesh(config: Dict) -> None:
    tpu = config.get("tpu", {})
    data_axis, model_axis = int(tpu.get("data_axis", 1)), int(tpu.get("model_axis", 1))
    if data_axis * model_axis > 1:
        raise NotImplementedError(
            f"tpu.data_axis={data_axis} x tpu.model_axis={model_axis}: the "
            "data- and tensor-parallel mesh is not ported (one device only)")


def build_train_model(config: Dict, device="cuda") -> SmokePhysNet | SmokePhysNet3D:
    """SmokePhysNet, or SmokePhysNet3D for a 3-element `data.grid_size`,
    from config in training mode: compute type `tpu.train_compute_dtype`,
    `tpu.use_flash` and `tpu.fast_math` as the JAX package's
    `create_train_state` reads them (it never sets `fast_encoder`). A data-
    or tensor-parallel mesh (`tpu.data_axis` x `tpu.model_axis` > 1) is not
    ported and is refused."""
    _refuse_mesh(config)
    cfg = copy.deepcopy(config)
    tpu = cfg.setdefault("tpu", {})
    tpu["compute_dtype"] = tpu.get("train_compute_dtype", "float32")
    tpu["fast_encoder"] = False
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

    def __init__(self, model: SmokePhysNet | SmokePhysNet3D, config: Dict,
                 steps_per_epoch: int, generator: torch.Generator):
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
    writer=None,
    resume_from: Optional[str] = None,
    init_from: Optional[str] = None,
    log_every: int = 50,
    print_fn: Callable = print,
    device="cuda",
) -> Trainer:
    """Train for `training.num_epochs` epochs: each epoch a shuffled pass of
    train steps and an in-order validation pass, a best-val checkpoint when
    the validation loss improves and a last checkpoint at the end (each a
    `torch.save` of the whole state plus the npz export of the served
    weights). `init_from` starts from an npz export's weights with a fresh
    optimizer; `resume_from` (an experiment directory or a checkpoint
    file) restores everything and continues with the next epoch. A
    data- or tensor-parallel mesh is refused.

    `writer` (a TensorBoard `SummaryWriter`, or anything with its
    `add_scalar`) receives the JAX trainer's scalars: every `log_every`-th
    batch of an epoch its four losses (Train/Batch_Total_Loss, _Recon_,
    _Physics_, _Chaos_) at global step epoch * steps_per_epoch + batch,
    written at the epoch's end; each epoch Train/Epoch_Loss, Val/Epoch_Loss
    and Learning_Rate at the epoch. Each epoch also appends {epoch,
    train_loss, val_loss, lr (the rate of the epoch's steps), seconds} in
    full precision to <exp_dir>/epochs.jsonl."""
    _refuse_mesh(config)
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

    os.makedirs(exp_dir, exist_ok=True)
    for epoch in range(start_epoch, tc["num_epochs"]):
        t0 = time.time()
        epoch_lr = trainer.schedule(trainer.step)
        train_losses, batch_logs = [], []
        for batch_idx, b in enumerate(train_ds.epoch_batches(data_gen, batch_size,
                                                             shuffle=True)):
            metrics = trainer.train_step(b)
            train_losses.append(metrics["total_loss"])
            if writer is not None and batch_idx % log_every == 0:
                batch_logs.append((epoch * steps_per_epoch + batch_idx, metrics))
        # read back at the epoch's end: a read inside the loop would wait
        # for the card at every logged step
        for gs, metrics in batch_logs:
            for tag, key in BATCH_SCALARS:
                writer.add_scalar(tag, float(metrics[key]), gs)
        train_loss = float(torch.stack(train_losses).mean()) if train_losses else 0.0
        val_loss = evaluate(trainer, val_ds, batch_size, data_gen)
        trainer.epoch = epoch
        lr = trainer.schedule(trainer.step)
        if writer is not None:
            writer.add_scalar("Train/Epoch_Loss", train_loss, epoch)
            writer.add_scalar("Val/Epoch_Loss", val_loss, epoch)
            writer.add_scalar("Learning_Rate", lr, epoch)
        seconds = time.time() - t0
        print_fn(f"Epoch {epoch + 1}/{tc['num_epochs']}: train {train_loss:.4f} "
                 f"val {val_loss:.4f} lr {lr:.6f} ({seconds:.1f}s)")
        with open(os.path.join(exp_dir, "epochs.jsonl"), "a") as f:
            f.write(json.dumps({"epoch": epoch, "train_loss": train_loss,
                                "val_loss": val_loss, "lr": epoch_lr,
                                "seconds": seconds}) + "\n")
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
