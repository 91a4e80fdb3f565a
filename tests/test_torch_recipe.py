"""Recipe D on the CPU, at a tiny size.

The chain: phase 1 (`config_twophase_bf16.yaml` with `tpu.fast_math=false`)
for one epoch through the port's train CLI writes last_model.npz; phase 2
(`config_twophase_f32.yaml`) starts from it with `--init_from` and
`training.schedule_epoch_offset`, and its first step's learning rate is the
JAX package's `cosine_epoch_schedule` of phase 1 at that epoch (within
float32 rounding: the JAX schedule computes in float32, the port's in
float64). The per-epoch records the CLI writes (`epochs.jsonl`) carry it.

The trajectory (ROADMAP C.7: the port's recipe D misses the gate): several
train steps of both packages from the same weights, on the same batches
with the same chaos fields and dropout off, through the schedule's epoch
boundaries at phase 2's offset: the losses of every step, the BatchNorm
running statistics and the weights after the last one agree, so the
optimizer, the schedule and the statistics' updates are not where the
port's training parts from the JAX package's.
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
import smokephysai_tpu.models.chaos_attention as jca
import smokephysai_tpu.models.net as jnet
from smokephysai_tpu.models import SmokePhysNet as JaxNet
from smokephysai_tpu.train import loop as jloop
from smokephysai_tpu_torch.models.convert import (
    jax_variables_to_state_dict,
    load_npz_variables,
)
from smokephysai_tpu_torch.models.net import SmokePhysNet
from smokephysai_tpu_torch.train import loop
from smokephysai_tpu_torch.train.__main__ import main as train_main
from smokephysai_tpu_torch.utils.config import load_config
from test_torch_train import SMALL, _random_variables

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = ["data.grid_size=[32,32]", "simulation.grid_size=[32,32]", "data.num_train=4",
        "data.num_val=2", "training.batch_size=2", "model.input_dim=32",
        "model.hidden_dim=64", "model.num_layers=1", "model.num_heads=2",
        "model.output_channels=8"]
EPOCHS = 1


def _run(config, sets, extra=()):
    argv = ["--config", os.path.join(ROOT, "config", config), "--device", "cpu", *extra]
    for s in TINY + sets:
        argv += ["--set", s]
    start = int(time.time())
    exp_dir = train_main(argv)
    while int(time.time()) == start:  # the next run's directory is a new second's
        time.sleep(0.05)
    with open(os.path.join(exp_dir, "epochs.jsonl")) as f:
        return exp_dir, [json.loads(line) for line in f]


def test_recipe_d_chain_and_schedule_boundary(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.chdir(tmp_path)
    exp1, epochs1 = _run("config_twophase_bf16.yaml",
                         ["tpu.fast_math=false", f"training.num_epochs={EPOCHS}"])
    last1 = os.path.join(exp1, "last_model.npz")
    assert os.path.exists(last1)
    exp2, epochs2 = _run("config_twophase_f32.yaml",
                         [f"training.num_epochs={EPOCHS}",
                          f"training.schedule_epoch_offset={EPOCHS}"],
                         ["--init_from", last1])
    assert exp2 != exp1 and len(epochs1) == len(epochs2) == EPOCHS
    for e in epochs1 + epochs2:
        assert np.isfinite([e["train_loss"], e["val_loss"], e["lr"]]).all()
    steps_per_epoch = 4 // 2
    # phase 1's schedule (the config's 100-epoch period) at the boundary
    jax_lr = float(jloop.cosine_epoch_schedule(
        1e-3, EPOCHS, steps_per_epoch, 100)(EPOCHS * steps_per_epoch))
    port_lr = loop.cosine_epoch_schedule(1e-3, EPOCHS, steps_per_epoch, 100)(
        EPOCHS * steps_per_epoch)
    assert epochs2[0]["lr"] == port_lr
    np.testing.assert_allclose(epochs2[0]["lr"], jax_lr, rtol=1e-6, atol=0)
    assert epochs1[0]["lr"] == 1e-3 and epochs2[0]["lr"] < epochs1[0]["lr"]
    # phase 2 trained from phase 1's export: its first step moved those weights
    p1 = load_npz_variables(last1)["params"]
    p2 = load_npz_variables(os.path.join(exp2, "last_model.npz"))["params"]
    k1 = p1["phys2"]["kernel"]
    assert k1.shape == p2["phys2"]["kernel"].shape
    assert 0 < np.abs(p2["phys2"]["kernel"] - k1).max() < 0.01  # two Adam steps of ~1e-3
    payload = torch.load(os.path.join(exp2, "last_model.pt"), weights_only=False)
    assert payload["step"] == EPOCHS * steps_per_epoch


STEPS = 6
STEPS_PER_EPOCH = 2  # the learning rate changes every second step
PERIOD, OFFSET = 10, 3  # schedule_epochs and phase 2's schedule_epoch_offset


class _NoDropoutLayer(jnet.ChaosTransformerLayer):
    dropout: float = 0.0


def test_train_steps_follow_jax():
    """STEPS float32 train steps of the small model (einsum attention,
    batch-statistic BatchNorm, dropout off) on seeded batches with injected
    chaos fields, the cosine schedule at offset OFFSET of a PERIOD-epoch
    period, in both packages from the same weights. From random weights the
    physics loss swings from ~5e2 to ~3e4 and back in these steps, and the
    float32 noise of the first step (~6e-6) grows with it: the largest gaps
    read 3.2e-4 of a loss, 1.1e-3 in a running mean (of ~0.8) and 1.9e-3 of
    a weight's norm (the encoder's, where a pre-ReLU value near 0 falls on
    the other side of the kink). Held: every step's total, reconstruction,
    chaos and physics losses within rtol 1e-3; the BatchNorm running
    statistics after the last step within atol 5e-3; each weight within
    1e-2 of its norm (||d|| / ||ref||), but the biases that a
    batch-statistics BatchNorm or the softmax removes (their gradients are
    rounding noise on both sides)."""
    rng = np.random.default_rng(11)
    variables = _random_variables(rng)
    batches, fields = [], []
    for _ in range(STEPS):
        seq = rng.random((2, 12, 32, 32)).astype(np.float32)
        batches.append({"input": seq[:, 5, :, :, None], "target": seq[:, 6, :, :, None],
                        "chaos_features": rng.standard_normal((2, 3)).astype(np.float32),
                        "sequence": seq})
        fields.append((3.0 * rng.standard_normal(
            (SMALL["num_layers"], 2, 1024, 3))).astype(np.float32))
    config = load_config(None)
    config["training"].update(learning_rate=1e-3, num_epochs=STEPS // STEPS_PER_EPOCH,
                              weight_decay=0.01, schedule_epochs=PERIOD,
                              schedule_epoch_offset=OFFSET)

    # the JAX package's step (loop._make_step_impl's arithmetic) as one
    # program, run STEPS times
    model = JaxNet(**SMALL)
    tx = optax.chain(optax.clip_by_global_norm(jloop.GRAD_CLIP_NORM),
                     optax.adamw(jloop.cosine_epoch_schedule(
                         1e-3, STEPS // STEPS_PER_EPOCH, STEPS_PER_EPOCH, PERIOD, OFFSET),
                         weight_decay=0.01))
    held = {}

    def injected(key, b, seq_len):
        i = held["calls"] % SMALL["num_layers"]
        held["calls"] += 1
        return held["fields"][i][:, :seq_len]

    def step(params, batch_stats, opt_state, batch, step_fields):
        held.update(calls=0, fields=step_fields)

        def loss_fn(p):
            outputs, mutated = model.apply(
                {"params": p, "batch_stats": batch_stats}, batch["input"], train=True,
                rngs={"chaos": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                mutable=["batch_stats"])
            total, metrics = jloop.compute_losses(outputs, batch, config["physics"])
            return total, (metrics, mutated["batch_stats"])

        grads, (metrics, new_bs) = jax.grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, opt_state, metrics

    orig_field, orig_layer = jca.chaos_field, jnet.ChaosTransformerLayer
    jca.chaos_field, jnet.ChaosTransformerLayer = injected, _NoDropoutLayer
    try:
        jstep = jax.jit(step)
        params, bs = variables["params"], variables["batch_stats"]
        opt_state = tx.init(params)
        jax_losses = []
        for b, f in zip(batches, fields):
            params, bs, opt_state, metrics = jstep(
                params, bs, opt_state, {k: jnp.asarray(v) for k, v in b.items()},
                jnp.asarray(f))
            jax_losses.append({k: float(v) for k, v in metrics.items()})
    finally:
        jca.chaos_field, jnet.ChaosTransformerLayer = orig_field, orig_layer

    net = SmokePhysNet(**SMALL)
    net.load_state_dict(jax_variables_to_state_dict(variables))
    for layer in net.layers:
        layer.dropout = 0.0
    trainer = loop.Trainer(net, config, steps_per_epoch=STEPS_PER_EPOCH,
                           generator=torch.Generator().manual_seed(0))
    for i, (b, f) in enumerate(zip(batches, fields)):
        got = trainer.train_step({k: torch.from_numpy(np.ascontiguousarray(v))
                                  for k, v in b.items()},
                                 chaos_fields=[torch.from_numpy(x) for x in f])
        for key, want in jax_losses[i].items():
            np.testing.assert_allclose(float(got[key]), want, rtol=1e-3,
                                       err_msg=f"step {i} {key}")
    want_sd = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, bs)})
    got_sd = net.state_dict()
    removed = {"enc_conv1.bias", "enc_conv2.bias", "up1.bias", "up2.bias"} | {
        f"layer_{i}.chaos_attention.k_proj.bias" for i in range(SMALL["num_layers"])}
    for name, want in want_sd.items():
        got = got_sd[name]
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got, want, rtol=0, atol=5e-3, msg=name)
        elif name not in removed:
            rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
            assert rel <= 1e-2, (name, rel)
    assert trainer.step == STEPS
