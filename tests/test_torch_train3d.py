"""Training the port's volumetric SmokePhysNet3D against the JAX package, on
the CPU: one train step at 16^3, the initialisers, `fit` for two epochs with
its TensorBoard scalars, and the training CLI on a volumetric config.

The JAX variables come from `jax.eval_shape(init)` filled with numpy draws
(tests/test_torch_net3d.py's `random_variables`); inputs and per-layer
chaos fields are made with numpy from a seed and injected into both
models, with dropout off. Tolerances are stated per test.
"""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_threads  # noqa: F401  (each test worker's share of the cores)
import smokephysai_tpu.models.chaos_attention as jca
import smokephysai_tpu.models.net as jnet
from smokephysai_tpu.models import net3d as jnet3d
from smokephysai_tpu.train import loop as jloop
from smokephysai_tpu_torch.data.synthetic3d import create_data_loaders3d
from smokephysai_tpu_torch.models.convert import jax_variables_to_state_dict
from smokephysai_tpu_torch.models.net3d import SmokePhysNet3D
from smokephysai_tpu_torch.train import loop
from smokephysai_tpu_torch.train.__main__ import main as train_main
from smokephysai_tpu_torch.train.serving import load_model, make_predictor
from smokephysai_tpu_torch.utils.config import apply_overrides, load_config
from test_torch_net3d import random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config", "config_128cubed.yaml")
# tests/test_net3d.py's small volumetric model
SMALL = dict(hidden_dim=64, num_layers=1, num_heads=4, output_channels=8)
SMALL_SETS = ["data.grid_size=[16,16,16]", "simulation.grid_size=[16,16,16]",
              "model.hidden_dim=64", "model.num_layers=1", "model.num_heads=4",
              "model.output_channels=8"]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class _NoDropoutLayer(jnet.ChaosTransformerLayer):
    dropout: float = 0.0


@pytest.fixture(scope="module")
def jax_step3d():
    """One JAX train step of the small float32 SmokePhysNet3D (einsum) on a
    16^3 batch of one episode, from seeded variables, with injected chaos
    fields and dropout off: its metrics, gradients, updated params and
    batch_stats (numpy). One jit: one compile."""
    rng = np.random.default_rng(21)
    variables = random_variables(rng, **SMALL)
    seq = rng.random((1, 12, 16, 16, 16)).astype(np.float32)
    batch = {"input": seq[:, 5, ..., None], "target": seq[:, 6, ..., None],
             "chaos_features": rng.standard_normal((1, 3)).astype(np.float32),
             "sequence": seq}
    fields = [(3.0 * rng.standard_normal((1, 512, 3))).astype(np.float32)
              for _ in range(SMALL["num_layers"])]
    config = load_config(CONFIG)
    config["training"].update(num_epochs=10)
    model = jnet3d.SmokePhysNet3D(**SMALL)
    tx = optax.chain(optax.clip_by_global_norm(jloop.GRAD_CLIP_NORM),
                     optax.adamw(jloop.cosine_epoch_schedule(1e-3, 10, 4),
                                 weight_decay=0.01))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    calls = {"i": 0}

    def injected(key, b, seq_len):
        f = jnp.asarray(fields[calls["i"] % len(fields)][:, :seq_len])
        calls["i"] += 1
        return f

    def step(params, batch_stats):
        def loss_fn(p):
            outputs, mutated = model.apply(
                {"params": p, "batch_stats": batch_stats}, jbatch["input"], train=True,
                rngs={"chaos": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                mutable=["batch_stats"])
            total, metrics = jloop.compute_losses(outputs, jbatch, config["physics"])
            return total, (metrics, mutated["batch_stats"])

        grads, (metrics, new_bs) = jax.grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return grads, metrics, new_bs, optax.apply_updates(params, updates)

    orig_field, orig_layer = jca.chaos_field, jnet3d.ChaosTransformerLayer
    jca.chaos_field, jnet3d.ChaosTransformerLayer = injected, _NoDropoutLayer
    try:
        grads, metrics, new_bs, new_params = jax.jit(step)(
            variables["params"], variables["batch_stats"])
    finally:
        jca.chaos_field, jnet3d.ChaosTransformerLayer = orig_field, orig_layer
    assert calls["i"] == SMALL["num_layers"]
    np_tree = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)
    return {"variables": variables, "batch": batch, "fields": fields, "config": config,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": np_tree(grads), "params": np_tree(new_params),
            "batch_stats": np_tree(new_bs)}


def _state_dict_of(params, batch_stats):
    return {k: v.numpy() for k, v in jax_variables_to_state_dict(
        {"params": params, "batch_stats": batch_stats}).items()}


def _trainer(jax_step3d, **opts):
    model = SmokePhysNet3D(**SMALL, **opts)
    model.load_state_dict(jax_variables_to_state_dict(jax_step3d["variables"]))
    for layer in model.layers:
        layer.dropout = 0.0
    return loop.Trainer(model.train(), jax_step3d["config"], steps_per_epoch=4,
                        generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
def test_train_step_matches_jax(jax_step3d, use_flash):
    """One port train step of SmokePhysNet3D (batch statistics over (N, D,
    H, W), dropout off, the same chaos fields, the per-voxel mean mass term)
    against the JAX step: the losses rtol 1e-4; the updated batch_stats
    atol 1e-5; the global gradient norm rtol 1e-5 of the port's own
    gradients; each gradient tensor within 2e-3 of the JAX one's norm; the
    gradients zero in exact arithmetic (a bias before a batch-statistics
    BatchNorm; the key projection's bias) below 1e-7 of the global norm.
    With `use_flash` (head_dim 16) the attention is the flash autograd
    Function over its plain versions. The optimizer fed the JAX step's
    gradients gives the JAX step's updated params within two float32 ulps
    (atol 1e-7 + rtol 2.4e-7), as tests/test_torch_train.py holds the 2D
    optimizer."""
    trainer = _trainer(jax_step3d, use_flash=use_flash)
    model = trainer.model
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in jax_step3d["batch"].items()}
    fields = [torch.from_numpy(f) for f in jax_step3d["fields"]]
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in model.named_parameters()]
    metrics = trainer.train_step(batch, chaos_fields=fields)
    for h in hooks:
        h.remove()

    for key, want in jax_step3d["metrics"].items():
        np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-4, err_msg=key)
    jgrads = _state_dict_of(jax_step3d["grads"], {})
    assert set(grads) == set(jgrads)
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=1e-5)
    exact_zero = {"enc_conv1.bias", "enc_conv2.bias", "up1.bias", "up2.bias", "up3.bias"} | {
        f"layer_{i}.chaos_attention.k_proj.bias" for i in range(SMALL["num_layers"])}
    for name, want in jgrads.items():
        got = grads[name].numpy().astype(np.float64)
        if name in exact_zero:
            assert max(np.linalg.norm(got), np.linalg.norm(want)) <= 1e-7 * norm, name
        else:
            assert _rel(got, want.astype(np.float64)) <= 2e-3, name
    got_sd = model.state_dict()
    for name, want in _state_dict_of({}, jax_step3d["batch_stats"]).items():
        np.testing.assert_allclose(got_sd[name].numpy(), want, atol=1e-5, rtol=0,
                                   err_msg=name)

    fresh = _trainer(jax_step3d)
    for name, g in jax_variables_to_state_dict({"params": jax_step3d["grads"]}).items():
        fresh.model.get_parameter(name).grad = g
    fresh.apply_gradients()
    got_sd = fresh.model.state_dict()
    for name, want in _state_dict_of(jax_step3d["params"], {}).items():
        np.testing.assert_allclose(got_sd[name].numpy(), want, atol=1e-7, rtol=2.4e-7,
                                   err_msg=name)


def test_init_parameters_draws_the_jax_initialisers():
    """`init_parameters` on the full-width SmokePhysNet3D
    (config_128cubed.yaml): the torch-style layers (convs, transposed convs,
    the trunk) uniform within +-1/sqrt(fan_in), filling at least 0.9 of
    it; `feature_proj` a uniform kernel and a zero bias; `dec`, `phys1` and
    `phys2` (flax `nn.Dense` defaults) a zero bias and a normal kernel
    truncated at 2 sigma whose standard deviation is 1/sqrt(fan_in) within
    10 %; norms 1 and 0, running statistics 0 and 1."""
    model = loop.build_train_model(load_config(CONFIG), device="cpu")
    loop.init_parameters(model, torch.Generator().manual_seed(0))
    flax_dense = {"dec", "phys1", "phys2"}
    seen = set()
    for name, mod in model.named_modules():
        w = getattr(mod, "weight", None)
        if w is None or name.endswith(("norm1", "norm2")) or "bn" in name:
            continue
        w = w.detach()
        fan_in = w[0].numel()
        bound = fan_in ** -0.5
        if name in flax_dense:
            assert torch.count_nonzero(mod.bias) == 0, name
            std = bound / loop.TRUNCATED_NORMAL_STD
            assert float(w.abs().max()) <= 2 * std * (1 + 1e-6), name
            assert abs(float(w.std()) / bound - 1) < 0.1, name
        else:
            assert float(w.abs().max()) <= bound and float(w.abs().max()) >= 0.9 * bound, name
            if name == "feature_proj":
                assert torch.count_nonzero(mod.bias) == 0
            else:
                assert float(mod.bias.detach().abs().max()) <= bound, name
        seen.add(name)
    assert flax_dense | {"feature_proj", "enc_conv1", "up3", "recon_out"} <= seen
    for name in ("enc_bn1", "up_bn3", "layer_0.norm1"):
        mod = model.get_submodule(name)
        assert torch.all(mod.weight == 1) and torch.all(mod.bias == 0)
    assert torch.all(model.up_bn1.running_var == 1) and torch.all(model.up_bn1.running_mean == 0)
    assert abs(float(model.pos_embedding.detach().std()) - 1) < 0.02


class _RecordingWriter:
    def __init__(self, logdir=None):
        self.logdir, self.scalars, self.closed = logdir, [], False

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def close(self):
        self.closed = True


def test_fit_trains_the_volumetric_model_and_logs_scalars(tmp_path):
    """`fit` on a 16^3 cut of config_128cubed.yaml (hidden 64, 1 layer, 4
    heads; 4 + 2 episodes at batch 2; 2 epochs), as tests/test_net3d.py's
    `test_fit_3d_end_to_end` drives the JAX `fit`: 4 steps, both epochs
    logged, the last checkpoint served back through `load_model` with the
    trained weights. A recording writer gets the JAX trainer's scalars:
    at log_every 2 the four batch losses at global steps 0 and 2, the
    epoch losses and the learning rate at epochs 0 and 1, the last
    learning rate the schedule's after 4 steps."""
    config = apply_overrides(load_config(CONFIG), SMALL_SETS + [
        "data.num_train=4", "data.num_val=2", "training.batch_size=2",
        "training.num_epochs=2"])
    train_ds, val_ds = create_data_loaders3d(
        batch_size=2, num_train=4, num_val=2, grid_size=(16, 16, 16), sequence_length=12,
        seed=0, device="cpu")
    logs, writer = [], _RecordingWriter()
    trainer = loop.fit(config, train_ds, val_ds, str(tmp_path), writer=writer, log_every=2,
                       print_fn=logs.append, device="cpu")
    assert isinstance(trainer.model, SmokePhysNet3D) and trainer.step == 4
    assert any("Epoch 2/2" in line for line in logs)
    served = load_model(config, str(tmp_path / "last_model.npz"), device="cpu")
    trained = trainer.model.state_dict()
    assert all(torch.equal(v, trained[k]) for k, v in served.state_dict().items())
    batch_tags = [tag for tag, _ in loop.BATCH_SCALARS]
    want = [(tag, gs) for gs in (0, 2) for tag in batch_tags]
    want += [(tag, e) for e in (0, 1)
             for tag in ("Train/Epoch_Loss", "Val/Epoch_Loss", "Learning_Rate")]
    assert sorted((tag, step) for tag, _, step in writer.scalars) == sorted(want)
    values = {(tag, step): v for tag, v, step in writer.scalars}
    assert values[("Learning_Rate", 1)] == pytest.approx(trainer.schedule(4), rel=1e-12)
    assert all(np.isfinite(v) for v in values.values())


def test_cli_trains_the_volumetric_model_and_serves(tmp_path, monkeypatch):
    """`python -m smokephysai_tpu_torch.train --config config_128cubed.yaml`
    on the CPU, cut to 16^3, a small model, 2 + 1 episodes and one epoch:
    it builds the volume datasets, trains SmokePhysNet3D, opens its
    TensorBoard writer under <exp_dir>/logs (here a stand-in module, so
    the test does not import tensorboard) and closes it; the npz it writes
    serves finite volumes through `load_model`; a resume from the last
    checkpoint restores the step and the weights."""
    made = []

    class Writer(_RecordingWriter):
        def __init__(self, logdir):
            super().__init__(logdir)
            made.append(self)

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    monkeypatch.chdir(tmp_path)
    sets = SMALL_SETS + ["data.num_train=2", "data.num_val=1", "training.num_epochs=1"]
    argv = ["--config", CONFIG, "--device", "cpu"]
    for s in sets:
        argv += ["--set", s]
    exp_dir = train_main(argv)
    for name in ("best_model.pt", "best_model.npz", "last_model.pt", "last_model.npz"):
        assert os.path.exists(os.path.join(exp_dir, name)), name
    assert len(made) == 1 and made[0].logdir == os.path.join(exp_dir, "logs")
    assert made[0].closed and {t for t, _, _ in made[0].scalars} >= {"Train/Epoch_Loss"}
    config = apply_overrides(load_config(CONFIG), sets)
    model = load_model(config, os.path.join(exp_dir, "last_model.npz"), device="cpu")
    assert isinstance(model, SmokePhysNet3D)
    x = torch.rand(1, 16, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    out = make_predictor(model)(x)
    assert out["reconstructed"].shape == (1, 16, 16, 16, 1)
    assert torch.isfinite(out["reconstructed"]).all()
    assert torch.isfinite(out["physics_features"]).all()
    payload = torch.load(os.path.join(exp_dir, "last_model.pt"), weights_only=False)
    assert payload["step"] == 2 and payload["epoch"] == 0
    # resume: the 3D trainer's whole state comes back; no epoch is left to run
    exp2 = train_main(argv + ["--resume", os.path.join(exp_dir, "last_model.pt")])
    again = torch.load(os.path.join(exp2, "last_model.pt"), weights_only=False)
    assert again["step"] == 2
    for k, v in payload["model"].items():
        assert torch.equal(again["model"][k], v), k
