"""The port's training slice against the JAX package, on the CPU: the
regularizer and losses, the schedule, one train step of a small model, the
EMA, and the training CLI (the flash attention training pair is held in
tests/test_torch_attention.py).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are stated per test.
"""
import copy
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.tree_util import keystr

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
from smokephysai_tpu_torch.models.regularizer import physics_losses
from smokephysai_tpu_torch.train import loop
from smokephysai_tpu_torch.train.__main__ import main as train_main
from smokephysai_tpu_torch.train.serving import load_model, make_predictor
from smokephysai_tpu_torch.utils.config import load_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))

# ---------------------------------------------------------------- losses


def test_regularizer_matches_golden():
    """The four physics terms and their total against the torch
    reference's recorded values (tests/goldens/regularizer.npz), rtol 1e-5
    as tests/test_models.py holds the JAX package to the same file."""
    g = np.load(os.path.join(GOLDENS, "regularizer.npz"))
    inputs = {"density": g["dens_p"], "density_sequence": g["seq"], "velocity": g["vel"]}
    out = physics_losses({k: torch.from_numpy(v) for k, v in inputs.items()},
                         {"density": torch.from_numpy(g["dens_t"])})
    for key in ("mass_conservation", "continuity", "energy_conservation",
                "divergence", "total_physics_loss"):
        np.testing.assert_allclose(float(out[key]), float(g[key]), rtol=1e-5, err_msg=key)
    assert set(physics_losses({"density_sequence": torch.ones(1, 3, 4, 4)})) == {
        "continuity", "total_physics_loss"}


@pytest.mark.parametrize("with_sequence", [True, False], ids=["sequence", "continuity"])
def test_compute_losses_matches_jax(with_sequence):
    """`compute_losses` against the JAX package's on the same outputs and
    batch: with the whole sequence, and with the precomputed per-episode
    continuity term in its place. rtol 1e-4: the mass term squares the
    difference of two float32 sums of 256 values near 0.5, whose rounding
    (summed in another order on each side) is ~1e-4 of that difference."""
    rng = np.random.default_rng(4)
    outputs = {"reconstructed": rng.random((3, 16, 16, 1)).astype(np.float32),
               "physics_features": rng.standard_normal((3, 3)).astype(np.float32)}
    seq = rng.random((3, 12, 16, 16)).astype(np.float32)
    batch = {"target": seq[:, 6, :, :, None], "chaos_features":
             rng.standard_normal((3, 3)).astype(np.float32)}
    if with_sequence:
        batch["sequence"] = seq
    else:
        batch["continuity"] = np.mean(np.abs(np.diff(seq, axis=1)), axis=(1, 2, 3))
    cfg = load_config(None)["physics"]
    # one compile of the whole function (eagerly, each operation compiles alone)
    jtotal, jm = jax.jit(lambda o, b: jloop.compute_losses(o, b, cfg))(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    total, m = loop.compute_losses({k: torch.from_numpy(v) for k, v in outputs.items()},
                                   {k: torch.from_numpy(np.ascontiguousarray(v))
                                    for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    for key in jm:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("epochs,spe,sched_epochs,offset",
                         [(10, 7, None, 0), (30, 4, 100, 70)],
                         ids=["plain", "two-phase"])
def test_cosine_schedule_matches_jax(epochs, spe, sched_epochs, offset):
    """lr at every step of the run (and past its end) against the JAX
    schedule, rtol 1e-6 plus atol 1e-10: JAX computes it in float32, where
    1 + cos(pi e / T) near e = T keeps the absolute float32 error of the
    cosine (~6e-8, times base_lr / 2)."""
    jsched = jloop.cosine_epoch_schedule(1e-3, epochs, spe, sched_epochs, offset)
    sched = loop.cosine_epoch_schedule(1e-3, epochs, spe, sched_epochs, offset)
    steps = np.arange(0, (epochs + 2) * spe)
    np.testing.assert_allclose([sched(int(s)) for s in steps],
                               np.asarray(jax.jit(jax.vmap(jsched))(jnp.asarray(steps))),
                               rtol=1e-6, atol=1e-10)


# ---------------------------------------------------------------- train step

SMALL = dict(input_dim=32, hidden_dim=64, num_layers=2, num_heads=2)


def _random_variables(rng):
    """Variables of the small JAX model: the tree of its `init` (from
    jax.eval_shape, which compiles nothing) filled with numpy draws at an
    initialised model's scale."""
    shapes = jax.eval_shape(
        JaxNet(**SMALL).init,
        {"params": jax.random.PRNGKey(0), "chaos": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 1)))

    def fill(path, s):
        name = keystr(path)
        if name.endswith("['mean']"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "pos_embedding" in name:
            return rng.standard_normal(s.shape).astype(np.float32)
        fan = s.shape[1] * 16 if name.endswith("['weight']") else int(np.prod(s.shape[:-1]))
        return rng.uniform(-fan ** -0.5, fan ** -0.5, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


class _NoDropoutLayer(jnet.ChaosTransformerLayer):
    dropout: float = 0.0


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step of the small float32 model (einsum attention)
    from seeded variables, on a seeded batch with injected chaos fields and
    dropout off: its loss metrics, gradients, updated params and
    batch_stats (numpy)."""
    rng = np.random.default_rng(5)
    variables = _random_variables(rng)
    seq = rng.random((2, 12, 32, 32)).astype(np.float32)
    batch = {"input": seq[:, 5, :, :, None], "target": seq[:, 6, :, :, None],
             "chaos_features": rng.standard_normal((2, 3)).astype(np.float32),
             "sequence": seq}
    fields = [(3.0 * rng.standard_normal((2, 1024, 3))).astype(np.float32)
              for _ in range(SMALL["num_layers"])]
    config = load_config(None)
    config["training"].update(learning_rate=1e-3, num_epochs=10, weight_decay=0.01)

    model = JaxNet(**SMALL)
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
        """The JAX package's train step (loop._make_step_impl) with its
        gradients exposed, as one program: one compile."""
        state = jloop.TrainState(
            step=jnp.int32(0), epoch=jnp.int32(0), params=params,
            batch_stats=batch_stats, opt_state=tx.init(params), tx=tx,
            apply_fn=model.apply)

        def loss_fn(p):
            outputs, mutated = state.apply_fn(
                {"params": p, "batch_stats": state.batch_stats}, jbatch["input"],
                train=True, rngs={"chaos": jax.random.PRNGKey(0),
                                  "dropout": jax.random.PRNGKey(1)},
                mutable=["batch_stats"])
            total, metrics = jloop.compute_losses(outputs, jbatch, config["physics"])
            return total, (metrics, mutated["batch_stats"])

        grads, (metrics, new_bs) = jax.grad(loss_fn, has_aux=True)(state.params)
        updates, _ = state.tx.update(grads, state.opt_state, state.params)
        return grads, metrics, new_bs, optax.apply_updates(state.params, updates)

    orig_field, orig_layer = jca.chaos_field, jnet.ChaosTransformerLayer
    jca.chaos_field, jnet.ChaosTransformerLayer = injected, _NoDropoutLayer
    try:
        grads, metrics, new_bs, new_params = jax.jit(step)(
            variables["params"], variables["batch_stats"])
    finally:
        jca.chaos_field, jnet.ChaosTransformerLayer = orig_field, orig_layer
    np_tree = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)
    return {"variables": variables, "batch": batch, "fields": fields, "config": config,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": np_tree(grads), "params": np_tree(new_params),
            "batch_stats": np_tree(new_bs)}


def _state_dict_of(params, batch_stats):
    return {k: v.numpy() for k, v in jax_variables_to_state_dict(
        {"params": params, "batch_stats": batch_stats}).items()}


def _port_trainer(jax_step, **model_opts):
    model = SmokePhysNet(**SMALL, **model_opts)
    model.load_state_dict(jax_variables_to_state_dict(jax_step["variables"]))
    for layer in model.layers:
        layer.dropout = 0.0
    return loop.Trainer(model, jax_step["config"], steps_per_epoch=4,
                        generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("use_flash,split", [(False, False), (True, False), (True, True)],
                         ids=["einsum", "flash", "flash-split"])
def test_train_step_matches_jax(jax_step, monkeypatch, use_flash, split):
    """One port train step (batch-statistic BatchNorm, dropout off, the same
    chaos fields) against the JAX step above: the losses rtol 1e-4; the
    updated batch_stats atol 1e-5; the global gradient norm rtol 1e-5 of
    the port's own gradients; each gradient tensor within 2e-3 of the JAX
    one's norm (||d|| / ||ref||). Most agree to ~5e-5; the encoder's and
    pos_embedding's pick up ~1e-3 where a pre-ReLU value within float32
    noise of 0 in the decoder falls on the other side of the kink (one 2x2
    block of tokens here). The gradients that are zero in exact arithmetic
    (a bias feeding a batch-statistics BatchNorm, which removes it, and the
    key projection's bias, which shifts every score of a row alike) are
    rounding noise on both sides: each must be below 1e-7 of the global
    norm. With `use_flash` the port's attention is the autograd Function
    over the plain flash pair, held against the JAX model's einsum path;
    with `split` the step runs under SMOKEPHYS_FUSED_BWD=0, the split
    route, whose CPU backward is the same plain backward: the variable
    leaves the step as it is."""
    if split:
        monkeypatch.setenv("SMOKEPHYS_FUSED_BWD", "0")
    trainer = _port_trainer(jax_step, use_flash=use_flash)
    model = trainer.model
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in jax_step["batch"].items()}
    fields = [torch.from_numpy(f) for f in jax_step["fields"]]

    # the gradients before the optimizer: the step's own backward, captured
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in model.named_parameters()]
    metrics = trainer.train_step(batch, chaos_fields=fields)
    for h in hooks:
        h.remove()

    for key, want in jax_step["metrics"].items():
        np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-4, err_msg=key)
    jgrads = _state_dict_of(jax_step["grads"], {})
    assert set(grads) == set(jgrads)
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=1e-5)
    exact_zero = {"enc_conv1.bias", "enc_conv2.bias", "up1.bias", "up2.bias"} | {
        f"layer_{i}.chaos_attention.k_proj.bias" for i in range(SMALL["num_layers"])}
    for name, want in jgrads.items():
        got = grads[name].numpy().astype(np.float64)
        if name in exact_zero:
            assert max(np.linalg.norm(got), np.linalg.norm(want)) <= 1e-7 * norm, name
        else:
            assert _rel(got, want.astype(np.float64)) <= 2e-3, name
    got_sd = model.state_dict()
    for name, want in _state_dict_of({}, jax_step["batch_stats"]).items():
        np.testing.assert_allclose(got_sd[name].numpy(), want, atol=1e-5, rtol=0,
                                   err_msg=name)
    assert trainer.step == 1


def test_optimizer_matches_jax(jax_step):
    """The port's optimizer step (global-norm clip at 1.0, then AdamW at the
    schedule's first lr) on the JAX step's gradients gives the JAX step's
    updated params within two float32 ulps (atol 1e-7 + rtol 2.4e-7: the
    two round the AdamW arithmetic in another order). Fed the port's own
    gradients instead, Adam's
    first step g / (|g| + 1e-8) turns float32 noise in gradients near zero
    into steps of up to lr, so the optimizer is held to JAX on the same
    gradients."""
    trainer = _port_trainer(jax_step)
    for name, g in jax_variables_to_state_dict({"params": jax_step["grads"]}).items():
        trainer.model.get_parameter(name).grad = g
    trainer.apply_gradients()
    got_sd = trainer.model.state_dict()
    for name, want in _state_dict_of(jax_step["params"], {}).items():
        np.testing.assert_allclose(got_sd[name].numpy(), want, atol=1e-7, rtol=2.4e-7,
                                   err_msg=name)
    assert trainer.step == 1


# ---------------------------------------------------------------- CLI


def test_cli_trains_one_epoch_and_serves(tmp_path, monkeypatch):
    """`python -m smokephysai_tpu_torch.train` on the CPU: one epoch of the
    fast recipe (bf16, flash, fast_math) cut to a 32^2 grid, 4 training and
    2 validation episodes and a small model; the npz it writes loads through
    `load_model` and serves finite predictions; a resume from the last
    checkpoint restores the step. tensorboard is made unimportable (where
    TensorFlow is installed its import loads it, ~20 s): the CLI goes on
    without its writer, as the JAX CLI does."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.chdir(tmp_path)
    sets = ["data.grid_size=[32,32]", "simulation.grid_size=[32,32]",
            "data.num_train=4", "data.num_val=2", "training.num_epochs=1",
            "training.batch_size=2", "model.input_dim=32", "model.hidden_dim=128",
            "model.num_layers=2", "model.num_heads=2"]
    config_path = os.path.join(ROOT, "config", "config_train_fast.yaml")
    argv = ["--config", config_path, "--device", "cpu"]
    for s in sets:
        argv += ["--set", s]
    exp_dir = train_main(argv)
    for name in ("best_model.pt", "best_model.npz", "last_model.pt", "last_model.npz",
                 "meta.json", "last_model_meta.json"):
        assert os.path.exists(os.path.join(exp_dir, name)), name
    # the port's own cache names: a JAX run never reads these episodes
    assert sorted(os.listdir("cache")) == ["train_32x32_T20_n4_s0_torch.npz",
                                           "val_32x32_T20_n2_s1_torch.npz"]
    config = load_config(config_path)
    for s in sets:
        section, rest = s.split(".", 1)
        key, value = rest.split("=")
        config[section][key] = eval(value)
    model = load_model(config, os.path.join(exp_dir, "last_model.npz"), device="cpu")
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    out = make_predictor(model)(x)
    assert out["reconstructed"].shape == (2, 32, 32, 1)
    assert torch.isfinite(out["reconstructed"]).all()
    assert torch.isfinite(out["physics_features"]).all()
    payload = torch.load(os.path.join(exp_dir, "last_model.pt"), weights_only=False)
    assert payload["step"] == 2 and payload["epoch"] == 0
    variables = load_npz_variables(os.path.join(exp_dir, "last_model.npz"))
    assert set(variables) == {"params", "batch_stats"}
    # resume: the next run starts after the last epoch and trains no step
    exp2 = train_main(argv + ["--resume", os.path.join(exp_dir, "last_model.pt")])
    assert torch.load(os.path.join(exp2, "last_model.pt"),
                      weights_only=False)["step"] == 2
    assert glob.glob(os.path.join(exp2, "last_model.npz"))


def test_resume_auto_takes_the_newest_experiment(tmp_path, monkeypatch):
    """`--resume auto` resumes the newest experiment directory (by its
    timestamped name) that holds best_model.pt, and starts afresh when there
    is none, as the JAX CLI's `latest_checkpoint` does. `fit`, the data and
    tensorboard are stubbed: only the argument handed to `fit` is
    checked."""
    from smokephysai_tpu_torch.train import __main__ as cli
    from smokephysai_tpu_torch.train.checkpoint import latest_checkpoint

    monkeypatch.chdir(tmp_path)
    assert latest_checkpoint() is None
    for name, has_ckpt in (("smokephys_20260101_000000", True),
                           ("smokephys_20260301_000000", False),
                           ("smokephys_20260201_000000", True)):
        os.makedirs(os.path.join("experiments", name))
        if has_ckpt:
            open(os.path.join("experiments", name, "best_model.pt"), "wb").close()
    newest = os.path.join("experiments", "smokephys_20260201_000000")
    assert latest_checkpoint() == newest
    seen = []
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(cli, "create_data_loaders", lambda **kw: (None, None))
    monkeypatch.setattr(cli, "fit", lambda *a, resume_from, **kw: seen.append(resume_from))
    argv = ["--config", os.path.join(ROOT, "config", "config_64.yaml"), "--device", "cpu"]
    cli.main(argv + ["--resume", "auto"])
    cli.main(argv)
    assert seen == [newest, None]


def test_fit_refuses_a_mesh():
    """`tpu.data_axis` x `tpu.model_axis` > 1 asks for the JAX package's
    data- and tensor-parallel mesh, which is not ported: refused before any
    training, not ignored."""
    config = load_config(os.path.join(ROOT, "config", "config_64.yaml"))
    for axes in ({"data_axis": 2}, {"model_axis": 2}):
        cfg = copy.deepcopy(config)
        cfg["tpu"].update(axes)
        with pytest.raises(NotImplementedError, match="mesh"):
            loop.build_train_model(cfg, "cpu")
        with pytest.raises(NotImplementedError, match="mesh"):
            loop.fit(cfg, [], [], "unused", device="cpu")


def test_cached_image_matrices_serve_a_later_backward():
    """A pooling or resize matrix first cached by an inference-mode call (the
    serving predictor) is still saved for a later training backward."""
    from smokephysai_tpu_torch.ops.image import adaptive_avg_pool2d, interpolate_bilinear

    with torch.inference_mode():
        adaptive_avg_pool2d(torch.rand(1, 2, 12, 12), (4, 4))
        interpolate_bilinear(torch.rand(1, 2, 4, 4), (12, 12))
    x = torch.rand(1, 2, 12, 12, requires_grad=True)
    interpolate_bilinear(adaptive_avg_pool2d(x, (4, 4)), (12, 12)).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_ema_noise_and_export(tmp_path):
    """training.ema_decay and training.noise_std: after one step the EMA is
    e + (1 - decay) (p - e) of the initial and updated parameters (atol
    1e-7); the eval pass with the EMA equals the eval pass of the model
    holding the EMA weights (the same running statistics and chaos fields);
    the npz export holds the EMA weights while the model keeps its own; the
    noise is drawn from the step's generator, so a step with it differs
    from one without."""
    from smokephysai_tpu_torch.train.checkpoint import export_npz

    def trainer_for(**training):
        config = load_config(None)
        config["training"].update(num_epochs=2, **training)
        model = loop.init_parameters(SmokePhysNet(**SMALL),
                                     torch.Generator().manual_seed(0))
        return loop.Trainer(model, config, steps_per_epoch=2,
                            generator=torch.Generator().manual_seed(1))

    seq = torch.rand(2, 12, 32, 32, generator=torch.Generator().manual_seed(2))
    batch = {"input": seq[:, 5, :, :, None].contiguous(),
             "target": seq[:, 6, :, :, None].contiguous(),
             "chaos_features": torch.zeros(2, 3), "sequence": seq}
    trainer = trainer_for(ema_decay=0.9, noise_std=0.01)
    model = trainer.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    noisy = trainer.train_step(batch)["total_loss"]
    clean = trainer_for(ema_decay=0.9).train_step(batch)["total_loss"]
    assert float(noisy) != float(clean)
    for name, p in model.named_parameters():
        want = before[name] + 0.1 * (p.detach() - before[name])
        torch.testing.assert_close(trainer.ema[name], want, atol=1e-7, rtol=0)

    state = trainer.generator.get_state()
    with_ema = trainer.eval_step(batch)["total_loss"]
    own = {n: p.detach().clone() for n, p in model.named_parameters()}
    twin = trainer_for()
    twin.model.load_state_dict(model.state_dict())
    with torch.no_grad():
        for n, p in twin.model.named_parameters():
            p.copy_(trainer.ema[n])
    twin.generator.set_state(state)
    torch.testing.assert_close(twin.eval_step(batch)["total_loss"], with_ema,
                               rtol=1e-6, atol=0)
    assert model.training

    path = export_npz(trainer, str(tmp_path / "ema.npz"))
    exported = jax_variables_to_state_dict(load_npz_variables(path))
    for name, e in trainer.ema.items():
        torch.testing.assert_close(exported[name], e, rtol=0, atol=0)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), own[name], rtol=0, atol=0)
