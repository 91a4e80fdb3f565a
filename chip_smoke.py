#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`smokephysai_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--trace]

From the root of a checkout, with one CUDA card:

1. prints the card, the device count and nvidia-smi's name and power limit;
2. builds the three CUDA sources with nvcc (in parallel) and prints the
   seconds;
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card (fused solver step and multi-step at 128^2, one episode and a batch
   of four, the multi-step again at the dataset's 64 in the timing phase; lean flash attention at B=4 in bf16 and float32 and at the
   serving slice's B=19; the training forward with logsumexp and the
   backward at the training shape [8, 1024, 512], bf16, and the backward
   also in float32);
4. serving phase: the serving path of `config/config_serving.yaml` on
   `checkpoints/smokephysnet_128_best.npz` through the port's entry points:
   the 20-frame test sequence (20 fused-step launches) and one batched bf16
   forward with the lean flash kernel (6 launches), held against the plain
   per-op solver and the float32 einsum model;
5. dataset phase: `config/config_train_fast.yaml`'s train and validation
   sets (64 and 8 episodes at 128^2, T = 20) generated on the card through
   `data.synthetic.create_data_loaders` (one multi-step launch per chunk),
   two episodes held against the per-op solver;
6. training phase: that config at full width (hidden 512, 6 layers, 8
   heads, bf16, flash, fast_math): 10 train steps at batch 8 (6 launches of
   the forward-with-logsumexp and backward kernels each per step, no lean
   forward), one step held against the same step with the attention's plain
   versions (loss, gradient norm and each q, k, v projection's gradient),
   one eval pass, a checkpoint written and served again through
   `train/serving.load_model`;
7. timing phase: CUDA-event medians after warm-up; with --trace, also
   traces the serving forward, the simulator step and one train step with
   torch.profiler and prints where their device time goes;
8. prints the kernels' JSON line, the nvidia-smi line and, last,
   {"ok": true, "device": {...}}.

Any failure exits non-zero without that last line: there is no CPU
fallback. Needs no network and no file outside the checkout.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "config", "config_serving.yaml")
TRAIN_CONFIG = os.path.join(ROOT, "config", "config_train_fast.yaml")
CHECKPOINT = os.path.join(ROOT, "checkpoints", "smokephysnet_128_best.npz")

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, bf16 tensor
# core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# bounds of the kernel-vs-plain and slice checks
FUSED_ATOL = 1e-5      # the kernel rounds as the plain version (-fmad=false)
# bf16 flash: the largest |d| within two bf16 ulps of the largest output
# (|o| < 0.5 at these shapes, whose ulp is 2^-9), and ||d|| / ||ref|| within
# 2^-8. The kernel rounds P to bf16 against a running max per 64-key tile,
# the plain version against the row's max: two roundings of P, ~sqrt(2) *
# 2^-9 of relative noise; an output one ulp off everywhere gives ~2^-7.5.
FLASH_BF16_ULPS = 2
FLASH_BF16_REL_NORM = 2.0 ** -8
FLASH_F32_ATOL = 1e-5   # float32, sums in another order
SIM_TOL = dict(atol=2e-5, rtol=1e-4)  # fused path vs per-op path, 20 steps
RECON_BF16_VS_F32 = 2e-2  # bf16 + flash + fast_math vs float32 einsum model
MULTI_ATOL = 1e-5  # multi-step kernel vs its plain version; 0 vs 20 steps
LSE_ATOL = 1e-4   # logsumexp ~ log 1024 ~ 7, float32 scores on both sides
# bwd bf16: both sides round P = exp(S - lse) against the same final lse,
# and dS once, so only the products' summation order differs (~1e-4 read
# on an H100 for each of dq, dk, dv); 2^-10 leaves ten times that, and a
# fault in a few query rows of dq (one row ~2^-8) or a key tile dropped
# for one head (>~ 2^-5) exceeds it
BWD_BF16_REL_NORM = 2.0 ** -10
BWD_F32_REL_NORM = 1e-5
EPISODE_ATOL = 1e-5  # fused-kernel episodes vs the per-op solver
# one train step, kernels vs plain versions: loss and global gradient norm
# (~1e-6 read on an H100), and each layer's q, k, v projection weights'
# gradients, ||d|| / ||ref||, which a backward fault reaches first
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_NORM_RTOL = 1e-4
# ... against the plain versions of both flash kernels: the two forwards
# round P against other maxima (out 2.3e-3 apart), which spreads to
# ~2.5e-3 (largest 7.9e-3) in these gradients
TRAIN_PROJ_GRAD_REL_NORM = 2.0 ** -6
# ... against the forward kernel and the plain backward, where only the
# backward differs: the last layer's read the kernel's dq, dk, dv directly
# (~2.2e-4 on an H100); each layer below adds the bf16 roundings that
# this flips in its own backward (largest 1.65e-3, the first layer's)
TRAIN_BWD_TOP_PROJ_GRAD_REL_NORM = 2.0 ** -10
TRAIN_BWD_PROJ_GRAD_REL_NORM = 2.0 ** -8
TRAIN_NUM = 64  # cuts of config_train_fast.yaml: episodes and steps
VAL_NUM = 8
TRAIN_STEPS = 10

TRACE_RUNS = 5  # traced serving forwards in --trace

T0 = time.time()


def say(*args):
    print(*args, flush=True)


def fail(msg):
    say(f"chip_smoke FAILED: {msg}")
    sys.exit(1)


def bf16_ulp(x):
    """Spacing of bfloat16 numbers (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def timed(fn, runs=20, warmup=3):
    """Median ms of `runs` calls, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def maxerr(a, b):
    return float((a.float() - b.float()).abs().max())


def rel_norm(a, b):
    """||a - b|| / ||b|| in float32."""
    import torch

    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def lower_bound(nbytes, flops, peak_flops):
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    the operations over `peak_flops`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def step_flops(h, w, iters, taps=3):
    """Float32 operations of one solver step of one episode, stage by stage
    (taps = 2 max_disp + 1)."""
    nu, nv, nc = (h + 1) * w, h * (w + 1), h * w
    return (2 * nc                         # buoyancy
            + 7 * (nu + nv + nc)           # diffusion
            + 4 * nc                       # divergence
            + 5 * nc * iters               # Jacobi
            + 3 * ((h - 1) * w + h * (w - 1))  # correction
            + (12 + 4 * taps + 7 * taps * taps) * (nu + nv + nc)  # advection
            + nc)                          # decay


def step_bytes(h, w):
    """Bytes of one episode's four fields, once."""
    return 4 * ((h + 1) * w + h * (w + 1) + 2 * h * w)


def profile(fn, runs, label, top=15):
    """Traces `runs` calls of fn and prints the device time per call of the
    kernels that take the most, by kernel and by the PyTorch op that
    launched them, and the device's busy share of the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    per_kernel = {}
    n_events = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] = (per_kernel.get(evt.name, 0.0)
                                    + evt.time_range.elapsed_us() / 1e3)
            n_events += 1
    busy_ms = sum(per_kernel.values())
    say(f"trace {label}: {window_ms / runs:.3f} ms per call (CUDA events), "
        f"device kernel time {busy_ms / runs:.3f} ms per call, busy share "
        f"{busy_ms / window_ms:.3f}, {n_events // runs} device events per call")
    if busy_ms == 0.0:
        fail(f"trace {label}: the profiler recorded no device time")
    say(f"trace {label}: kernels by device time")
    for kname, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]:
        say(f"  {ms / runs:9.4f} ms  {100 * ms / busy_ms:5.1f}%  {kname[:110]}")
    say(f"trace {label}: PyTorch ops by the device time of the kernels they launch")
    ops = [a for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CPU
           and a.self_device_time_total > 0]
    for a in sorted(ops, key=lambda a: -a.self_device_time_total)[:top]:
        ms = a.self_device_time_total / 1e3
        say(f"  {ms / runs:9.4f} ms  {100 * ms / busy_ms:5.1f}%  {a.key[:60]} "
            f"({a.count // runs} per call)")


COUNTERS = {
    "fused_step": ("step", "LAUNCHES"),
    "fused_multi_step": ("step", "MULTI_LAUNCHES"),
    "flash_attention_tokens": ("attn", "LAUNCHES"),
    "flash_attention_tokens_fwd_lse": ("attn", "LSE_LAUNCHES"),
    "flash_attention_tokens_bwd": ("attn", "BWD_LAUNCHES"),
}


def reset_counts(step_ops, attn_ops):
    """Sets every kernel's launch count to 0."""
    mods = {"step": step_ops, "attn": attn_ops}
    for mod, attr in COUNTERS.values():
        setattr(mods[mod], attr, 0)


def read_counts(step_ops, attn_ops):
    mods = {"step": step_ops, "attn": attn_ops}
    return {name: getattr(mods[mod], attr) for name, (mod, attr) in COUNTERS.items()}


def expect_counts(phase, counts, **want):
    """Fails unless each kernel launched exactly as often as `want` says
    (kernels not named: never)."""
    for name in COUNTERS:
        if counts[name] != want.get(name, 0):
            fail(f"{phase}: expected {want.get(name, 0)} {name} launches, "
                 f"saw {counts[name]}")


class PlainFlash:
    """Swaps the model's flash attention for an autograd Function over the
    plain version of the backward and, with `forward`, of the
    forward-with-logsumexp (else its kernel), inside a `with` block (for
    holding one train step against the kernels')."""

    def __init__(self, attn_ops, chaos_attention_module, forward=True):
        import torch

        fwd_lse = (attn_ops.flash_attention_tokens_fwd_lse_reference if forward
                   else attn_ops.flash_attention_tokens_fwd_lse)

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, heads, temperature):
                out, lse = fwd_lse(q, k, v, heads, temperature)
                ctx.save_for_backward(q, k, v, out, lse)
                ctx.heads, ctx.temperature = heads, temperature
                return out

            @staticmethod
            def backward(ctx, dout):
                grads = attn_ops.flash_attention_tokens_bwd_reference(
                    *ctx.saved_tensors, dout, ctx.heads, ctx.temperature)
                return (*grads, None, None)

        self.fn = lambda q, k, v, heads, temperature=1.0: Fn.apply(q, k, v, heads, temperature)
        self.module = chaos_attention_module

    def __enter__(self):
        self.saved = self.module.flash_attention_tokens_trainable
        self.module.flash_attention_tokens_trainable = self.fn

    def __exit__(self, *exc):
        self.module.flash_attention_tokens_trainable = self.saved


def dataset_phase(dev, step_ops, attn_ops):
    """Generates config_train_fast.yaml's datasets, cut to 64 + 8 episodes,
    on the card; holds two episodes against the per-op solver."""
    import numpy as np
    import torch

    from smokephysai_tpu_torch.data.synthetic import CHUNK_SIZE, create_data_loaders
    from smokephysai_tpu_torch.physics.simulator import simulate_episode
    from smokephysai_tpu_torch.utils.config import apply_overrides, load_config

    config = apply_overrides(load_config(TRAIN_CONFIG), [
        f"data.num_train={TRAIN_NUM}", f"data.num_val={VAL_NUM}", "data.cache_dir=null"])
    data, tpu = config["data"], config["tpu"]
    grid, T = tuple(data["grid_size"]), data["sequence_length"]
    reset_counts(step_ops, attn_ops)
    t = time.time()
    train_ds, val_ds = create_data_loaders(
        batch_size=config["training"]["batch_size"], num_train=TRAIN_NUM,
        num_val=VAL_NUM, grid_size=grid, cache_dir=None, sequence_length=T,
        seed=tpu["seed"], use_pallas=tpu["use_pallas"],
        vorticity_eps=tpu["vorticity_eps"], device=dev)
    torch.cuda.synchronize()
    counts = read_counts(step_ops, attn_ops)
    chunks = -(-TRAIN_NUM // CHUNK_SIZE) + -(-VAL_NUM // CHUNK_SIZE)
    say(f"dataset: {TRAIN_NUM} + {VAL_NUM} episodes at {grid[0]}x{grid[1]}, T={T}, "
        f"in {time.time() - t:.2f} s (host clock, first call, chaos labels and the "
        f"host copy included); launches {counts}")
    expect_counts("dataset", counts, fused_multi_step=chunks)
    for ds in (train_ds, val_ds):
        if not (np.isfinite(ds.data["sequences"]).all() and np.isfinite(ds.data["chaos"]).all()):
            fail("non-finite episodes or chaos labels")
    d = train_ds.data
    sel = [0, 1]
    params = [torch.from_numpy(d[k][sel]).to(dev)
              for k in ("source_xy", "source_intensity", "source_active")]
    plain_seq, plain_lab = simulate_episode(*params, grid_size=grid, num_steps=T,
                                            use_pallas=False)
    err = maxerr(plain_seq, torch.from_numpy(d["sequences"][sel]).to(dev))
    lab_err = maxerr(plain_lab, torch.from_numpy(d["chaos"][sel]).to(dev))
    say(f"dataset: episodes {sel} vs the per-op solver on the card: sequences "
        f"max|d| {err:.3e} (bound {EPISODE_ATOL:g}), chaos labels max|d| {lab_err:.3e}; "
        f"labels of the set: mean {d['chaos'].mean(axis=0).round(4).tolist()}")
    if not err <= EPISODE_ATOL:
        fail("generated episodes disagree with the per-op solver")
    return config, train_ds, val_ds, {"counts": counts, "err": err}


def training_phase(config, train_ds, val_ds, dev, step_ops, attn_ops):
    """10 train steps of the full-width fast recipe with launch counts, one
    step held against the plain attention, one eval pass, a checkpoint
    served again."""
    import copy
    import tempfile

    import torch

    from smokephysai_tpu_torch.models import chaos_attention as ca_mod
    from smokephysai_tpu_torch.train import loop
    from smokephysai_tpu_torch.train.checkpoint import save_checkpoint
    from smokephysai_tpu_torch.train.serving import load_model, make_predictor

    tc, seed = config["training"], config["tpu"]["seed"]
    bs = tc["batch_size"]
    layers = config["model"]["num_layers"]
    t = time.time()
    gen = torch.Generator(dev).manual_seed(seed)
    model = loop.build_train_model(config, dev)
    torch.cuda.synchronize()
    built_s = time.time() - t
    loop.init_parameters(model, gen)
    steps_per_epoch = max(len(train_ds) // bs, 1)
    data_gen = torch.Generator().manual_seed(seed)
    trainer = loop.Trainer(model, config, steps_per_epoch, gen)
    torch.cuda.synchronize()
    say(f"train: model built in {built_s:.2f} s, initialised and its optimizer "
        f"made in {time.time() - t - built_s:.2f} s (hidden "
        f"{config['model']['hidden_dim']}, {layers} layers, "
        f"{config['model']['num_heads']} heads, compute {model.dtype}, flash "
        f"{model.layer_0.chaos_attention.use_flash}, fast_math {model.layer_0.fast_math}, "
        f"{sum(p.numel() for p in model.parameters())} parameters)")

    def batches():
        while True:
            yield from train_ds.epoch_batches(data_gen, bs, shuffle=True)

    it = batches()
    step_ms, losses, norms = [], [], []
    total = dict.fromkeys(COUNTERS, 0)
    for i in range(TRAIN_STEPS):
        batch = next(it)
        reset_counts(step_ops, attn_ops)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        metrics = trainer.train_step(batch)
        b.record()
        b.synchronize()
        counts = read_counts(step_ops, attn_ops)
        expect_counts(f"train step {i}", counts, flash_attention_tokens_fwd_lse=layers,
                      flash_attention_tokens_bwd=layers)
        for k in total:
            total[k] += counts[k]
        step_ms.append(a.elapsed_time(b))
        losses.append(float(metrics["total_loss"]))
        norms.append(float(metrics["grad_norm"]))
    say(f"train: {TRAIN_STEPS} steps at batch {bs}: losses "
        f"{[round(x, 4) for x in losses]}, gradient norms {[round(x, 3) for x in norms]}, "
        f"ms {[round(x, 2) for x in step_ms]}; launches per step {counts}")
    if not all(math.isfinite(x) for x in losses + norms):
        fail("non-finite training loss or gradient norm")

    reset_counts(step_ops, attn_ops)
    val_loss = loop.evaluate(trainer, val_ds, bs, data_gen)
    torch.cuda.synchronize()
    eval_counts = read_counts(step_ops, attn_ops)
    n_val_batches = -(-len(val_ds) // bs)
    say(f"train: eval pass over {len(val_ds)} episodes: loss {val_loss:.4f}; "
        f"launches {eval_counts}")
    expect_counts("eval pass", eval_counts, flash_attention_tokens=layers * n_val_batches)
    if not math.isfinite(val_loss):
        fail("non-finite validation loss")

    # one step from the same weights, batch, chaos fields and dropout
    # stream through the kernels, through the forward kernel and the plain
    # backward, and through the plain versions of both
    batch = next(it)
    fields = model.chaos_fields(trainer.generator, bs, dev)
    state = copy.deepcopy(model.state_dict())
    runs = {}
    for mode in ("kernels", "plain backward", "plain"):
        twin = loop.build_train_model(config, dev)
        twin.load_state_dict(state)
        tw = loop.Trainer(twin, config, steps_per_epoch, torch.Generator(dev).manual_seed(1))
        tw.step = trainer.step
        reset_counts(step_ops, attn_ops)
        if mode == "kernels":
            m = tw.train_step(batch, chaos_fields=fields)
        else:
            with PlainFlash(attn_ops, ca_mod, forward=mode == "plain"):
                m = tw.train_step(batch, chaos_fields=fields)
        torch.cuda.synchronize()
        counts = read_counts(step_ops, attn_ops)
        # the clipped gradients the optimizer applied, back to their scale
        clip = min(1.0, 1.0 / float(m["grad_norm"]))
        proj = {n: p.grad / clip for n, p in twin.named_parameters()
                if n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight"))}
        runs[mode] = (float(m["total_loss"]), float(m["grad_norm"]), counts, proj)
        del twin, tw
    kl, kn, kc, kg = runs["kernels"]
    pl, pn, pc, _ = runs["plain"]
    loss_rel, norm_rel = abs(kl - pl) / abs(pl), abs(kn - pn) / abs(pn)
    say(f"train: one step, kernels vs plain versions: loss {kl:.6f} vs {pl:.6f} "
        f"(rel {loss_rel:.3e}, bound {TRAIN_LOSS_RTOL:g}), gradient norm {kn:.5f} vs "
        f"{pn:.5f} (rel {norm_rel:.3e}, bound {TRAIN_GRAD_NORM_RTOL:g}); launches "
        f"{kc}, plain backward {runs['plain backward'][2]}, plain {pc}")
    proj_ok = True
    for mode, bound in (("plain", TRAIN_PROJ_GRAD_REL_NORM),
                        ("plain backward", TRAIN_BWD_PROJ_GRAD_REL_NORM)):
        ref = runs[mode][3]
        rel = {n: rel_norm(kg[n], ref[n]) for n in ref}
        worst = max(rel, key=rel.get)
        say(f"train: q, k, v projection gradients, kernels vs {mode}: {len(rel)} "
            f"tensors, ||d||/||ref|| median {statistics.median(rel.values()):.3e}, "
            f"largest {rel[worst]:.3e} ({worst}; bound {bound:.3e}); by layer, q k v: "
            f"{[float(f'{x:.3e}') for x in rel.values()]}")
        proj_ok &= len(rel) == 3 * layers and max(rel.values()) <= bound
    top = [x for n, x in rel.items() if n.startswith(f"layer_{layers - 1}.")]
    say(f"train: the last layer's q, k, v projection gradients, kernels vs plain "
        f"backward: largest {max(top):.3e} (bound {TRAIN_BWD_TOP_PROJ_GRAD_REL_NORM:.3e})")
    proj_ok &= len(top) == 3 and max(top) <= TRAIN_BWD_TOP_PROJ_GRAD_REL_NORM
    none = dict.fromkeys(COUNTERS, 0)
    lse_only = none | {"flash_attention_tokens_fwd_lse": layers}
    if not (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_GRAD_NORM_RTOL and proj_ok
            and kc == lse_only | {"flash_attention_tokens_bwd": layers}
            and runs["plain backward"][2] == lse_only and pc == none):
        fail("the kernels' train step disagrees with the plain versions'")

    # checkpoint -> npz export -> served again
    serve_cfg = copy.deepcopy(config)
    serve_cfg["tpu"]["compute_dtype"] = serve_cfg["tpu"]["train_compute_dtype"]
    frames = next(iter(val_ds.epoch_batches(data_gen, bs, shuffle=False)))["input"]
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, trainer, data_gen,
                        {"epoch": 0, "val_loss": val_loss, "config": config})
        served = load_model(serve_cfg, os.path.join(tmp, "best_model.npz"), dev)
    trained = model.state_dict()
    same = all(torch.equal(v, trained[k]) for k, v in served.state_dict().items())
    reset_counts(step_ops, attn_ops)
    out = make_predictor(served, chaos_seed=seed)(frames)
    torch.cuda.synchronize()
    serve_counts = read_counts(step_ops, attn_ops)
    finite = bool(torch.isfinite(out["reconstructed"]).all()
                  and torch.isfinite(out["physics_features"]).all())
    say(f"train: checkpoint served through load_model: weights equal {same}, "
        f"outputs finite {finite}, launches {serve_counts}")
    expect_counts("serving the trained checkpoint", serve_counts,
                  flash_attention_tokens=layers)
    if not (same and finite):
        fail("the trained checkpoint does not serve back")
    del served, out
    return trainer, it, {"step_ms": step_ms, "counts": total, "losses": losses}


def main():
    args = sys.argv[1:]
    if args not in ([], ["--trace"]):
        fail(f"unknown arguments {args}; usage: python3 chip_smoke.py [--trace]")
    trace = args == ["--trace"]
    if not os.path.isdir(os.path.join(ROOT, "smokephysai_tpu_torch")):
        fail("the package smokephysai_tpu_torch is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    import numpy as np

    from smokephysai_tpu_torch import inference
    from smokephysai_tpu_torch.ops import _build
    from smokephysai_tpu_torch.ops import attention as attn_ops
    from smokephysai_tpu_torch.ops import fused_step as step_ops
    from smokephysai_tpu_torch.physics import solver
    from smokephysai_tpu_torch.train.serving import load_model, make_predictor
    from smokephysai_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    # float32 products and convolutions in full float32 (no TF32) on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0].strip()
    say(f"device: {name} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(f"nvidia-smi: {smi_line}")

    # ---------------------------------------------------------------- build
    t = time.time()
    _build.build_all([(step_ops.SOURCE, step_ops.FLAGS),
                      (attn_ops.SOURCE, attn_ops.FLAGS),
                      (attn_ops.BWD_SOURCE, attn_ops.FLAGS)])
    build_s = time.time() - t
    say(f"build: three sources in {build_s:.2f} s (nvcc, sm_90a, one process each)")
    for src, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {src}: {line.strip()}")

    # ---------------------------------------------------------------- kernels
    config = load_config(CONFIG)
    sim_cfg = config["simulation"]
    dt, visc = sim_cfg["dt"], sim_cfg["viscosity"]
    iters = sim_cfg["num_jacobi_iters"]
    grid = tuple(sim_cfg["grid_size"])
    gen = torch.Generator().manual_seed(0)

    def prepared_state(positions, intensities, steps=10):
        s = solver.init_state(grid, device=dev)
        d = s.density
        for (x, y), a in zip(positions, intensities):
            d = solver.add_smoke_source(d, x, y, radius=8.0, intensity=a)
        s = s.replace(density=d)
        for _ in range(steps):  # the plain step on the card
            s = solver.SimState(*step_ops.fused_step_reference(
                s.u, s.v, s.p, s.density, dt, visc, iters, 1))
        return s

    s1 = prepared_state(inference.TEST_POSITIONS, inference.TEST_INTENSITIES)
    fields1 = (s1.u, s1.v, s1.p, s1.density)
    kout = step_ops.fused_step(*fields1, dt, visc, iters, 1)
    pout = step_ops.fused_step_reference(*fields1, dt, visc, iters, 1)
    torch.cuda.synchronize()
    fused_err = max(maxerr(a, b) for a, b in zip(kout, pout))
    say(f"kernel fused_step 128^2 x1: max|d| {fused_err:.3e} (bound {FUSED_ATOL:g})")
    if not fused_err <= FUSED_ATOL:
        fail("fused_step disagrees with its plain version")

    rng = np.random.default_rng(0)
    episodes = [prepared_state(rng.uniform(16, 112, (3, 2)).tolist(),
                               rng.uniform(0.5, 1.5, 3).tolist()) for _ in range(4)]
    fields4 = [torch.stack([getattr(e, n) for e in episodes]).contiguous()
               for n in ("u", "v", "p", "density")]
    kout4 = step_ops.fused_step(*fields4, dt, visc, iters, 1)
    pout4 = step_ops.fused_step_reference(*fields4, dt, visc, iters, 1)
    torch.cuda.synchronize()
    fused_err4 = max(maxerr(a, b) for a, b in zip(kout4, pout4))
    say(f"kernel fused_step 128^2 x4: max|d| {fused_err4:.3e} (bound {FUSED_ATOL:g})")
    if not fused_err4 <= FUSED_ATOL:
        fail("batched fused_step disagrees with its plain version")

    multi_errs = {}
    for tag, fields in (("x1", fields1), ("x4", fields4)):
        before = [f.clone() for f in fields]
        (kfin, ktraj) = step_ops.fused_multi_step(*fields, 20, dt, visc, iters, 1)
        (pfin, ptraj) = step_ops.fused_multi_step_reference(*fields, 20, dt, visc, iters, 1)
        s = fields
        for _ in range(20):  # the single-step kernel, 20 launches
            s = step_ops.fused_step(*s, dt, visc, iters, 1)
        torch.cuda.synchronize()
        err = max(maxerr(ktraj, ptraj), *(maxerr(a, b) for a, b in zip(kfin, pfin)))
        vs_single = max(maxerr(ktraj[..., -1, :, :], s[3]),
                        *(maxerr(a, b) for a, b in zip(kfin, s)))
        unchanged = all(torch.equal(a, b) for a, b in zip(fields, before))
        multi_errs[tag] = err
        say(f"kernel fused_multi_step 128^2 {tag} T=20: trajectory {tuple(ktraj.shape)}, "
            f"max|d| vs plain {err:.3e} (bound {MULTI_ATOL:g}), vs 20 single-step "
            f"launches {vs_single:.3e} (bound 0), inputs unchanged {unchanged}")
        if not (err <= MULTI_ATOL and vs_single == 0.0 and unchanged):
            fail(f"fused_multi_step ({tag}) disagrees with its plain version or "
                 f"the single-step kernel")

    heads = config["model"]["num_heads"]
    width = config["model"]["hidden_dim"]
    flash_errs = {}
    for batch, dtype in ((4, torch.bfloat16), (4, torch.float32), (19, torch.bfloat16)):
        q, k, v = (torch.randn(batch, 1024, width, generator=gen).to(dev, dtype)
                   for _ in range(3))
        o = attn_ops.flash_attention_tokens(q, k, v, heads).float()
        r = attn_ops.flash_attention_tokens_reference(q, k, v, heads).float()
        torch.cuda.synchronize()
        err = maxerr(o, r)
        rel = float(torch.linalg.vector_norm(o - r) / torch.linalg.vector_norm(r))
        ref_max = float(r.abs().max())
        if dtype == torch.bfloat16:
            bound = FLASH_BF16_ULPS * bf16_ulp(ref_max)
            ok = err <= bound and rel <= FLASH_BF16_REL_NORM
            bounds = f"bound {bound:.3e}; ||d||/||ref|| {rel:.3e} (bound {FLASH_BF16_REL_NORM:.3e})"
        else:
            ok = err <= FLASH_F32_ATOL
            bounds = f"bound {FLASH_F32_ATOL:g}; ||d||/||ref|| {rel:.3e}"
        tag = str(dtype).replace("torch.", "")
        flash_errs[(batch, tag)] = err
        say(f"kernel flash_attention_tokens B={batch} L=1024 D={width} H={heads} "
            f"{tag}: max|ref| {ref_max:.3e}, max|d| {err:.3e} ({bounds})")
        if not ok:
            fail(f"flash_attention_tokens ({tag}, B={batch}) disagrees with its "
                 f"plain version")

    train_batch = load_config(TRAIN_CONFIG)["training"]["batch_size"]
    q, k, v, g = (torch.randn(train_batch, 1024, width, generator=gen)
                  .to(dev, torch.bfloat16) for _ in range(4))
    o, lse = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)
    ro, rlse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads)
    torch.cuda.synchronize()
    lse_out_err, lse_err = maxerr(o, ro), maxerr(lse, rlse)
    rel = float(torch.linalg.vector_norm(o.float() - ro.float())
                / torch.linalg.vector_norm(ro.float()))
    bound = FLASH_BF16_ULPS * bf16_ulp(float(ro.float().abs().max()))
    say(f"kernel flash_attention_tokens_fwd_lse B={train_batch} L=1024 D={width} "
        f"H={heads} bf16: out max|d| {lse_out_err:.3e} (bound {bound:.3e}), "
        f"||d||/||ref|| {rel:.3e} (bound {FLASH_BF16_REL_NORM:.3e}); lse max|d| "
        f"{lse_err:.3e} (bound {LSE_ATOL:g}), lse in [{float(rlse.min()):.3f}, "
        f"{float(rlse.max()):.3f}]")
    if not (lse_out_err <= bound and rel <= FLASH_BF16_REL_NORM and lse_err <= LSE_ATOL):
        fail("flash_attention_tokens_fwd_lse disagrees with its plain version")
    bwd_errs = {}
    for dtype, rel_bound in ((torch.bfloat16, BWD_BF16_REL_NORM),
                             (torch.float32, BWD_F32_REL_NORM)):
        qd, kd, vd, gd = (x.to(dtype) for x in (q, k, v, g))
        od, lsed = attn_ops.flash_attention_tokens_fwd_lse_reference(qd, kd, vd, heads)
        kg = attn_ops.flash_attention_tokens_bwd(qd, kd, vd, od, lsed, gd, heads)
        pg = attn_ops.flash_attention_tokens_bwd_reference(qd, kd, vd, od, lsed, gd, heads)
        torch.cuda.synchronize()
        tag = str(dtype).replace("torch.", "")
        rels = [float(torch.linalg.vector_norm(a.float() - b.float())
                      / torch.linalg.vector_norm(b.float())) for a, b in zip(kg, pg)]
        bwd_errs[tag] = max(maxerr(a, b) for a, b in zip(kg, pg))
        say(f"kernel flash_attention_tokens_bwd B={train_batch} L=1024 D={width} "
            f"H={heads} {tag}: ||d||/||ref|| dq {rels[0]:.3e} dk {rels[1]:.3e} "
            f"dv {rels[2]:.3e} (bound {rel_bound:.3e}), max|d| {bwd_errs[tag]:.3e}")
        if not max(rels) <= rel_bound:
            fail(f"flash_attention_tokens_bwd ({tag}) disagrees with its plain version")
        del qd, kd, vd, gd, od, lsed, kg, pg
    del q, k, v, g, o, lse, ro, rlse

    # ---------------------------------------------------------------- slice
    if not os.path.exists(CHECKPOINT):
        fail(f"checkpoint {CHECKPOINT} is missing")
    t = time.time()
    model = load_model(config, CHECKPOINT, dev)
    predict = make_predictor(model, chaos_seed=config["tpu"]["seed"])
    simulator = inference.make_simulator(config, dev)
    torch.cuda.synchronize()
    say(f"slice: model and simulator ready in {time.time() - t:.2f} s "
        f"(compute {model.dtype}, flash {model.layer_0.chaos_attention.use_flash}, "
        f"fast_math {model.layer_0.fast_math})")

    reset_counts(step_ops, attn_ops)
    t = time.time()
    sequence = inference.generate_test_sequence(simulator, 20)
    inputs = torch.stack(sequence[:-1])[..., None]
    outputs = predict(inputs)
    torch.cuda.synchronize()
    slice_s = time.time() - t
    launches = read_counts(step_ops, attn_ops)
    say(f"slice: 20 frames + one batched forward of {inputs.shape[0]} in "
        f"{slice_s * 1e3:.1f} ms (host clock, first call); launches {launches}")
    expected_flash = config["model"]["num_layers"]
    expect_counts("serving slice", launches, fused_step=20,
                  flash_attention_tokens=expected_flash)

    recon = outputs["reconstructed"]
    phys = outputs["physics_features"]
    if tuple(recon.shape) != (19, *grid, 1) or tuple(phys.shape) != (19, 3):
        fail(f"unexpected output shapes {tuple(recon.shape)}, {tuple(phys.shape)}")
    if not (torch.isfinite(recon).all() and torch.isfinite(phys).all()):
        fail("non-finite model outputs")

    # the simulated sequence against the plain per-op solver on the card
    plain_sim = inference.make_simulator(config, dev)
    plain_sim.use_pallas = False
    plain_seq = inference.generate_test_sequence(plain_sim, 20)
    seq_t, plain_t = torch.stack(sequence), torch.stack(plain_seq)
    sim_err = maxerr(seq_t, plain_t)
    say(f"slice: fused-kernel sequence vs per-op solver: max|d| {sim_err:.3e} "
        f"(atol {SIM_TOL['atol']:g}, rtol {SIM_TOL['rtol']:g})")
    if not torch.allclose(seq_t, plain_t, **SIM_TOL):
        fail("the simulated sequence disagrees with the per-op solver")

    # the serving forward against the float32 einsum model
    f32_config = json.loads(json.dumps(config))
    f32_config["tpu"].update(compute_dtype="float32", use_flash=False, fast_math=False)
    model32 = load_model(f32_config, CHECKPOINT, dev)
    out32 = make_predictor(model32, chaos_seed=config["tpu"]["seed"])(inputs)
    recon_err = maxerr(recon, out32["reconstructed"])
    phys_err = maxerr(phys, out32["physics_features"])
    say(f"slice: bf16+flash vs float32 einsum: reconstructed max|d| {recon_err:.3e} "
        f"(bound {RECON_BF16_VS_F32:g}), physics max|d| {phys_err:.3e}")
    if not recon_err <= RECON_BF16_VS_F32:
        fail("the bf16 serving forward disagrees with the float32 model")
    truth = torch.stack(sequence[1:])[..., None]
    mse = float(((recon.float() - truth) ** 2).mean())
    mse32 = float(((out32["reconstructed"] - truth) ** 2).mean())
    say(f"slice: next-frame MSE vs simulated ground truth: bf16 {mse:.6e}, "
        f"float32 {mse32:.6e}")
    if not (np.isfinite(mse) and np.isfinite(mse32)):
        fail("non-finite MSE")
    del model32, out32

    # ---------------------------------------------------------------- dataset
    train_config, train_ds, val_ds, data_info = dataset_phase(dev, step_ops, attn_ops)

    # ---------------------------------------------------------------- training
    trainer, train_batches, train_info = training_phase(
        train_config, train_ds, val_ds, dev, step_ops, attn_ops)

    # ---------------------------------------------------------------- timing
    def step_bound(episodes):
        # four fields in, four out
        return lower_bound(episodes * 2 * step_bytes(*grid),
                     episodes * step_flops(*grid, iters), F32_FLOPS)

    def flash_bound(batch):
        hd = width // heads
        return lower_bound(4 * batch * 1024 * width * 2,
                     4 * batch * heads * 1024 * 1024 * hd, BF16_FLOPS)

    timings = {}
    for episodes_n in (1, 64):
        f = [t.expand(episodes_n, *t.shape).contiguous() for t in fields1]
        ms = timed(lambda: step_ops.fused_step(*f, dt, visc, iters, 1))
        plain_ms = timed(lambda: step_ops.fused_step_reference(*f, dt, visc, iters, 1))
        bound, by = step_bound(episodes_n)
        timings[("fused_step", episodes_n)] = (ms, plain_ms, bound, by)
        say(f"time fused_step 128^2 x{episodes_n} on {name}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by})")

    library = {}
    for batch in (19, 64):
        q, k, v = (torch.randn(batch, 1024, width, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(3))
        ms = timed(lambda: attn_ops.flash_attention_tokens(q, k, v, heads))
        plain_ms = timed(lambda: attn_ops.flash_attention_tokens_reference(q, k, v, heads))
        qh, kh, vh = (x.view(batch, 1024, heads, width // heads).transpose(1, 2)
                      for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library[batch] = timed(lambda: sdpa(qh, kh, vh))
        bound, by = flash_bound(batch)
        timings[("flash_attention_tokens", batch)] = (ms, plain_ms, bound, by)
        say(f"time flash_attention_tokens B={batch} L=1024 D={width} H={heads} bf16 "
            f"on {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"SDPA {library[batch]:.4f} ms, bound {bound:.4f} ms ({by})")
        del q, k, v, qh, kh, vh

    serve_batch = config["training"]["batch_size"]
    frames = torch.stack([sequence[i % 20] for i in range(serve_batch)])[..., None]
    fwd_ms = timed(lambda: predict(frames))
    say(f"time serving forward B={serve_batch} (bf16, flash, fast_math) on {name}: "
        f"{fwd_ms:.3f} ms ({fwd_ms / serve_batch:.4f} ms/frame)")
    step_ms = timed(lambda: simulator.simulate_step())
    say(f"time simulate_step 128^2 (fused kernel + perturbation) on {name}: "
        f"{step_ms:.4f} ms")

    # the training slice's kernels at the training shapes
    from smokephysai_tpu_torch.physics.simulator import simulate_episode, source_density
    from smokephysai_tpu_torch.data.synthetic import sample_source_params

    tgrid = tuple(train_config["data"]["grid_size"])
    T = train_config["data"]["sequence_length"]
    chunk = sample_source_params(torch.Generator().manual_seed(1), 64, tgrid)
    chunk = {k: v.to(dev) for k, v in chunk.items()}
    chunk_ms = timed(lambda: simulate_episode(chunk["xy"], chunk["intensity"],
                                              chunk["active"], tgrid, T, use_pallas=True),
                     runs=5, warmup=1)
    s0 = solver.init_state(tgrid, device=dev, batch=(64,))
    s0 = s0.replace(density=source_density(chunk["xy"], chunk["intensity"],
                                           chunk["active"], tgrid))
    f0 = (s0.u, s0.v, s0.p, s0.density)
    ms = timed(lambda: step_ops.fused_multi_step(*f0, T, dt, visc, iters, 1), runs=10)
    plain_ms = timed(lambda: step_ops.fused_multi_step_reference(*f0, T, dt, visc, iters, 1),
                     runs=3, warmup=1)
    # the main path's shape, 64 episodes, against the plain version
    (kfin, ktraj) = step_ops.fused_multi_step(*f0, T, dt, visc, iters, 1)
    (pfin, ptraj) = step_ops.fused_multi_step_reference(*f0, T, dt, visc, iters, 1)
    torch.cuda.synchronize()
    multi_errs["x64"] = max(maxerr(ktraj, ptraj), *(maxerr(a, b) for a, b in zip(kfin, pfin)))
    say(f"kernel fused_multi_step 128^2 x64 T={T}: max|d| vs plain "
        f"{multi_errs['x64']:.3e} (bound {MULTI_ATOL:g})")
    if not multi_errs["x64"] <= MULTI_ATOL:
        fail("fused_multi_step (x64) disagrees with its plain version")
    del kfin, ktraj, pfin, ptraj
    traj_bytes = 64 * T * tgrid[0] * tgrid[1] * 4
    mb = lower_bound(64 * 2 * step_bytes(*tgrid) + traj_bytes,
                     64 * T * step_flops(*tgrid, iters), F32_FLOPS)
    timings["fused_multi_step"] = (ms, plain_ms, *mb)
    say(f"time fused_multi_step 128^2 x64 T={T} on {name}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {mb[0]:.6f} ms ({mb[1]}); whole 64-episode "
        f"generation chunk (simulate_episode: sources, kernel, perturbation, chaos "
        f"labels) {chunk_ms:.4f} ms")

    tb = train_config["training"]["batch_size"]
    hd = width // heads
    q, k, v, g = (torch.randn(tb, 1024, width, generator=gen).to(dev, torch.bfloat16)
                  for _ in range(4))
    o, lse = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.view(tb, 1024, heads, hd).transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gh = g.view(tb, 1024, heads, hd).transpose(1, 2)
    ms = timed(lambda: attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads))
    plain_ms = timed(lambda: attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads))
    lib_ms = timed(lambda: sdpa(qh, kh, vh))
    fb = lower_bound(4 * tb * 1024 * width * 2 + tb * heads * 1024 * 4,
                     4 * tb * heads * 1024 * 1024 * hd, BF16_FLOPS)
    timings["flash_attention_tokens_fwd_lse"] = (ms, plain_ms, *fb, lib_ms)
    say(f"time flash_attention_tokens_fwd_lse B={tb} L=1024 D={width} H={heads} bf16 "
        f"on {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA forward "
        f"(inputs need grad) {lib_ms:.4f} ms, bound {fb[0]:.4f} ms ({fb[1]})")
    ms = timed(lambda: attn_ops.flash_attention_tokens_bwd(q, k, v, o, lse, g, heads))
    plain_ms = timed(lambda: attn_ops.flash_attention_tokens_bwd_reference(
        q, k, v, o, lse, g, heads), runs=5)
    oh = sdpa(qh, kh, vh)
    lib_ms = timed(lambda: torch.autograd.grad(oh, (qh, kh, vh), gh, retain_graph=True))
    bb = lower_bound(8 * tb * 1024 * width * 2 + tb * heads * 1024 * 4,
                     10 * tb * heads * 1024 * 1024 * hd, BF16_FLOPS)
    timings["flash_attention_tokens_bwd"] = (ms, plain_ms, *bb, lib_ms)
    say(f"time flash_attention_tokens_bwd B={tb} L=1024 D={width} H={heads} bf16 "
        f"on {name}: kernel {ms:.4f} ms (with the delta reduce, the dq buffer's "
        f"zeroing and its cast), plain {plain_ms:.4f} ms, SDPA backward (autograd) "
        f"{lib_ms:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]})")
    del q, k, v, g, o, lse, qh, kh, vh, gh, oh
    train_ms = statistics.median(train_info["step_ms"][1:])
    say(f"time train step B={tb} (config_train_fast: bf16, flash, fast_math, full "
        f"width) on {name}: {train_ms:.3f} ms (median of steps 2-{TRAIN_STEPS}, "
        f"CUDA events)")

    if trace:
        profile(lambda: predict(frames), TRACE_RUNS, f"serving forward B={serve_batch}")
        profile(simulator.simulate_step, 20, "simulate_step 128^2")
        profile(lambda: trainer.train_step(next(train_batches)), 3,
                f"train step B={tb}")

    # ---------------------------------------------------------------- report
    fs = timings[("fused_step", 1)]
    fl = timings[("flash_attention_tokens", serve_batch)]
    kernels = [
        {
            "name": "fused_step",
            "route": "cuda",
            "source": "smokephysai_tpu_torch/csrc/fused_step.cu",
            "replaces": "smokephysai_tpu/ops/pallas/fused_step.py:239",
            "launches": launches["fused_step"],
            "max_abs_err": fused_err,
            "ms": fs[0], "plain_ms": fs[1], "bound_ms": fs[2], "bound_by": fs[3],
            "library_ms": None,
            "shape": "u(129,128) v(128,129) p,d(128,128) f32, 1 episode, 20 Jacobi sweeps",
        },
        {
            "name": "flash_attention_tokens",
            "route": "cuda",
            "source": "smokephysai_tpu_torch/csrc/flash_tokens.cu",
            "replaces": "smokephysai_tpu/ops/pallas/attention.py:521",
            "launches": launches["flash_attention_tokens"],
            "max_abs_err": max(e for (b, tg), e in flash_errs.items() if tg == "bfloat16"),
            "ms": fl[0], "plain_ms": fl[1], "bound_ms": fl[2], "bound_by": fl[3],
            "library_ms": library[serve_batch],
            "shape": f"[{serve_batch},1024,{width}] bf16, {heads} heads of 64",
        },
    ]
    ms_ = timings["fused_multi_step"]
    kernels.append({
        "name": "fused_multi_step",
        "route": "cuda",
        "source": "smokephysai_tpu_torch/csrc/fused_step.cu",
        "replaces": "smokephysai_tpu/ops/pallas/fused_step.py:278",
        "launches": data_info["counts"]["fused_multi_step"],
        "max_abs_err": max(multi_errs.values()),
        "ms": ms_[0], "plain_ms": ms_[1], "bound_ms": ms_[2], "bound_by": ms_[3],
        "library_ms": None,
        "shape": f"64 episodes x {T} steps at 128^2 f32, trajectory [64,{T},128,128]",
    })
    for kname, line, err in (
            ("flash_attention_tokens_fwd_lse", 315, lse_out_err),
            ("flash_attention_tokens_bwd", 366, bwd_errs["bfloat16"])):
        t_ = timings[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "smokephysai_tpu_torch/csrc/" + (
                "flash_tokens.cu" if kname.endswith("lse") else "flash_bwd.cu"),
            "replaces": f"smokephysai_tpu/ops/pallas/attention.py:{line}",
            "launches": train_info["counts"][kname],
            "max_abs_err": err,
            "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
            "library_ms": t_[4],
            "shape": f"[{tb},1024,{width}] bf16, {heads} heads of 64",
        })
    say(f"wall: {time.time() - T0:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi_line)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
