#!/usr/bin/env python3
"""The spread of chip_smoke.py's bf16 train-step check on one CUDA card.

    python3 scripts/train_check_probe.py [--repeats N] [--later N]

From the root of a checkout. chip_smoke's training phase takes TRAIN_STEPS
steps of config_train_fast.yaml (bf16, use_flash) and then holds one more
step through the kernels against the same step through the plain backward:
each layer's q, k, v projection gradients within 2^-8, the last layer's
within 2^-10. The fused backward sums dQ by atomics, so the weights those
steps reach differ from run to run. This script shows how far the check's
reading moves with them:

- `--repeats` times (default 30) from the same initial weights, generator
  and batches: TRAIN_STEPS steps, then the check step on the fused route,
  on the split route (SMOKEPHYS_FUSED_BWD=0, no atomics) and through the
  plain backward; prints the last layer's largest ||d|| / ||ref|| of each
  route against the plain backward, of the fused route against the split,
  and of all layers for the fused route;
- then `--later` checks (default 25) along one longer run, two steps apart.

Prints how many readings cross the bound, and the medians and maxima.
Needs nvcc (the kernels build as the wrappers build them).
"""
import argparse
import copy
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402  (the phase's dataset, twins and bounds)

ROUTES = ("fused", "split", "plain backward")


def check(config, model, trainer, batch, spe):
    """{route: the q, k, v projection gradients} of one step from the
    model's weights through each route, as chip_smoke takes it."""
    import torch

    from smokephysai_tpu_torch.models import chaos_attention as ca_mod
    from smokephysai_tpu_torch.ops import attention as attn_ops
    from smokephysai_tpu_torch.train import loop

    dev = next(model.parameters()).device
    fields = model.chaos_fields(trainer.generator, config["training"]["batch_size"], dev)
    state = copy.deepcopy(model.state_dict())
    grads = {}
    for route in ROUTES:
        twin = loop.build_train_model(config, dev)
        twin.load_state_dict(state)
        tw = loop.Trainer(twin, config, spe, torch.Generator(dev).manual_seed(1))
        tw.step = trainer.step
        if route == "split":
            with smoke.split_backward():
                m = tw.train_step(batch, chaos_fields=fields)
        elif route == "plain backward":
            with smoke.PlainFlash(attn_ops, ca_mod, forward=False):
                m = tw.train_step(batch, chaos_fields=fields)
        else:
            m = tw.train_step(batch, chaos_fields=fields)
        clip = min(1.0, 1.0 / float(m["grad_norm"]))
        grads[route] = {n: p.grad / clip for n, p in twin.named_parameters()
                        if n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight"))}
    return grads


def readings(grads, layers):
    """(last layer fused, last layer split, fused vs split, all layers
    fused): the largest ||d|| / ||ref|| of each."""
    top = f"layer_{layers - 1}."

    def worst(a, b, last=True):
        return max(smoke.rel_norm(grads[a][n], grads[b][n]) for n in grads[b]
                   if n.startswith(top) or not last)

    return (worst("fused", "plain backward"), worst("split", "plain backward"),
            worst("fused", "split"), worst("fused", "plain backward", last=False))


def summary(label, rows):
    names = ("last layer, fused", "last layer, split", "last layer, fused vs split",
             "all layers, fused")
    bounds = (smoke.TRAIN_BWD_TOP_PROJ_GRAD_REL_NORM,) * 3 + (smoke.TRAIN_BWD_PROJ_GRAD_REL_NORM,)
    for i, (name, bound) in enumerate(zip(names, bounds)):
        v = [r[i] for r in rows]
        print(f"{label} {name}: median {statistics.median(v):.3e}, max {max(v):.3e}, "
              f"{sum(x > bound for x in v)} of {len(v)} over {bound:.3e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--later", type=int, default=25)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from smokephysai_tpu_torch.train import loop

    dev = torch.device("cuda")
    config, train_ds, _, _ = smoke.dataset_phase(dev)
    bs, seed = config["training"]["batch_size"], config["tpu"]["seed"]
    layers = config["model"]["num_layers"]
    spe = max(len(train_ds) // bs, 1)
    gen = torch.Generator(dev).manual_seed(seed)
    model = loop.build_train_model(config, dev)
    loop.init_parameters(model, gen)
    init_state, gen_state = copy.deepcopy(model.state_dict()), gen.get_state()

    def fresh():
        model.load_state_dict(init_state)
        gen.set_state(gen_state)
        data_gen = torch.Generator().manual_seed(seed)

        def batches():
            while True:
                yield from train_ds.epoch_batches(data_gen, bs, shuffle=True)

        return loop.Trainer(model, config, spe, gen), batches()

    def line(label, trainer, r):
        print(f"{label} at step {trainer.step}: last layer fused {r[0]:.3e}, split {r[1]:.3e} "
              f"(vs the plain backward), fused vs split {r[2]:.3e}; all layers fused "
              f"{r[3]:.3e}", flush=True)

    rows = []
    for rep in range(args.repeats):
        trainer, it = fresh()
        for _ in range(smoke.TRAIN_STEPS):
            trainer.train_step(next(it))
        rows.append(readings(check(config, model, trainer, next(it), spe), layers))
        line(f"repeat {rep}", trainer, rows[-1])
    if rows:
        summary(f"after {smoke.TRAIN_STEPS} steps, {args.repeats} repeats:", rows)
    else:
        trainer, it = fresh()
        for _ in range(smoke.TRAIN_STEPS):
            trainer.train_step(next(it))
    later = []
    for i in range(args.later):
        for _ in range(2):
            trainer.train_step(next(it))
        later.append(readings(check(config, model, trainer, next(it), spe), layers))
        line(f"later {i}", trainer, later[-1])
    if later:
        summary(f"along one run, {args.later} checks:", later)


if __name__ == "__main__":
    main()
