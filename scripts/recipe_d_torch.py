#!/usr/bin/env python
"""Recipe D trained by the PyTorch/CUDA port on the card, then gated.

    python3 scripts/recipe_d_torch.py --out DIR

Runs, in one process tree and in this order:

1. the card's name and power limit (nvidia-smi);
2. 20 train steps of each phase's step after 3 of warm-up (phase 1: the
   bf16 `config_twophase_bf16.yaml` step with `tpu.fast_math=false`; phase
   2: the float32 einsum `config_twophase_f32.yaml` step under the train
   CLI's TF32 setting, PyTorch's default), on 64 generated episodes, and
   the projected wall time of both phases. Where the projection does not
   fit `BUDGET_S` (a 3600 s chip call), the script writes the step times
   and stops;
3. phase 1 through the port's train CLI:
   `python -m smokephysai_tpu_torch.train --config
   config/config_twophase_bf16.yaml --set tpu.fast_math=false --set
   training.num_epochs=50`;
4. phase 2: `... --config config/config_twophase_f32.yaml --set
   training.num_epochs=50 --set training.schedule_epoch_offset=50
   --init_from <phase 1>/last_model.npz`, and a check that its first
   step's learning rate equals phase 1's schedule at epoch 50;
5. the 50-sample gate through the port's benchmark CLI on the JAX CLI's
   draws (`tests/goldens/gate_draws_128x128_n50_s0.npz`, `config.yaml`) for
   phase 2's last and best models and phase 1's last model, and for the
   committed JAX-trained `checkpoints/smokephysnet_128_fast2phase.npz`.

It writes `<out>/recipe_d_torch.json` (each phase's per-epoch train and
validation loss and learning rate, the step times, the gate's MSE,
correlation and ms per sample per model) and each phase's log there. No trained checkpoint leaves the card's machine (phase 1's export is
~112 MB). tests/test_torch_recipe.py checks the chain on the CPU.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASE1_CONFIG = "config/config_twophase_bf16.yaml"
PHASE2_CONFIG = "config/config_twophase_f32.yaml"
GATE_CONFIG = "config/config.yaml"
GATE_DRAWS = "tests/goldens/gate_draws_128x128_n50_s0.npz"
FAST2PHASE = "checkpoints/smokephysnet_128_fast2phase.npz"
GATE_MSE = 0.0022  # PARITY.md: the repo's 50-sample quality gate
EPOCHS = 50  # each phase's, as the recipe fixes them
BUDGET_S = 3540.0  # the whole run's wall time, within a 3600 s chip call
TIMING_EPISODES = 64
TIMED_STEPS = 20
WARM_STEPS = 3
GATE_RESERVE_S = 300  # the gates and the report, after the phases
STARTUP_S = 60  # a train CLI's start, dataset generation or load excluded
GEN_S_PER_EPISODE = 0.05  # generation of the 3400 episodes, host clock, generous


def say(*args):
    print(*args, flush=True)


def smi_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def phase_overrides(phase):
    if phase == 1:
        return ["tpu.fast_math=false", f"training.num_epochs={EPOCHS}"]
    return [f"training.num_epochs={EPOCHS}", f"training.schedule_epoch_offset={EPOCHS}"]


def time_steps(config, dev):
    """Step times (ms) of `config`'s train step: CUDA events between
    consecutive steps, no synchronisation inside the run, as `fit` runs
    them. Returns (per-step ms, mean ms)."""
    import torch

    from smokephysai_tpu_torch.data.synthetic import create_data_loaders
    from smokephysai_tpu_torch.train import loop

    data, tpu, bs = config["data"], config["tpu"], config["training"]["batch_size"]
    train_ds, _ = create_data_loaders(
        batch_size=bs, num_train=TIMING_EPISODES, num_val=bs,
        grid_size=tuple(data["grid_size"]), cache_dir=None,
        sequence_length=data["sequence_length"], seed=tpu["seed"],
        use_pallas=tpu["use_pallas"], vorticity_eps=tpu["vorticity_eps"], device=dev)
    gen = torch.Generator(dev).manual_seed(tpu["seed"])
    model = loop.init_parameters(loop.build_train_model(config, dev), gen)
    trainer = loop.Trainer(model, config, data["num_train"] // bs, gen)
    data_gen = torch.Generator().manual_seed(tpu["seed"])

    def batches():
        while True:
            yield from train_ds.epoch_batches(data_gen, bs, shuffle=True)

    it = batches()
    for _ in range(WARM_STEPS):
        trainer.train_step(next(it))
    torch.cuda.synchronize(dev)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    marks[0].record()
    losses = []
    for mark in marks[1:]:
        losses.append(trainer.train_step(next(it))["total_loss"])
        mark.record()
    marks[-1].synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    if not all(math.isfinite(float(x)) for x in losses):
        raise RuntimeError("non-finite loss in the timed train steps")
    del trainer, model, train_ds
    torch.cuda.empty_cache()
    return ms, sum(ms) / len(ms)


def run_phase(phase, config_path, overrides, init_from, timeout, out):
    """The train CLI in a process of its own; returns (exp_dir, seconds, rc)."""
    cmd = [sys.executable, "-m", "smokephysai_tpu_torch.train", "--config", config_path]
    for o in overrides:
        cmd += ["--set", o]
    if init_from:
        cmd += ["--init_from", init_from]
    log_path = os.path.join(out, f"phase{phase}.log")
    say(f"phase {phase}: {' '.join(cmd[1:])} (log {log_path}, time limit {timeout:.0f} s)")
    t = time.time()
    exp_dir, rc = None, None
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            deadline = t + timeout
            for line in proc.stdout:
                log.write(line)
                log.flush()
                if line.startswith("Epoch ") or "Checkpoints in" in line:
                    say(f"  phase {phase}: {line.rstrip()}")
                if "Checkpoints in" in line:
                    exp_dir = line.rsplit("Checkpoints in", 1)[1].strip()
                if time.time() > deadline:
                    proc.kill()
                    say(f"phase {phase}: over its time limit, stopped")
                    break
        finally:
            rc = proc.wait()
    if exp_dir is None:  # cut: the experiment directory the CLI made
        made = sorted(d for d in os.listdir(os.path.join(ROOT, "experiments"))
                      if d.startswith("smokephys_"))
        exp_dir = os.path.join("experiments", made[-1]) if made else None
    return exp_dir, time.time() - t, rc


def read_epochs(exp_dir):
    path = os.path.join(ROOT, exp_dir, "epochs.jsonl") if exp_dir else ""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def gate(checkpoint):
    from smokephysai_tpu_torch import benchmark

    argv = ["--config", os.path.join(ROOT, GATE_CONFIG), "--checkpoint", checkpoint,
            "--samples", os.path.join(ROOT, GATE_DRAWS)]
    t = time.time()
    result = benchmark.main(argv)["model"]
    return {"mse": result["mse"], "physics_correlation": result["physics_correlation"],
            "ms_per_sample": result["inference_time"] * 1e3,
            "passes_gate": result["mse"] <= GATE_MSE, "seconds": time.time() - t}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True, help="directory for the report and logs")
    args = parser.parse_args()
    start = time.time()
    os.makedirs(args.out, exist_ok=True)

    import torch

    from smokephysai_tpu_torch.train.loop import cosine_epoch_schedule
    from smokephysai_tpu_torch.utils.config import apply_overrides, load_config

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script trains on the card")
    dev = torch.device("cuda")
    report = {"card": smi_line(), "device": torch.cuda.get_device_name(dev),
              "epochs_per_phase": EPOCHS, "seed": 0}
    say(f"card: {report['card']} ({report['device']})")
    out_json = os.path.join(args.out, "recipe_d_torch.json")

    def write():
        report["seconds"] = time.time() - start
        with open(out_json, "w") as f:
            json.dump(report, f, indent=1)
        say(f"wrote {out_json}")

    configs = {p: apply_overrides(load_config(os.path.join(ROOT, c)),
                                  phase_overrides(p))
               for p, c in ((1, PHASE1_CONFIG), (2, PHASE2_CONFIG))}
    steps = {}
    for p, config in configs.items():
        ms, mean = time_steps(config, dev)
        data = config["data"]
        n = EPOCHS * (data["num_train"] // config["training"]["batch_size"])
        steps[p] = {"step_ms": ms, "mean_ms": mean, "median_ms": statistics.median(ms),
                    "steps": n, "projected_s": n * mean / 1e3}
        say(f"phase {p} step: mean {mean:.3f} ms, median {statistics.median(ms):.3f} ms "
            f"over {len(ms)} steps after {WARM_STEPS} warm-up; {n} steps project "
            f"{n * mean / 1e3:.0f} s")
    episodes = configs[1]["data"]["num_train"] + configs[1]["data"]["num_val"]
    projected = (sum(s["projected_s"] for s in steps.values()) * 1.1 + 2 * STARTUP_S
                 + episodes * GEN_S_PER_EPISODE + GATE_RESERVE_S)
    left = BUDGET_S - (time.time() - start)
    report["step_times"] = steps
    report["projected_s"] = projected
    say(f"projected wall time {projected:.0f} s (steps x 1.1, starts, generation, gates) "
        f"against {left:.0f} s left of the {BUDGET_S:.0f} s budget")
    if projected > left:
        report["status"] = "stopped: the projection does not fit the budget"
        write()
        return

    deadline = start + BUDGET_S
    timeout1 = deadline - time.time() - steps[2]["projected_s"] * 1.1 - STARTUP_S - GATE_RESERVE_S
    exp1, s1, rc1 = run_phase(1, PHASE1_CONFIG, phase_overrides(1), None,
                              timeout1, args.out)
    report["phase1"] = {"exp_dir": exp1, "seconds": s1, "rc": rc1,
                        "epochs": read_epochs(exp1)}
    last1 = os.path.join(ROOT, exp1, "last_model.npz") if exp1 else None
    if rc1 != 0 or not last1 or not os.path.exists(last1):
        report["status"] = f"phase 1 failed (rc {rc1})"
        write()
        raise SystemExit(1)
    exp2, s2, rc2 = run_phase(2, PHASE2_CONFIG, phase_overrides(2), last1,
                              deadline - time.time() - GATE_RESERVE_S, args.out)
    epochs2 = read_epochs(exp2)
    report["phase2"] = {"exp_dir": exp2, "seconds": s2, "rc": rc2, "epochs": epochs2}

    # the schedule's boundary: phase 2's first step against phase 1's
    # schedule at its last epoch + 1
    tc1 = configs[1]["training"]
    spe = configs[1]["data"]["num_train"] // tc1["batch_size"]
    want = cosine_epoch_schedule(tc1["learning_rate"], tc1["num_epochs"], spe,
                                 tc1.get("schedule_epochs"))(EPOCHS * spe)
    got = epochs2[0]["lr"] if epochs2 else None
    report["lr_boundary"] = {"phase2_first_step": got, "phase1_schedule_at_epoch": want,
                             "equal": got == want}
    say(f"lr at phase 2's first step {got} against phase 1's schedule at epoch "
        f"{EPOCHS}: {want} ({'equal' if got == want else 'DIFFERENT'})")

    gates = {}
    candidates = [("phase2_last", os.path.join(exp2 or "", "last_model.npz")),
                  ("phase2_best", os.path.join(exp2 or "", "best_model.npz")),
                  ("phase1_last", os.path.join(exp1, "last_model.npz")),
                  ("fast2phase_jax", FAST2PHASE)]
    for label, path in candidates:
        path = os.path.join(ROOT, path)
        if os.path.exists(path):
            gates[label] = gate(path)
            say(f"gate {label}: {gates[label]}")
    report["gate"] = gates
    ok = rc2 == 0 and "phase2_last" in gates and report["lr_boundary"]["equal"]
    report["status"] = "ran" if ok else f"phase 2 incomplete (rc {rc2})"
    write()
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
