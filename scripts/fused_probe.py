#!/usr/bin/env python3
"""Times the fused solver kernels (csrc/fused_step.cu) on one CUDA card.

    python3 scripts/fused_probe.py [--root DIR] [--plans] [--host] [--runs N]

Prints the card's name and power limit, then one JSON line per shape:
`fused_step` at 128^2 with 1 and 64 episodes and at 1024^2 with 1, and
`fused_multi_step` at 128^2 with 64 episodes x 20 steps (20 Jacobi sweeps,
max_disp 1), each with the CUDA-event median ms of `runs` calls (default
20, each call between two events, the wrapper's host time included where
the card waits for it), the kernel's device time (torch.profiler), the
wall time per call of back-to-back calls, and the launch plan it took.
`--root` imports the package from another checkout (for instance an
unpacked parent commit, whose kernels may have no launch plan), so that
two versions can be timed in turns in one call.
With `--plans`, each shape is also timed under every other plan that the
launch plan weighs (`plan_candidates`: each cluster size, row width of one
or two warps and count of thread rows that fits the card; events and
device time), through the wrappers' own launcher, and checked against the
default plan (bit-equal: the cut changes no cell's arithmetic). The states
and timers are chip_smoke.py's.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402  (the states and the timers)

DT, VISC, ITERS, MAX_DISP, T = 0.01, 0.001, 20, 1, 20


def loop_ms(fn, calls=200):
    """Wall ms per call of `calls` back-to-back calls (one synchronise at
    the end): the larger of the host's and the card's time per call."""
    import time

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--host", action="store_true",
                    help="first profile the host side of 2000 calls of fused_step at "
                         "128^2 x 1 (cProfile, top entries by own time)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from smokephysai_tpu_torch.ops import fused_step as step_ops

    iters = args.iters

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    has_plan = hasattr(step_ops, "launch_plan")
    if args.host:
        import cProfile
        import pstats

        f = smoke.smoke_state(dev, 1, 128)
        for _ in range(20):
            step_ops.fused_step(*f, DT, VISC, iters, MAX_DISP)
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(2000):
            step_ops.fused_step(*f, DT, VISC, iters, MAX_DISP)
        torch.cuda.synchronize()
        prof.disable()
        pstats.Stats(prof).sort_stats("tottime").print_stats(15)
    for name, episodes, size in (("fused_step", 1, 128), ("fused_step", 64, 128),
                                 ("fused_multi_step", 64, 128), ("fused_step", 1, 1024)):
        f = smoke.smoke_state(dev, episodes, size)
        multi = name == "fused_multi_step"
        if multi:
            call = lambda: step_ops.fused_multi_step(*f, T, DT, VISC, iters, MAX_DISP)  # noqa: E731
        else:
            call = lambda: step_ops.fused_step(*f, DT, VISC, iters, MAX_DISP)  # noqa: E731
        runs = args.runs if size < 1024 or has_plan else 3
        row = {"root": os.path.abspath(args.root), "iters": iters, "kernel": name,
               "episodes": episodes, "grid": size, "ms": smoke.timed(call, runs),
               "device_ms": smoke.device_ms(call, max(3, runs)),
               "loop_ms": loop_ms(call, 200 if size < 1024 and not multi else 10)}
        if has_plan:
            plan = step_ops.launch_plan(episodes, size, size, MAX_DISP, multi=multi,
                                        device=dev)
            row["plan"] = plan.describe()
            if args.plans:
                ref = call()
                alts = {}
                count = step_ops.card_active_clusters(torch.cuda.current_device(), multi,
                                                       MAX_DISP)
                for alt in step_ops.plan_candidates(episodes, size, size, MAX_DISP, count,
                                                    plan.mode):
                    if alt == plan:
                        continue
                    steps = T if multi else None
                    fn = lambda: step_ops._launch(*f, steps, DT, VISC, iters, MAX_DISP, alt)  # noqa: E731
                    got = fn()
                    got = (*got[0], got[1]) if multi else got[0]
                    want = (*ref[0], ref[1]) if multi else ref
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    alts[alt.describe()] = {"ms": smoke.timed(fn, max(3, args.runs // 2)),
                                            "device_ms": smoke.device_ms(fn,
                                                                         max(3, args.runs // 2)),
                                            "bit_equal": same}
                row["other_plans"] = alts
        print(json.dumps(row), flush=True)
        del f


if __name__ == "__main__":
    main()
