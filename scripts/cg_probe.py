#!/usr/bin/env python3
"""Times the CG pressure kernel (csrc/cg3d.cu) on one CUDA card.

    python3 scripts/cg_probe.py [--root DIR] [--plans] [--step] [--runs N] [--iters N]

Prints the card's name and power limit, then one JSON line per shape:
`cg_pressure` from a warm p0 at [1,128,128,128] (the volumetric path's
solve), [2,64,64,64], [1,37,53,29], [2,128,128,128] (two waves) and
[1,160,160,160] (the global mode), `iters` iterations
(default 30), each with the CUDA-event median ms of `runs` calls (default
20, each call between two events), the kernel's device time per solve
(torch.profiler: every kernel the call launches), the launches per solve
and the launch plan it took. `--root` imports the package from another
checkout (for instance an unpacked parent commit, whose kernel has no
launch plan), so that two versions can be timed in turns in one call:
parent, change, change, parent. With `--plans`, each shape is also timed
under every other on-chip plan the card holds (`plan_candidates`) and the
global mode, through the wrapper's own launcher, and checked against the
default plan (bit-equal: the cut changes no sum). The timers are
chip_smoke.py's. With `--step`, it first times the volumetric solver step
that calls the kernel (`physics.solver3d.step3d` at 128^3 with
`use_pallas`, config_128cubed.yaml's dt and viscosity, one smoke source):
events, device time (all its kernels) and the wall time of back-to-back
steps.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402  (the timers)

SHAPES = ((1, 128, 128, 128), (2, 64, 64, 64), (1, 37, 53, 29), (2, 128, 128, 128),
          (1, 160, 160, 160))
DT, VISC = 0.01, 0.001  # config/config_128cubed.yaml's


def loop_ms(fn, calls):
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
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--step", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from smokephysai_tpu_torch.ops import cg3d as cg_ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    has_plan = hasattr(cg_ops, "launch_plan")
    gen = torch.Generator().manual_seed(4)
    iters = args.iters
    if args.step:
        from smokephysai_tpu_torch.physics import solver3d

        state = solver3d.init_state3d((128, 128, 128), device=dev, batch=(1,))
        state = state.replace(density=solver3d.add_smoke_source3d(
            state.density, 64.0, 20.0, 64.0, radius=8.0))

        def step():
            return solver3d.step3d(state, DT, VISC, use_pallas=True)

        print(json.dumps({"root": os.path.abspath(args.root), "step3d": [1, 128, 128, 128],
                          "ms": smoke.timed(step, args.runs),
                          "device_ms": smoke.device_ms(step, args.runs),
                          "loop_ms": loop_ms(step, 3 * args.runs)}), flush=True)
    for shape in SHAPES:
        div = torch.randn(*shape, generator=gen).to(dev)
        p0 = (0.1 * torch.randn(*shape, generator=gen)).to(dev)

        def call():
            return cg_ops.cg_pressure(p0, div, iters)

        row = {"root": os.path.abspath(args.root), "shape": list(shape), "iters": iters,
               "ms": smoke.timed(call, args.runs),
               "device_ms": smoke.device_ms(call, args.runs),
               "launches_per_solve": cg_ops.launches_per_solve(iters)}
        if has_plan:
            plan = cg_ops.launch_plan(*shape, device=dev)
            row["plan"] = plan.describe()
            if args.plans:
                ref = call()
                card = cg_ops.card_occupancy(torch.cuda.current_device())
                alts = {}
                for alt in [*cg_ops.plan_candidates(*shape, *card),
                            cg_ops.plan_launch(*shape, *card, mode="global")]:
                    if alt == plan:
                        continue
                    fn = lambda: cg_ops._launch(p0, div, iters, alt)  # noqa: E731
                    alts[alt.describe()] = {
                        "ms": smoke.timed(fn, max(3, args.runs // 2)),
                        "device_ms": smoke.device_ms(fn, max(3, args.runs // 2)),
                        "bit_equal": torch.equal(fn(), ref)}
                row["other_plans"] = alts
        print(json.dumps(row), flush=True)
        del div, p0


if __name__ == "__main__":
    main()
