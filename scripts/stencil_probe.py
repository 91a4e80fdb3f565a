#!/usr/bin/env python3
"""Times the Jacobi pressure kernel (csrc/jacobi.cu) and the diffusion kernel
(csrc/stencil.cu) on one CUDA card, against another checkout's in turns.

    python3 scripts/stencil_probe.py [--root DIR] [--plans] [--step] [--runs N]

Prints the card's name and power limit, then one JSON line per shape and
tree. Jacobi: `jacobi_pressure` at [1,256,256], [8,256,256], [1,512,512],
[1,1024,1024] and [1,2048,2048], 20 sweeps (the last two in the band
mode); diffusion: a solver step's three staggered
256^2 fields (u [E,257,256], v [E,256,257], density [E,256,256]) at 1 and
8 episodes. Each line has the CUDA-event median ms through the wrappers
(`runs` calls, default 20), the device time of the kernels the call
launches (torch.profiler), the launches per call and this tree's launch
plan.

With `--root DIR` (for instance the parent commit unpacked by `git archive`
into a git-ignored directory), the package under DIR is imported too, under
another name, and its own sources are built into its own `_build/`; each
shape is then timed on both trees in turns: DIR, this tree, this tree, DIR.
The other tree's diffusion is the solver's call of it: one `diffuse` for
each field (three launches), or its `diffuse_fields` where it has one.
With `--plans`, each Jacobi shape is also timed under every other plan of
this tree's `plan_candidates` (the cluster mode) or `band_candidates` (the
band mode), through the wrapper's own launcher, at 0 and 20 sweeps (the
ms a launch of a CUDA graph of 20 launches, replayed: the slope is the
time a sweep, the rest the load, the store and the launch), each checked
bit-equal to the default plan. With `--step`, it also times the vorticity
per-op solver step (config_256_vorticity.yaml: dt 0.01, viscosity 0.001,
20 Jacobi sweeps, vorticity_eps 2.0) at 256^2 with 1 and 8 episodes, on
both trees in turns: events, device time and the launches of both kernels
per step. Every result of the two trees is checked bit-equal. The timers
are chip_smoke.py's.
"""
import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402  (the timers)

JACOBI_SHAPES = ((1, 256, 256), (8, 256, 256), (1, 512, 512), (1, 1024, 1024),
                 (1, 2048, 2048))
EPISODES = (1, 8)
GRID = 256
DT, VISC, ITERS, EPS = 0.01, 0.001, 20, 2.0  # config_256_vorticity.yaml's step


def load_tree(root):
    """The package `smokephysai_tpu_torch` of the checkout at `root`, under
    the name `other_smokephysai_tpu_torch`."""
    name = "other_smokephysai_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "smokephysai_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return name


class Tree:
    """One checkout's kernels and per-op step."""

    def __init__(self, package, label):
        self.label = label
        self.jacobi = importlib.import_module(f"{package}.ops.jacobi")
        self.stencil = importlib.import_module(f"{package}.ops.stencil")
        self.solver = importlib.import_module(f"{package}.physics.solver")

    def diffuse_step(self, fields, coef_uv, coef_d):
        """The diffusion of a step's three fields as this tree's solver
        calls it."""
        s = self.stencil
        if hasattr(s, "diffuse_fields"):
            return s.diffuse_fields(*fields, coef_uv, coef_d)
        u, v, d = fields
        return s.diffuse(u, coef_uv), s.diffuse(v, coef_uv), s.diffuse(d, coef_d)

    def counts(self):
        return self.jacobi.LAUNCHES, self.stencil.LAUNCHES


def measure(tree, fn, runs):
    """Events ms, device ms and (Jacobi, diffusion) launches of one call."""
    j0, s0 = tree.counts()
    out = fn()
    j1, s1 = tree.counts()
    return out, {"tree": tree.label, "ms": smoke.timed(fn, runs),
                 "device_ms": smoke.device_ms(fn, runs),
                 "launches": {"jacobi_pressure": j1 - j0, "diffuse": s1 - s0}}


def graph_ms(fn, launches=20, replays=5):
    """Device ms per call of `fn`: a CUDA graph of `launches` calls,
    replayed `replays` times between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (launches * replays)


def in_turns(trees, make_fn, runs, what):
    """Times `make_fn(tree)` on the trees in turns (the other, this, this,
    the other; or this tree twice) and prints a JSON line each; fails
    unless every call gives the same bits."""
    import torch

    order = [trees[1], trees[0], trees[0], trees[1]] if len(trees) > 1 else trees * 2
    first = None
    for tree in order:
        out, row = measure(tree, make_fn(tree), runs)
        flat = torch.cat([t.reshape(-1) for t in (out if isinstance(out, tuple) else (out,))])
        if first is None:
            first = flat
        row["bit_equal"] = bool(torch.equal(flat, first))
        print(json.dumps({**what, **row}), flush=True)
        if not row["bit_equal"]:
            sys.exit(f"stencil_probe: {what} differs between the trees")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    trees = [Tree("smokephysai_tpu_torch", "this")]
    if args.root:
        trees.append(Tree(load_tree(args.root), os.path.abspath(args.root)))
    this = trees[0]
    gen = torch.Generator().manual_seed(4)

    for shape in JACOBI_SHAPES:
        p = (0.1 * torch.randn(*shape, generator=gen)).to(dev)
        div = torch.randn(*shape, generator=gen).to(dev)
        plan = this.jacobi.launch_plan(*shape, device=dev, num_iters=ITERS)
        in_turns(trees, lambda t: (lambda: t.jacobi.jacobi_pressure(p, div, ITERS)), args.runs,
                 {"kernel": "jacobi_pressure", "shape": list(shape), "sweeps": ITERS,
                  "plan": plan.describe()})
        if args.plans:
            card = this.jacobi.card_active_clusters(torch.cuda.current_device())
            want = this.jacobi.jacobi_pressure(p, div, ITERS)
            rows = {}
            others = (this.jacobi.plan_candidates(*shape, card) if plan.mode == "cluster" else
                      this.jacobi.band_candidates(*shape, ITERS, card))
            for alt in [plan, *others]:
                if alt.describe() in rows:
                    continue
                fns = {k: (lambda k=k: this.jacobi._launch(p, div, k, alt)) for k in (0, ITERS)}
                rows[alt.describe()] = {
                    "graph_ms": {k: graph_ms(fn) for k, fn in fns.items()},
                    "bit_equal": bool(torch.equal(fns[ITERS](), want))}
            print(json.dumps({"kernel": "jacobi_pressure", "shape": list(shape),
                              "plans": rows}), flush=True)
            if not all(r["bit_equal"] for r in rows.values()):
                sys.exit(f"stencil_probe: a plan of {shape} differs from the default")
        del p, div

    coef_uv = np.float32(DT) * np.float32(VISC)
    coef_d = np.float32(DT) * (np.float32(VISC) * np.float32(0.1))
    for episodes in EPISODES:
        fields = [torch.rand(episodes, *s, generator=gen).to(dev)
                  for s in ((GRID + 1, GRID), (GRID, GRID + 1), (GRID, GRID))]
        in_turns(trees, lambda t: (lambda: t.diffuse_step(fields, coef_uv, coef_d)), args.runs,
                 {"kernel": "diffuse (a step's three fields)", "episodes": episodes,
                  "grid": GRID})

    if args.step:
        for episodes in EPISODES:
            g = torch.Generator().manual_seed(5)
            density = torch.rand(episodes, GRID, GRID, generator=g).to(dev)
            u = 0.5 * torch.randn(episodes, GRID + 1, GRID, generator=g).to(dev)
            v = 0.5 * torch.randn(episodes, GRID, GRID + 1, generator=g).to(dev)

            def make(t):
                s = t.solver.init_state((GRID, GRID), device=dev, batch=(episodes,))
                s = s.replace(u=u, v=v, density=density)

                def step():
                    out = t.solver.step(s, DT, VISC, ITERS, EPS, use_pallas=True)
                    return out.u, out.v, out.p, out.density
                return step

            in_turns(trees, make, args.runs,
                     {"step": "vorticity per-op step", "episodes": episodes, "grid": GRID})


if __name__ == "__main__":
    main()
