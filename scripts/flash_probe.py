#!/usr/bin/env python3
"""Where the time of the flash kernels (csrc/flash_tokens.cu,
csrc/flash_bwd.cu) goes, on one CUDA card.

    python3 scripts/flash_probe.py [--rounds N]
    python3 scripts/flash_probe.py --f32 [--root DIR] [--rounds N]

From the root of a checkout. For the lean forward at the serving shape
[64,1024,512] and the forward with logsumexp at the training shape
[8,1024,512] (bf16, 8 heads of 64), prints in turns, `--rounds` rounds
(default 3), and then the medians:

- the kernel's device time (torch.profiler, mean over 30 calls) beside
  SDPA's on the same tensors in the head-major view;
- the device time of two measurement-only builds of the same source, whose
  results are wrong: `-DFLASH_PROBE_NO_KV_LOADS` (K and V loaded for the
  first tiles only and then reused: what the loads cost) and
  `-DFLASH_PROBE_NO_EXP` (each exponential replaced by its input: what the
  MUFU costs);
- the host time per call of the two wrappers and of SDPA at [1,128,512]
  (2000 calls that the card keeps up with, on the host clock);
- the backward at the training shape [8,1024,512] (8 heads of 64) and at
  [8,512,256] (8 heads of 32): the device time of the fused kernel, of
  the fused kernel built with `-DFLASH_PROBE_NO_DQ_RED` (its dQ reductions
  left out, a wrong dq: what they cost), the split route's dq kernel and
  dk/dv kernel (each launched alone on one delta, as the route gives it)
  and SDPA's backward kernels (autograd through SDPA on the same tensors
  in the head-major view), in turns.

With `--f32`, only the float32 kernels instead, at [1,512,256] (8 heads of
32: the 3D trunk at B = 1) and [8,1024,512] (8 heads of 64: the float32 2D
train step): the lean forward, the forward with logsumexp, the fused
backward kernel alone (delta given), the split dq and dk/dv kernels alone,
and SDPA's float32 forward and backward (autograd) on the same tensors in
the head-major view, each as CUDA-event ms (median of 20 calls, chip_smoke's
timer) and device ms (torch.profiler), `--rounds` rounds in turns. With
`--root DIR` (the parent commit unpacked by `git archive` into a
git-ignored directory), the package under DIR is imported too, under
another name, builds its own sources into its own `_build/`, and each
kernel is timed on both trees in turns: DIR, this tree, this tree, DIR.

Prints the card's name and power limit first. Needs nvcc (the builds land
in smokephysai_tpu_torch/_build/ as the wrappers' do).
"""
import argparse
import importlib
import importlib.util
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402  (the event timer)
VARIANTS = ((), ("-DFLASH_PROBE_NO_KV_LOADS",), ("-DFLASH_PROBE_NO_EXP",))
NO_DQ_RED = ("-DFLASH_PROBE_NO_DQ_RED",)


def device_ms(fn, calls=30):
    """Mean device time per call of the kernels `fn` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us == 0:
        sys.exit("the profiler recorded no device time")
    return us / calls / 1e3


def host_us(fn, calls=2000):
    """Host time per call of `fn` in a loop the card keeps up with."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def backward_rounds(attn, dev, gen, rounds):
    """Device time of the three backward kernels and of SDPA's backward,
    in turns, `rounds` rounds, then the medians."""
    import torch

    def without_dq_red(fn):
        def call():
            attn.FLAGS = NO_DQ_RED
            try:
                fn()
            finally:
                attn.FLAGS = ()
        return call

    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for batch, length, width, heads in ((8, 1024, 512, 8), (8, 512, 256, 8)):
        hd = width // heads
        q, k, v, g = (torch.randn(batch, length, width, generator=gen)
                      .to(dev, torch.bfloat16) for _ in range(4))
        o, lse = attn.flash_attention_tokens_fwd_lse(q, k, v, heads)
        delta = attn._delta(o, g, heads)
        dq32 = torch.zeros(q.shape, dtype=torch.float32, device=dev)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        qh, kh, vh = (x.view(batch, length, heads, hd).transpose(1, 2).detach()
                      .requires_grad_() for x in (q, k, v))
        gh = g.view(batch, length, heads, hd).transpose(1, 2)
        oh = sdpa(qh, kh, vh)
        t = (q, k, v, g, lse, delta, heads, 1.0)
        fused = (lambda t=t, o=(dq32, dk, dv): attn._launch_bwd("flash_tokens_bwd", o, *t))
        cases.append((f"[{batch},{length},{width}] hd {hd}", (
            ("fused kernel", fused),
            ("fused kernel without dQ reductions", without_dq_red(fused)),
            ("dq kernel", lambda t=t: attn._launch_bwd_dq(*t)),
            ("dk/dv kernel", lambda t=t: attn._launch_bwd_dkv(*t)),
            ("SDPA backward", lambda a=(oh, (qh, kh, vh), gh):
                torch.autograd.grad(a[0], a[1], a[2], retain_graph=True)))))
    readings = {}
    for r in range(rounds):
        for case, fns in cases:
            for name, fn in fns:
                ms = device_ms(fn)
                readings.setdefault((case, name), []).append(ms)
                print(f"round {r} backward {case} {name}: device {ms:.4f} ms", flush=True)
    for (case, name), values in readings.items():
        print(f"median backward {case} {name}: device {statistics.median(values):.4f} ms "
              f"({len(values)} rounds)")


def load_tree(root):
    """The attention module of the checkout at `root`, its package imported
    under the name `other_smokephysai_tpu_torch`."""
    name = "other_smokephysai_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "smokephysai_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.attention")


F32_SHAPES = ((1, 512, 256, 8), (8, 1024, 512, 8))  # batch, L, width, heads


def f32_calls(attn, q, k, v, g, heads, lse, delta):
    """{kernel: call} of one tree's float32 kernels on these tensors."""
    import torch

    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = q.new_empty(q.shape), q.new_empty(q.shape)
    t = (q, k, v, g, lse, delta, heads, 1.0)
    return {
        "lean": lambda: attn.flash_attention_tokens(q, k, v, heads),
        "lse": lambda: attn.flash_attention_tokens_fwd_lse(q, k, v, heads),
        "fused": lambda: attn._launch_bwd("flash_tokens_bwd", (dq32, dk, dv), *t),
        "dq": lambda: attn._launch_bwd_dq(*t),
        "dkv": lambda: attn._launch_bwd_dkv(*t)}


def f32_rounds(trees, dev, gen, rounds):
    """The float32 kernels of each tree and SDPA's float32 calls, in turns."""
    import torch

    this = trees[0][1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    readings = {}
    for batch, length, width, heads in F32_SHAPES:
        hd = width // heads
        case = f"[{batch},{length},{width}] hd {hd}"
        q, k, v, g = (torch.randn(batch, length, width, generator=gen).to(dev)
                      for _ in range(4))
        o, lse = this.flash_attention_tokens_fwd_lse_reference(q, k, v, heads)
        delta = this._delta(o, g, heads)
        qh, kh, vh = (x.view(batch, length, heads, hd).transpose(1, 2).detach()
                      .requires_grad_() for x in (q, k, v))
        gh = g.view(batch, length, heads, hd).transpose(1, 2)
        oh = sdpa(qh, kh, vh)
        calls = {"SDPA forward": lambda: sdpa(qh.detach(), kh.detach(), vh.detach()),
                 "SDPA forward, inputs need grad": lambda: sdpa(qh, kh, vh),
                 "SDPA backward": lambda: torch.autograd.grad(oh, (qh, kh, vh), gh,
                                                              retain_graph=True)}
        for label, attn in trees:
            for kname, fn in f32_calls(attn, q, k, v, g, heads, lse, delta).items():
                calls[f"{kname} ({label})"] = fn
        order = list(calls)
        for r in range(rounds):
            # in turns: the other tree's calls, this tree's, this tree's, the other's
            seq = order if r % 2 == 0 else order[::-1]
            for name in seq:
                ev, dv_ = smoke.timed(calls[name]), device_ms(calls[name])
                readings.setdefault((case, name), []).append((ev, dv_))
                print(f"round {r} f32 {case} {name}: {ev:.4f} ms (events), device "
                      f"{dv_:.4f} ms", flush=True)
        del q, k, v, g, o, lse, delta, qh, kh, vh, gh, oh, calls
    for (case, name), values in readings.items():
        print(f"median f32 {case} {name}: {statistics.median(e for e, _ in values):.4f} ms "
              f"(events), device {statistics.median(d for _, d in values):.4f} ms "
              f"({len(values)} rounds)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from smokephysai_tpu_torch.ops import _build
    from smokephysai_tpu_torch.ops import attention as attn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    if args.f32:
        torch.backends.cuda.matmul.allow_tf32 = False
        trees = [("this", attn)]
        if args.root:
            trees.append((os.path.abspath(args.root), load_tree(args.root)))
        f32_rounds(trees, torch.device("cuda"), torch.Generator().manual_seed(0),
                   args.rounds)
        return
    _build.build_all([(attn.SOURCE, flags) for flags in VARIANTS]
                     + [(attn.BWD_SOURCE, flags) for flags in ((), NO_DQ_RED)])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = 8
    cases = []
    for name, batch, fwd in (("lean", 64, attn.flash_attention_tokens),
                             ("lse", 8, attn.flash_attention_tokens_fwd_lse)):
        q, k, v = (torch.randn(batch, 1024, 512, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(3))
        qh, kh, vh = (x.view(batch, 1024, heads, 64).transpose(1, 2) for x in (q, k, v))
        cases.append((f"{name} [{batch},1024,512]", lambda f=fwd, t=(q, k, v): f(*t, heads),
                      lambda t=(qh, kh, vh): sdpa(*t)))
    readings = {}
    for r in range(args.rounds):
        for flags in VARIANTS:
            attn.FLAGS = flags
            tag = " ".join(flags) or "kernel"
            for case, fn, ref in cases:
                ms = device_ms(fn)
                readings.setdefault((case, tag), []).append(ms)
                print(f"round {r} {case} {tag}: device {ms:.4f} ms", flush=True)
        for case, fn, ref in cases:
            ms = device_ms(ref)
            readings.setdefault((case, "SDPA"), []).append(ms)
            print(f"round {r} {case} SDPA: device {ms:.4f} ms", flush=True)
    attn.FLAGS = ()
    for (case, tag), values in readings.items():
        print(f"median {case} {tag}: device {statistics.median(values):.4f} ms "
              f"({len(values)} rounds)")

    backward_rounds(attn, dev, gen, args.rounds)

    q, k, v = (torch.randn(1, 128, 512, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    qh, kh, vh = (x.view(1, 128, heads, 64).transpose(1, 2) for x in (q, k, v))
    for name, fn in (("flash_attention_tokens", lambda: attn.flash_attention_tokens(q, k, v, heads)),
                     ("flash_attention_tokens_fwd_lse",
                      lambda: attn.flash_attention_tokens_fwd_lse(q, k, v, heads)),
                     ("SDPA", lambda: sdpa(qh, kh, vh))):
        print(f"host {name} [1,128,512]: {host_us(fn):.2f} us per call")


if __name__ == "__main__":
    main()
