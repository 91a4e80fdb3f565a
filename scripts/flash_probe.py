#!/usr/bin/env python3
"""Where the time of the flash kernels (csrc/flash_tokens.cu,
csrc/flash_bwd.cu) goes, on one CUDA card.

    python3 scripts/flash_probe.py [--rounds N]

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

Prints the card's name and power limit first. Needs nvcc (the builds land
in smokephysai_tpu_torch/_build/ as the wrappers' do).
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from smokephysai_tpu_torch.ops import _build
    from smokephysai_tpu_torch.ops import attention as attn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
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
