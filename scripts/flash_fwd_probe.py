#!/usr/bin/env python3
"""Where the time of the flash forward kernel (csrc/flash_tokens.cu) goes,
on one CUDA card.

    python3 scripts/flash_fwd_probe.py [--rounds N]

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
  (2000 calls that the card keeps up with, on the host clock).

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
    _build.build_all([(attn.SOURCE, flags) for flags in VARIANTS])
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
