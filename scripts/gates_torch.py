#!/usr/bin/env python
"""The port's remaining quality gates on the card: the 512^2 plume and the
128^3 protocol, through the port's benchmark and evaluate CLIs.

    python3 scripts/gates_torch.py --out DIR

- plume: `python -m smokephysai_tpu_torch.benchmark --config
  config/config_512_plume.yaml --checkpoint checkpoints/smokephysnet_512_best.npz
  --num_samples 100 --samples tests/goldens/gate_draws_512x512_n100_s0.npz`
  (the JAX CLI's draws; per-op vorticity steps through the Jacobi and
  diffusion kernels), with the kernel launches it made;
- 3d: `benchmark` on config/config_128cubed.yaml at 50 volumes with
  checkpoints/smokephysnet3d_128cubed.npz and at 32 with
  checkpoints/smokephysnet3d_128cubed_quality.npz (the port's own draws:
  the 3D protocol takes no recorded draws), and `evaluate --num_samples 32
  --num_physics_tests 16` on both.

Each figure is written beside the JAX package's (PARITY.md, measured on a
TPU v5e by the JAX CLIs) with the relative gap, flagged over 10 %. Writes
`<out>/gates_torch.json` (the card's name and power limit from nvidia-smi,
the evaluation reports inside) and each report's own file.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GAP_FLAG = 0.10
PLUME = {"config": "config/config_512_plume.yaml",
         "checkpoint": "checkpoints/smokephysnet_512_best.npz",
         "samples": "tests/goldens/gate_draws_512x512_n100_s0.npz", "num_samples": 100,
         # PARITY.md, "512x512 turbulent plume": the JAX CLI on a TPU v5e
         "jax": {"mse": 0.000205, "physics_correlation": 0.9967}}
VOLUMES = (
    {"name": "128cubed", "checkpoint": "checkpoints/smokephysnet3d_128cubed.npz",
     "num_samples": 50,
     # PARITY.md, the volumetric protocol and its robustness table (round 4)
     "jax": {"mse": 0.000489, "physics_correlation": 1.0000, "ssim": 0.259,
             "psnr": 33.29, "recon_mse": 0.000469}},
    {"name": "128cubed_quality", "checkpoint": "checkpoints/smokephysnet3d_128cubed_quality.npz",
     "num_samples": 32,
     # PARITY.md, the round-5 volumetric quality recipe (32 samples)
     "jax": {"mse": 0.000075, "physics_correlation": 0.9999, "ssim": 0.861,
             "psnr": 41.60, "recon_mse": 6.912423123139888e-05}},
)
VOL_CONFIG = "config/config_128cubed.yaml"
EVAL_SAMPLES, EVAL_PHYSICS_TESTS = 32, 16


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


def launches():
    from smokephysai_tpu_torch.ops import attention, cg3d, fused_step, jacobi, stencil

    return {"fused_step": fused_step.LAUNCHES, "fused_multi_step": fused_step.MULTI_LAUNCHES,
            "jacobi_pressure": jacobi.LAUNCHES, "diffuse": stencil.LAUNCHES,
            "cg_pressure": cg3d.LAUNCHES, "flash_attention_tokens": attention.LAUNCHES}


def compare(port, jax):
    """{key: {port, jax, gap, flagged}} for the keys both have."""
    out = {}
    for k, j in jax.items():
        if k in port:
            gap = (port[k] - j) / abs(j)
            out[k] = {"port": port[k], "jax": j, "gap": gap, "flagged": abs(gap) > GAP_FLAG}
    return out


def benchmark(config, checkpoint, num_samples, samples=None):
    from smokephysai_tpu_torch import benchmark as bench

    argv = ["--config", os.path.join(ROOT, config), "--checkpoint",
            os.path.join(ROOT, checkpoint), "--num_samples", str(num_samples)]
    if samples:
        argv += ["--samples", os.path.join(ROOT, samples)]
    before, t = launches(), time.time()
    result = bench.main(argv)
    after = launches()
    model = result["model"]
    return {"mse": model["mse"], "physics_correlation": model["physics_correlation"],
            "ms_per_sample": model["inference_time"] * 1e3, "baselines": result["baselines"],
            "seconds": time.time() - t,
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True, help="directory for the reports")
    out = parser.parse_args().out

    import torch

    from smokephysai_tpu_torch.evaluate import main as evaluate_main

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script runs the gates on the card")
    os.makedirs(out, exist_ok=True)
    report = {"card": smi_line(), "device": torch.cuda.get_device_name(0)}
    say(f"card: {report['card']} ({report['device']})")
    path = os.path.join(out, "gates_torch.json")

    def write():
        with open(path, "w") as f:
            json.dump(report, f, indent=1)

    r = benchmark(PLUME["config"], PLUME["checkpoint"], PLUME["num_samples"], PLUME["samples"])
    r["vs_jax"] = compare(r, PLUME["jax"])
    report["plume_512"] = r
    say(f"plume 512^2 gate: {json.dumps(r)}")
    write()
    for vol in VOLUMES:
        r = benchmark(VOL_CONFIG, vol["checkpoint"], vol["num_samples"])
        t = time.time()
        ev = evaluate_main(["--config", os.path.join(ROOT, VOL_CONFIG), "--checkpoint",
                            os.path.join(ROOT, vol["checkpoint"]), "--num_samples",
                            str(EVAL_SAMPLES), "--num_physics_tests", str(EVAL_PHYSICS_TESTS),
                            "--output", os.path.join(out, f"eval3d_{vol['name']}_torch.json")])
        rec = ev["reconstruction"]
        r["evaluate"] = {"report": ev, "seconds": time.time() - t}
        r["vs_jax"] = compare({**r, "ssim": rec["ssim"], "psnr": rec["psnr"],
                               "recon_mse": rec["mse"]}, vol["jax"])
        report[f"volumes_{vol['name']}"] = r
        say(f"3d {vol['name']}: benchmark at {vol['num_samples']} volumes "
            f"{json.dumps({k: v for k, v in r.items() if k != 'evaluate'})}; evaluate "
            f"at {EVAL_SAMPLES}/{EVAL_PHYSICS_TESTS} in {r['evaluate']['seconds']:.1f} s")
        write()
    say(f"wrote {path}")


if __name__ == "__main__":
    main()
