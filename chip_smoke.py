#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`smokephysai_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--trace]

From the root of a checkout, with one CUDA card:

1. prints the card, the device count and nvidia-smi's name and power limit;
2. builds the six CUDA sources with nvcc (in parallel) and prints the
   seconds; counts the HGMMA (wgmma), UTMALDG (TMA load) and
   HMMA.1688.F32.TF32 (mma.sync m16n8k8 TF32: the float32 kernels' split
   products) instructions in the SASS of libflash_tokens.so and
   libflash_bwd.so (cuobjdump), and the latter in the float32 dq kernel's
   functions alone, and fails if any is 0, or if ptxas
   reported serialised wgmma (C75xx) for a kernel of flash_bwd.cu; prints
   the float32 flash kernels' registers and spills and fails on a spill;
   prints the registers and spills
   of libfused_step.so's and libcg3d.so's kernels (ptxas) and counts the
   former's cluster-barrier instructions (UCGABAR_ARV, UCGABAR_WAIT),
   failing if there are none;
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card (fused solver step and multi-step at 128^2, one episode and a batch
   of four, the step also at 1024^2 (the global mode) and, at dt 1 with a
   shear that moves cells 1 to 3.6 cells a step so that the far taps carry
   weight, at max_disp 2 and 3 (the runtime tap radius) at 128^2 and 3 at
   1024^2, the multi-step again at the dataset's 64 in the timing phase,
   each with the launch plan it took; lean flash
   attention at B=4 in bf16 and float32 and at the
   serving slice's B=19; the training forward with logsumexp and the
   backward at the training shape [8, 1024, 512], bf16, and the backward
   also in float32; there, in bf16 and float32, the split backward's dq
   and dk/dv kernels against their plain versions and the fused kernel,
   each call run twice and each episode of a batch of 2 alone, all
   bit-equal, the split dk and dv also equal to the fused kernel's; the
   backward (fused and split) in bf16 and float32 at L = 192 with head
   dims 16 and 128, B = 3; the head-major `flash_attention` driven once at
   [8, 8, 1024, 64] bf16 with its launch count, and held against its plain
   version there in bf16 and float32 and at the JAX tests' shapes; the
   lean forward and the forward with logsumexp in bf16 at L = 192 (head
   dims 64, 16, 128) and L = 1024 (16, 128), B >= 3, each lean output the
   same bits as the LSE one and as a second call); the three float32
   kernels and the split pair at [8, 1024, 512] (the float32 train step's
   shape), each forward run twice (bit-equal) and the lean output equal to
   the LSE forward's;
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
   the same step under SMOKEPHYS_FUSED_BWD=0 (6 forward-with-lse, 6 dq and
   6 dk/dv launches, no fused one), both routes held against the plain
   backward and against the plain backward with the kernels' exponent, at
   bounds derived from the gap between those two plain backwards (ROADMAP
   C.6; printed with the readings), and a negative control: the kernels'
   step with the 64-query tile of one head of dq of the largest norm
   zeroed must exceed them; the
   train step on both routes timed in turns, recipe D's phase-1 step
   (config_twophase_bf16.yaml with fast_math=false) timed 5 + 5 in turns
   with the fast_math step, one eval pass, a checkpoint
   written and served again through `train/serving.load_model`; then the
   float32 flash train step of `config/config_polish_f32.yaml` (float32,
   use_flash, batch 8, full width): one step on each backward route (6 + 6
   launches) held against the same step with use_flash off (loss and
   gradient norm), and the flash and einsum steps timed in turns with their
   peak memory;
7. timing phase: CUDA-event medians after warm-up (the backward kernels
   and SDPA's backward in turns, the median of three rounds; the fused
   solver kernels at 128^2 x 1 and x 64, 1024^2 x 1 and 64 x 20 steps also
   with their launch plan, and at 128^2 the kernel's device time; the
   float32 flash kernels at [8, 1024, 512] beside their plain versions,
   their bounds at 165 TFLOP/s and SDPA's float32 calls, and the float32
   lean forward at the PGD report's [50, 1024, 512], checked against its
   plain version and timed the same way);
   with --trace, also
   traces the serving forward, the simulator step and one train step with
   torch.profiler and prints where their device time goes;
8. vorticity phase: `config/config_256_vorticity.yaml`, where vorticity
   confinement sends every solver step per op through the Jacobi and
   diffusion kernels. Both kernels against their plain versions, max|d| 0:
   Jacobi at 256^2 with 1 and 8 episodes, at 37x53 with 0 and 1 sweeps, at
   512^2, 1024^2 and 2048^2, at 101x67 with 45 sweeps and at 2 x 1100x900
   with 45, each call's launch plan printed (the cluster mode up to 512^2,
   bands of rows with halo rows beyond), the band mode also forced at 256^2
   and at 101x67 x 45 (two passes), and the smallest cluster plan forced at
   8 x 256^2; diffusion on each of the three staggered
   256^2 fields with 1 and 8 episodes, and `diffuse_fields` on all three
   in one launch at 1 and 8; the slice as `inference.run` drives it (test
   sequence, one batched forward) on `checkpoints/smokephysnet_256_vort_best.npz`
   at full width (20 Jacobi and 20 diffusion launches, one each a step,
   none of the other kernels), its sequence against the plain per-op
   solver (bit-equal) and its bf16 forward against the float32 model; 8
   episodes of `config_256_finetune.yaml`'s generation (20 + 20 launches,
   all 8 bit-equal to the plain loop); 5 per-op steps at
   config_streaming_1024.yaml's 1024^2 grid with vorticity_eps 2.0 (5
   Jacobi launches in the band mode, 5 diffusion launches, none of the
   other kernels; every state bit-equal to the plain per-op solver; the
   step timed); then the plume phase: one 8-episode chunk of
   config_512_plume.yaml's physics at 512^2 (vorticity_eps 2.0, T = 20)
   through `simulate_episode`, one Jacobi launch (the cluster mode, strips
   of 4 rows) and one diffusion launch a step, all episodes and labels
   bit-equal to the plain per-op loop, the step timed at 1 and 8 episodes
   and both kernels at the chunk's shapes; timings of both kernels (CUDA
   events through the wrapper and the kernel's device time alone by
   torch.profiler: Jacobi at [1,256^2], [8,256^2], [1,512^2], [1,1024^2],
   [1,2048^2],
   the three-field diffusion at 1 and 8 episodes), the step at 1 and 8
   episodes, the chunk and the forward at B=19 and 8 (with --trace, the
   step's device time by kernel);
9. volumetric phase: `config/config_128cubed.yaml` at full width. The CG
   pressure kernel (one launch a solve) against its plain version (128^3
   x 30 iterations from a zero and a warm p0, 2 x 128^3 (two waves of
   episodes), 160^3 (the global mode), [2,64,64,64], each episode of a
   batch equal to its solo solve, 37x53x29 with 30, 0 and 1 iterations,
   zero divergence; every solve run twice, bit-equal; each call's launch
   plan printed; the global mode forced on every warm on-chip solve of 30
   iterations, batches included, bit-equal to its on-chip plan); two 128^3
   episodes (T = 12) generated
   through `data.synthetic3d.SyntheticSmokeDataset3D` (one CG solve per
   step, no other kernel) and held frame by frame against the plain CG;
   `checkpoints/smokephysnet3d_128cubed.npz` served on frame 6 -> 7 through
   `load_model` and `make_predictor` (no kernel: float32 einsum) against
   the same model in float64; the three flash kernels at head_dim 32
   ([1,512,256] float32 and bf16, [8,512,256] bf16; with them the split
   backward pair), the model with
   `tpu.use_flash` (4 lean launches) and its input gradient (4 + 4
   launches of the training pair) against einsum; timings of the CG, the
   3D step, one episode, the forward and the head_dim-32 kernels in bf16 at
   B = 1 and 8 and in float32 at B = 1, the type the 3D model's paths
   launch (the backward's and the split pair's in turns with SDPA's
   backward; the CG kernel's device time too), and the 3D step's device
   time by kernel (torch.profiler); then the mg phase: on a warm-started
   128^3 system the residual of `pressure_solver="mg"`'s 2 V-cycles
   against the CG kernel's 30 iterations (fails over 1.05 times it), the
   V-cycles on the card against the CPU, and the mg step (no kernel
   launch) timed in turns with the CG-kernel step;
10. gate phase: the quality path through the port's `benchmark` and
   `evaluate` entry points at full width: the 50-sample gate of
   `config/config.yaml` (float32 einsum) on `smokephysnet_128_best.npz` with
   the JAX CLI's recorded draws (`tests/goldens/gate_draws_128x128_n50_s0.npz`:
   sources, frames and chaos fields; one multi-step launch for the 50
   episodes), failing over MSE 0.0022, the same episodes under the port's
   own chaos stream and the CLI's default (all of the port's own draws);
   the 256^2 vorticity gate of `config_256_vorticity.yaml` on
   `smokephysnet_256_vort_best.npz` (20 Jacobi and 20 diffusion launches),
   failing over 0.0022 and flagging a gap over 10 % to PARITY.md's
   0.000650; the five-section evaluation report of `config/config.yaml` at
   50 samples and 50 scenarios with the seconds and launches of each
   section, failing on a NaN or an infinity; its PGD section again under
   `tpu.use_flash` at 50 samples, as the einsum one (float32 flash kernels:
   12 lean, 60 forward-with-logsumexp and 60 backward launches); and the volumetric branches
   at 2 volumes of 128^3 (the benchmark's model row and baselines, the
   report's physics_consistency and reconstruction; 24 CG launches each);
   then the bridge phase: the reference PyTorch model's state_dict drawn
   from tests/goldens/model_forward_128.npz's recorded keys and seed,
   converted by `models/torch_port` and served at full width in float32
   (TF32 off) against the reference's recorded forward (1e-4, token
   features 1e-3), its export bit-equal to the state;
   after the training phase, also the float32 einsum train step of
   `config/config_twophase_f32.yaml` (batch 8, full width): the median of 5
   steps after 2, with TF32 off and with cuDNN's TF32 on, and the peak memory;
11. streaming phase: `config/config_streaming_1024.yaml` on
   `checkpoints/smokephysnet_128_best.npz`, uncut (1024^2, batch 1, 30
   frames) through `train/streaming.streaming_rollout`, in three variants:
   the config (bf16 einsum), plus use_flash and fast_math, plus
   fast_encoder. Each: 30 fused-step launches (the global mode), no Jacobi
   or diffusion launch, 0 or 180 lean flash launches; the frames against a
   loop of the plain step (bound FUSED_ATOL, bit-equality printed), the
   physics features and one frame's reconstruction against the float32
   einsum model on those frames (2e-2), and the mean token each frame's
   physics head takes, read in the rollout (2e-2 of its largest |x|);
   frames per second (median of three rollouts) and the busy share of one
   traced frame of the rollout's step. Then the lean kernel
   at [1, 1024, 512] against its plain version and SDPA, and the stream CLI
   once (its three files checked);
12. volumetric training phase: `python -m smokephysai_tpu_torch.train
   --config config/config_128cubed.yaml` at full width cut to one epoch
   (32 + 8 episodes generated with the CG kernel, 480 launches; 32 steps;
   the validation pass) in a scratch directory, its last checkpoint served
   back through `load_model`; the config's train step (float32 einsum,
   batch 1) timed with its peak memory; one step with `tpu.use_flash` held
   against the einsum step (loss and gradient norm) on the fused route (4
   forward-with-logsumexp and 4 backward launches) and the split route (4
   dq and 4 dk/dv launches);
13. prints the kernels' JSON line (later slices' paths as entries of their
   own: the fused step and the lean kernel on the stream, the CG kernel and
   the head_dim-32 training kernels in volumetric training, the float32
   kernels at [8, 1024, 512] on the config_polish_f32 step and the float32
   lean kernel at [50, 1024, 512] in the PGD report), the SASS
   counts, the nvidia-smi line and, last, {"ok": true, "device": {...}}.

Any failure exits non-zero without that last line: there is no CPU
fallback. Needs no network and no file outside the checkout.
"""
import contextlib
import importlib
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
VORT_CONFIG = os.path.join(ROOT, "config", "config_256_vorticity.yaml")
FINETUNE_CONFIG = os.path.join(ROOT, "config", "config_256_finetune.yaml")
VORT_CHECKPOINT = os.path.join(ROOT, "checkpoints", "smokephysnet_256_vort_best.npz")
VOL_CONFIG = os.path.join(ROOT, "config", "config_128cubed.yaml")
VOL_CHECKPOINT = os.path.join(ROOT, "checkpoints", "smokephysnet3d_128cubed.npz")

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, bf16 tensor
# core FLOP/s, float32 FLOP/s outside the tensor cores (the solvers' bound)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# the float32 flash kernels' bound: float32-accurate products as three TF32
# products each (split TF32) at the 495 TFLOP/s of the TF32 tensor cores
F32_FLASH_FLOPS = 495e12 / 3
# the SASS of the split-TF32 product (mma.sync m16n8k8 TF32) on sm_90a
TF32_MMA = "HMMA.1688.F32.TF32"

# bounds of the kernel-vs-plain and slice checks
FUSED_ATOL = 1e-5      # the kernel rounds as the plain version (-fmad=false)
# bf16 flash: the largest |d| within two bf16 ulps of the largest output
# (|o| < 0.5 at these shapes, whose ulp is 2^-9), and ||d|| / ||ref|| within
# 2^-8. The kernel rounds P to bf16 against a running max per 128-key tile,
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
# backward differs. The last layer's read the kernel's dq, dk, dv directly;
# each layer below adds the bf16 roundings that this flips in its own
# backward. Both sides round P and dS to bf16, from float32 values formed
# by two formulas: the kernels' P = exp2(S scale log2(e) - lse log2(e)),
# the plain version's exp(S scale - lse). So an element of P or dS now and
# then lands one bf16 ulp apart, more often as training sharpens the
# softmax: on one state the last layer read 1.13e-3 (PERF.md §7). The bound
# is derived on the state the check holds. A fifth run, the plain backward
# with the kernels' exponent (KERNEL_EXP_RUN), differs from the plain
# backward by those flips alone: n, its ||d||/||ref|| (largest over the last
# layer's q, k, v, and over all layers), is this state's own rounding-flip
# noise. The kernels differ from either plain backward by flips of their
# own (S summed in another order, ex2.approx: a draw of the same size) and
# by the order of the products' sums (~1e-4), so they are held at 2 n, and
# never below the fixed floors (the last layer 2^-10, all layers 2^-8,
# where the check stood before the noise was measured). A fault in dq of
# the size the floor was set for, one 64-query tile of one head zeroed (the
# tile of the largest norm: one of the frame's empty rows carries too little
# of the gradient to matter), must exceed the derived bound on every run:
# the negative control.
TRAIN_BWD_TOP_PROJ_GRAD_REL_NORM = 2.0 ** -10
TRAIN_BWD_PROJ_GRAD_REL_NORM = 2.0 ** -8
KERNEL_EXP_RUN = "plain backward, kernel's exponent"
# the float32 flash step (config_polish_f32) against the same step with
# einsum, q, k, v projection gradients ||d|| / ||ref||: both sides float32
# (the kernels within 1e-5 of the plain versions, ~1e-6 read), carried
# through six layers. At random weights the loss is ~3.5e6 (the physics
# terms), so the loss and the norm only show what moves them by an ulp
TRAIN_F32_PROJ_GRAD_REL_NORM = 1e-4
TRAIN_NUM = 64  # cuts of config_train_fast.yaml: episodes and steps
VAL_NUM = 8
TRAIN_STEPS = 10
ROUTE_STEPS = 5  # train steps timed on each backward route, in turns
GEN_EPISODES = 8  # config_256_finetune.yaml's batch, generated at 256^2
BIG_VORT_STEPS = 5  # per-op steps at config_streaming_1024.yaml's grid, vorticity on
# the volumetric phase
VOL_EPISODES = 2  # config_128cubed.yaml's 32 + 8 episodes cut to 2
# CG kernel vs its plain version, ||d|| / ||ref||: float32 sums of ~2M
# terms in other orders (2e-7 read on an H100 at 128^3 x 30 iterations)
CG_REL_NORM = 1e-5
# generated 128^3 episodes, kernel vs plain CG: each solve differs by
# ~1e-7 of |p|, and dt * grad p carries that into the velocities and the
# density (O(1)); 12 steps stay far inside 1e-5
VOL_EPISODE_ATOL = 1e-5
# chaos labels of those episodes: a cell that crosses the frame's mean or a
# histogram bin edge moves a box count or a bin by one
VOL_LABEL_ATOL = 1e-3
VOL_RECON_F64 = 1e-4  # the float32 serving forward vs the same model in float64
VOL_FLASH_RECON = 1e-4  # use_flash (head_dim 32, float32 kernel) vs einsum
# input gradient of the forward, flash (forward-with-lse and backward
# kernels, float32) vs einsum: ||d|| / ||ref||
VOL_FLASH_GRAD_REL_NORM = 1e-4
PARITY_VOL_MSE = 0.000489  # PARITY.md: the JAX model on JAX's held-out draws
RECIPE_D_CONFIG = os.path.join(ROOT, "config", "config_twophase_bf16.yaml")
PLUME_CONFIG = os.path.join(ROOT, "config", "config_512_plume.yaml")
PLUME_EPISODES = 8  # one chunk of config_512_plume.yaml's physics
MG_WARM_STEPS = 10  # CG-kernel steps that build the warm-started 128^3 system
MG_CG_RATIO = 1.05  # tests/test_solver3d.py: 2 V-cycles reach CG-30's residual
# mg on the card vs mg on the CPU, max|d| / max|p|: the same float32
# operations; the block means' sums may be taken in another order
MG_CPU_REL = 1e-5
# the bridged reference model in float32 on the card (TF32 off) vs the
# reference's recorded forward: tests/test_torch_port.py's bounds
BRIDGE_ATOL = 1e-4
BRIDGE_FEATURE_ATOL = 1e-3
BRIDGE_GOLDEN = os.path.join(ROOT, "tests", "goldens", "model_forward_128.npz")

# the gate phase: the benchmark and evaluate entry points at full width
GATE_CONFIG = os.path.join(ROOT, "config", "config.yaml")  # float32 einsum
GATE_DRAWS = os.path.join(ROOT, "tests", "goldens", "gate_draws_128x128_n50_s0.npz")
VORT_GATE_DRAWS = os.path.join(ROOT, "tests", "goldens", "gate_draws_256x256_n50_s0.npz")
GATE_SAMPLES = 50
GATE_MSE = 0.0022  # PARITY.md: the repo's 50-sample quality gate
PARITY_GATE_MSE = 0.002160  # PARITY.md: smokephysnet_128_best.npz, JAX CLI on a TPU
PARITY_VORT_MSE, PARITY_VORT_CORR = 0.000650, 0.9963  # PARITY.md, 256^2 vorticity
VORT_GAP = 0.10  # a larger gap to PARITY's 256^2 figure is written up in PERF.md
EVAL_PHYSICS_TESTS = 50
GATE_VOLUMES = 2  # the volumetric branches at 2 volumes of 128^3
# PGD under use_flash: one batch of GATE_SAMPLES, as the einsum PGD
FLASH_PGD_SAMPLES = GATE_SAMPLES

# the streaming phase: config_streaming_1024.yaml uncut (1024^2, batch 1)
STREAM_CONFIG = os.path.join(ROOT, "config", "config_streaming_1024.yaml")
STREAM_FRAMES = 30  # bench.py's streaming measurement: 30 frames
STREAM_RUNS = 3  # timed rollouts per variant after a first one
# the volumetric training phase: config_128cubed.yaml at full width, one epoch
VOL_TRAIN_EPISODES = 32 + 8  # the config's train + validation episodes, uncut
TIMED_STEPS = 5  # train steps timed after WARM_STEPS (the f32 and 3D steps)
WARM_STEPS = 2
F32_CONFIG = os.path.join(ROOT, "config", "config_twophase_f32.yaml")
# the float32 flash train step: float32, use_flash, batch 8, full width
POLISH_CONFIG = os.path.join(ROOT, "config", "config_polish_f32.yaml")

TRACE_RUNS = 5  # traced serving forwards in --trace
BIG_GRID = 1024  # config_streaming_1024.yaml's grid: the fused step's global mode
# the fused step's far-tap checks: at dt FAST_DT a shear of amplitude SHEAR
# moves most cells 1 to 3.6 cells a step, so the taps at 2 and 3 cells carry
# weight (FAR_TAPS_DIFF: the plain step one radius lower differs by more)
FAST_DT = 1.0
SHEAR = 3.0
FAR_TAPS_DIFF = 0.5

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


def in_turns(fns, rounds=3):
    """{name: the median over `rounds` rounds of `timed(fn)`}, the calls of
    `fns` ({name: fn}) taken in turns within each round."""
    readings = {}
    for _ in range(rounds):
        for fname, fn in fns.items():
            readings.setdefault(fname, []).append(timed(fn))
    return {fname: statistics.median(v) for fname, v in readings.items()}


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


def smoke_state(dev, episodes, size, seed=0, shear=0.0):
    """`episodes` states at size^2: three smoke blobs and random velocities
    of ~0.5 cells per unit time, plus, with `shear`, a divergence-free shear
    of that amplitude (u a function of the column, v of the row; at dt
    FAST_DT and SHEAR it moves most cells 1 to 3.6 cells a step), made on
    the host from a seed."""
    import torch

    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(size, dtype=torch.float32),
                            torch.arange(size, dtype=torch.float32), indexing="ij")
    d = torch.zeros(episodes, size, size)
    for _ in range(3):
        cy, cx = (torch.rand(2, generator=g) * 0.6 + 0.2) * size
        d += torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (0.004 * size * size))
    u = 0.5 * torch.randn(episodes, size + 1, size, generator=g)
    v = 0.5 * torch.randn(episodes, size, size + 1, generator=g)
    if shear:
        phase = torch.rand(2, episodes, 1, 1, generator=g) * 2 * math.pi
        u = u + shear * torch.sin(2 * math.pi * xx[0] / 37 + phase[0])
        v = v + shear * torch.cos(2 * math.pi * yy[:, :1] / 29 + phase[1])
    return [t.to(dev).contiguous() for t in (u, v, torch.zeros_like(d), d)]


def step_bytes(h, w):
    """Bytes of one episode's four fields, once."""
    return 4 * ((h + 1) * w + h * (w + 1) + 2 * h * w)


PROFILE_TRIES = 3  # traces with no device time taken before the script fails


def profile(fn, runs, label, top=15):
    """Traces `runs` calls of fn and prints the device time per call of the
    kernels that take the most, by kernel and by the PyTorch op that
    launched them, and the device's busy share of the traced window, which
    it returns. A trace in which the profiler recorded no device time
    (CUPTI drops a trace now and then) is taken again, up to PROFILE_TRIES
    traces in all; then the script fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for attempt in range(1, PROFILE_TRIES + 1):
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
        if busy_ms > 0.0:
            break
        say(f"trace {label}: trace {attempt} of {PROFILE_TRIES} recorded no device time")
    else:
        fail(f"trace {label}: the profiler recorded no device time in {PROFILE_TRIES} traces")
    say(f"trace {label}: {window_ms / runs:.3f} ms per call (CUDA events), "
        f"device kernel time {busy_ms / runs:.3f} ms per call, busy share "
        f"{busy_ms / window_ms:.3f}, {n_events // runs} device events per call")
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
    return busy_ms / window_ms


COUNTERS = {  # kernel: (module under smokephysai_tpu_torch.ops, its counter)
    "fused_step": ("fused_step", "LAUNCHES"),
    "fused_multi_step": ("fused_step", "MULTI_LAUNCHES"),
    "flash_attention_tokens": ("attention", "LAUNCHES"),
    "flash_attention_tokens_fwd_lse": ("attention", "LSE_LAUNCHES"),
    "flash_attention_tokens_bwd": ("attention", "BWD_LAUNCHES"),
    "flash_attention_tokens_bwd_dq": ("attention", "BWD_DQ_LAUNCHES"),
    "flash_attention_tokens_bwd_dkv": ("attention", "BWD_DKV_LAUNCHES"),
    "flash_attention": ("attention", "HM_LAUNCHES"),
    "jacobi_pressure": ("jacobi", "LAUNCHES"),
    "diffuse": ("stencil", "LAUNCHES"),
    "cg_pressure": ("cg3d", "LAUNCHES"),
}


def _ops(module):
    return importlib.import_module(f"smokephysai_tpu_torch.ops.{module}")


def reset_counts():
    """Sets every kernel's launch count to 0."""
    for mod, attr in COUNTERS.values():
        setattr(_ops(mod), attr, 0)


def read_counts():
    return {name: getattr(_ops(mod), attr) for name, (mod, attr) in COUNTERS.items()}


def expect_counts(phase, counts, **want):
    """Fails unless each kernel launched exactly as often as `want` says
    (kernels not named: never)."""
    for name in COUNTERS:
        if counts[name] != want.get(name, 0):
            fail(f"{phase}: expected {want.get(name, 0)} {name} launches, "
                 f"saw {counts[name]}")


@contextlib.contextmanager
def split_backward():
    """SMOKEPHYS_FUSED_BWD=0 (the split dq and dk/dv kernels) inside a
    `with` block; what was set before is restored after."""
    saved = os.environ.get("SMOKEPHYS_FUSED_BWD")
    os.environ["SMOKEPHYS_FUSED_BWD"] = "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["SMOKEPHYS_FUSED_BWD"]
        else:
            os.environ["SMOKEPHYS_FUSED_BWD"] = saved


def split_check(attn_ops, args, heads, tag, bound, fused):
    """The split dq and dk/dv kernels, through `flash_attention_tokens_bwd`
    under SMOKEPHYS_FUSED_BWD=0, on `args` (q, k, v, out, lse, dout)
    against their plain versions (||d||/||ref|| within `bound` for each of
    dq, dk, dv) and against the fused kernel's gradients `fused` (the gap
    printed); each call run twice, and with a batch of 2 or more each
    episode of the first two alone: all bit-equal. Returns the largest |d|
    from the plain versions of each kernel."""
    import torch

    def pair(a):
        with split_backward():
            return attn_ops.flash_attention_tokens_bwd(*a, heads)

    got, again = pair(args), pair(args)
    refs = (attn_ops.flash_attention_tokens_bwd_dq_reference(*args, heads),
            *attn_ops.flash_attention_tokens_bwd_dkv_reference(*args, heads))
    solo_ok = True
    if args[0].shape[0] >= 2:
        two = [t[:2].contiguous() for t in args]
        batched = pair(two)
        for e in range(2):
            solo = pair([t[e:e + 1].contiguous() for t in two])
            solo_ok &= all(torch.equal(b[e:e + 1], s_) for b, s_ in zip(batched, solo))
    torch.cuda.synchronize()
    rels = [rel_norm(a, b) for a, b in zip(got, refs)]
    gaps = [rel_norm(a, b) for a, b in zip(got, fused)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    # the dk/dv kernel is the fused kernel's code without its dQ step
    dkv_fused = torch.equal(got[1], fused[1]) and torch.equal(got[2], fused[2])
    say(f"kernel flash_attention_tokens_bwd_dq / _dkv (split) {tag}: ||d||/||ref|| dq "
        f"{rels[0]:.3e} dk {rels[1]:.3e} dv {rels[2]:.3e} (bound {bound:.3e}); vs the "
        f"fused kernel dq {gaps[0]:.3e} dk {gaps[1]:.3e} dv {gaps[2]:.3e}, dk and dv "
        f"bit-equal {dkv_fused}; two runs bit-equal {same}; episodes of a batch of 2 = "
        f"their calls alone {solo_ok if args[0].shape[0] >= 2 else 'n/a (batch 1)'}")
    if not (max(rels) <= bound and same and solo_ok and dkv_fused):
        fail(f"the split backward kernels disagree with their plain versions or "
             f"themselves at {tag}")
    return {"flash_attention_tokens_bwd_dq": maxerr(got[0], refs[0]),
            "flash_attention_tokens_bwd_dkv": max(maxerr(got[1], refs[1]),
                                                  maxerr(got[2], refs[2]))}


def head_major_check(attn_ops, dev, gen, batch, heads, hd):
    """`flash_attention` on head-major [B, H, L, D]: driven once at the
    model's attention in that layout ([batch, heads, 1024, hd] bf16) with
    launch counts, then held against `flash_attention_reference` there in
    bf16 and float32 and at tests/test_pallas.py's two shapes, with the
    lean kernel's bounds. Returns (the driven call's counts, the largest
    bf16 |d|)."""
    import torch

    cases = (((batch, heads, 1024, hd), 1.0), ((2, 4, 256, 64), 1.0),
             ((1, 2, 128, 32), 1.5))
    counts, bf16_err = None, 0.0
    for shape, temperature in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(*shape, generator=gen).to(dev, dtype) for _ in range(3))
            reset_counts()
            out = attn_ops.flash_attention(q, k, v, temperature)
            torch.cuda.synchronize()
            counts = counts or read_counts()  # the first call's
            ref = attn_ops.flash_attention_reference(q, k, v, temperature)
            err, rel = maxerr(out, ref), rel_norm(out, ref)
            if dtype == torch.bfloat16:
                bound = FLASH_BF16_ULPS * bf16_ulp(float(ref.float().abs().max()))
                ok = err <= bound and rel <= FLASH_BF16_REL_NORM
                bf16_err = max(bf16_err, err)
            else:
                bound = FLASH_F32_ATOL
                ok = err <= bound
            say(f"kernel flash_attention {list(shape)} {str(dtype)[6:]} temperature "
                f"{temperature}: max|d| {err:.3e} (bound {bound:.3e}), ||d||/||ref|| "
                f"{rel:.3e}{f' (bound {FLASH_BF16_REL_NORM:.3e})' if dtype == torch.bfloat16 else ''}")
            if not ok:
                fail(f"flash_attention disagrees with its plain version at {list(shape)}")
    say(f"head-major flash_attention {list(cases[0][0])} bf16, one call: launches {counts}")
    expect_counts("head-major flash_attention", counts, flash_attention=1)
    return counts, bf16_err


# (batch, L, head_dim) of the forward's tail and head-dim checks, width 512
# (256 at head_dim 16): L = 192 is an odd count of 64-row tiles (the bf16
# kernel's last 128-query tile half out of range, its last 128-key tile
# half masked); B >= 3 shows a read past a batch element's end
FWD_EXTRA_CASES = ((3, 192, 64), (3, 192, 16), (3, 192, 128), (4, 1024, 16),
                   (4, 1024, 128))


def forward_extra_checks(attn_ops, dev, gen):
    """The lean forward and the forward with logsumexp, bf16, at
    `FWD_EXTRA_CASES` against their plain versions with the bounds of the
    model's shape (out two bf16 ulps of the largest value and ||d||/||ref||
    2^-8, lse `LSE_ATOL`); the lean output equal to the LSE instantiation's
    to the bit, and to a second call's. Returns (largest lean |d|, largest
    LSE-forward |d|)."""
    import torch

    lean_err = lse_out_err = 0.0
    for batch, length, hd in FWD_EXTRA_CASES:
        width = 256 if hd == 16 else 512
        heads = width // hd
        q, k, v = (torch.randn(batch, length, width, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(3))
        o = attn_ops.flash_attention_tokens(q, k, v, heads)
        ol, lse = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)
        again = attn_ops.flash_attention_tokens(q, k, v, heads)
        ro, rlse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads)
        torch.cuda.synchronize()
        bound = FLASH_BF16_ULPS * bf16_ulp(float(ro.float().abs().max()))
        errs = (maxerr(o, ro), maxerr(ol, ro))
        rels = (rel_norm(o, ro), rel_norm(ol, ro))
        lse_err = maxerr(lse, rlse)
        same = torch.equal(o, ol) and torch.equal(o, again)
        lean_err, lse_out_err = max(lean_err, errs[0]), max(lse_out_err, errs[1])
        say(f"kernel flash_attention_tokens (+ _fwd_lse) B={batch} L={length} D={width} "
            f"H={heads} (head_dim {hd}) bf16: max|d| {errs[0]:.3e} / {errs[1]:.3e} (bound "
            f"{bound:.3e}), ||d||/||ref|| {rels[0]:.3e} / {rels[1]:.3e} (bound "
            f"{FLASH_BF16_REL_NORM:.3e}), lse max|d| {lse_err:.3e} (bound {LSE_ATOL:g}); "
            f"lean = LSE output and = a second call, bit for bit: {same}")
        if not (max(errs) <= bound and max(rels) <= FLASH_BF16_REL_NORM
                and lse_err <= LSE_ATOL and same):
            fail(f"the flash forward disagrees with its plain version at B={batch} "
                 f"L={length} head_dim {hd}")
    return lean_err, lse_out_err


# (batch, L, head_dim) of the backward's tail checks: L = 192, where the
# bf16 kernels' last 128-row tile (keys of the fused and dk/dv kernel,
# queries of the dq kernel) lies half past L; B = 3
BWD_EXTRA_CASES = ((3, 192, 16), (3, 192, 128))


def backward_extra_checks(attn_ops, dev, gen):
    """The fused backward and the split pair in bf16 and float32 at
    `BWD_EXTRA_CASES` (width 256 at head_dim 16, else 512) against their
    plain versions with the model shape's bounds, the split pair also run
    twice, batched against solo and its dk, dv against the fused kernel's,
    all bit-equal. Returns the largest bf16 |d| of each kernel."""
    import torch

    errs = {}
    for batch, length, hd in BWD_EXTRA_CASES:
        width = 256 if hd == 16 else 512
        heads = width // hd
        base = [torch.randn(batch, length, width, generator=gen) for _ in range(4)]
        for dtype, bound in ((torch.bfloat16, BWD_BF16_REL_NORM),
                             (torch.float32, BWD_F32_REL_NORM)):
            q, k, v, g = (t.to(dev, dtype) for t in base)
            o, lse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads)
            kg = attn_ops.flash_attention_tokens_bwd(q, k, v, o, lse, g, heads)
            pg = attn_ops.flash_attention_tokens_bwd_reference(q, k, v, o, lse, g, heads)
            torch.cuda.synchronize()
            rels = [rel_norm(a, b) for a, b in zip(kg, pg)]
            tag = f"B={batch} L={length} D={width} H={heads} (head_dim {hd}) {str(dtype)[6:]}"
            say(f"kernel flash_attention_tokens_bwd {tag}: ||d||/||ref|| dq {rels[0]:.3e} "
                f"dk {rels[1]:.3e} dv {rels[2]:.3e} (bound {bound:.3e})")
            if not max(rels) <= bound:
                fail(f"flash_attention_tokens_bwd disagrees with its plain version at {tag}")
            split = split_check(attn_ops, (q, k, v, o, lse, g), heads, tag, bound, kg)
            if dtype == torch.bfloat16:
                split["flash_attention_tokens_bwd"] = max(maxerr(a, b) for a, b in zip(kg, pg))
                for kname, err in split.items():
                    errs[kname] = max(errs.get(kname, 0.0), err)
    return errs


def sass_counts(library, mnemonics=("HGMMA", "UTMALDG"), function=None):
    """Counts of each of `mnemonics` in the SASS of a built library, from
    the toolkit's cuobjdump, in all its functions or, with `function`, in
    those whose (mangled) name holds it; None where the toolkit has none."""
    from smokephysai_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {library} failed: {out.stderr.strip()[:500]}")
    text = out.stdout
    if function is not None:  # each function's SASS follows its "Function : name" line
        text = "".join(part for part in text.split("Function : ")[1:]
                       if function in part.split("\n", 1)[0])
    return tuple(text.count(m) for m in mnemonics)


def f32_kernel_resources(log):
    """(kernel<template arguments>, registers and spills) of each float32
    flash kernel in a source's ptxas -v log."""
    import re

    out, name, spills = [], None, None
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            k = re.search(r"\d(flash_\w*?f32_kernel)ILi(\d+)E(?:Lb(\d)E)?", m.group(1))
            lse = "" if k is None or k.group(3) is None else ", " + k.group(3)
            name = k and f"{k.group(1)}<{k.group(2)}{lse}>"
        elif name and "spill" in line:  # ptxas prints the spills, then the registers
            spills = line.split(":", 1)[-1].strip()
        elif name and "Used" in line and "registers" in line:
            out.append((name, f"{line.split('Used')[1].split(',')[0].strip()}; {spills}"))
            name = None
    return out


def device_ms(fn, calls=20):
    """Mean device time per call of the kernels `fn` launches (torch.profiler);
    as in `profile`, a trace with no device time is taken again, up to
    PROFILE_TRIES traces, before the script fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / calls / 1e3
        say(f"device time: trace {attempt} of {PROFILE_TRIES} recorded no device time")
    fail(f"the profiler recorded no device time in {PROFILE_TRIES} traces")


def flash_rate(flops, ms, bound_ms):
    """'N TFLOP/s, x % of bound' of a timed attention call."""
    return f"{flops / ms / 1e9:.0f} TFLOP/s, {100 * bound_ms / ms:.1f} % of bound"


class SwapFlash:
    """Swaps the model's flash attention for an autograd Function over
    `fwd_lse` (q, k, v, heads, temperature) -> (out, lse) and `bwd` (q, k,
    v, out, lse, dout, heads, temperature) -> (dq, dk, dv), inside a `with`
    block (for holding one train step against the kernels')."""

    def __init__(self, chaos_attention_module, fwd_lse, bwd):
        import torch

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, heads, temperature):
                out, lse = fwd_lse(q, k, v, heads, temperature)
                ctx.save_for_backward(q, k, v, out, lse)
                ctx.heads, ctx.temperature = heads, temperature
                return out

            @staticmethod
            def backward(ctx, dout):
                grads = bwd(*ctx.saved_tensors, dout.contiguous(), ctx.heads,
                            ctx.temperature)
                return (*grads, None, None)

        self.fn = lambda q, k, v, heads, temperature=1.0: Fn.apply(q, k, v, heads, temperature)
        self.module = chaos_attention_module

    def __enter__(self):
        self.saved = self.module.flash_attention_tokens_trainable
        self.module.flash_attention_tokens_trainable = self.fn

    def __exit__(self, *exc):
        self.module.flash_attention_tokens_trainable = self.saved


class PlainFlash(SwapFlash):
    """The plain version of the backward and, with `forward`, of the
    forward-with-logsumexp (else its kernel); with `kernel_exp`, the plain
    backward forms P by the kernels' formula, exp2(S scale log2(e) - lse
    log2(e)), instead of exp(S scale - lse)."""

    def __init__(self, attn_ops, chaos_attention_module, forward=True, kernel_exp=False):
        fwd_lse = (attn_ops.flash_attention_tokens_fwd_lse_reference if forward
                   else attn_ops.flash_attention_tokens_fwd_lse)

        def bwd(*args):
            return attn_ops._bwd_plain(*args, True, True, kernel_exp=kernel_exp)

        super().__init__(chaos_attention_module, fwd_lse, bwd)


def dataset_phase(dev):
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
    reset_counts()
    t = time.time()
    train_ds, val_ds = create_data_loaders(
        batch_size=config["training"]["batch_size"], num_train=TRAIN_NUM,
        num_val=VAL_NUM, grid_size=grid, cache_dir=None, sequence_length=T,
        seed=tpu["seed"], use_pallas=tpu["use_pallas"],
        vorticity_eps=tpu["vorticity_eps"], device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
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


def training_phase(config, train_ds, val_ds, dev):
    """10 train steps of the full-width fast recipe with launch counts, one
    step held against the plain attention, one eval pass, a checkpoint
    served again."""
    import copy
    import tempfile

    import torch

    from smokephysai_tpu_torch.models import chaos_attention as ca_mod
    from smokephysai_tpu_torch.ops import attention as attn_ops
    from smokephysai_tpu_torch.train import loop
    from smokephysai_tpu_torch.train.checkpoint import save_checkpoint
    from smokephysai_tpu_torch.train.serving import load_model, make_predictor
    from smokephysai_tpu_torch.utils.config import apply_overrides, load_config

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
        reset_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        metrics = trainer.train_step(batch)
        b.record()
        b.synchronize()
        counts = read_counts()
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

    reset_counts()
    val_loss = loop.evaluate(trainer, val_ds, bs, data_gen)
    torch.cuda.synchronize()
    eval_counts = read_counts()
    n_val_batches = -(-len(val_ds) // bs)
    say(f"train: eval pass over {len(val_ds)} episodes: loss {val_loss:.4f}; "
        f"launches {eval_counts}")
    expect_counts("eval pass", eval_counts, flash_attention_tokens=layers * n_val_batches)
    if not math.isfinite(val_loss):
        fail("non-finite validation loss")

    # one step from the same weights, batch, chaos fields and dropout
    # stream through the kernels, through the kernels with the split
    # backward, through the forward kernel and the plain backward (P by
    # exp, and by the kernels' exp2), through the plain versions of both,
    # and through the kernels with a fault put into dq (the negative
    # control of the derived bounds below)
    hd = config["model"]["hidden_dim"] // config["model"]["num_heads"]

    def faulted_bwd(*args):
        """The kernels' backward with one 64-query tile of one head of dq
        zeroed, in a copy: the tile of the largest norm, where the step's
        gradient lives (a tile of the frame's empty top rows carries next
        to none, and zeroing it changes nothing a check could see)."""
        dq, dk, dv = attn_ops.flash_attention_tokens_bwd(*args)
        B, L, D = dq.shape
        norms = dq.float().view(B, L // attn_ops.BLOCK, attn_ops.BLOCK, D // hd, hd) \
            .square().sum(dim=(2, 4))
        b, t, h = (int(i) for i in torch.unravel_index(norms.argmax(), norms.shape))
        dq = dq.clone()
        dq[b, t * attn_ops.BLOCK:(t + 1) * attn_ops.BLOCK, h * hd:(h + 1) * hd] = 0
        return dq, dk, dv

    batch = next(it)
    fields = model.chaos_fields(trainer.generator, bs, dev)
    state = copy.deepcopy(model.state_dict())
    runs = {}
    for mode in ("kernels", "split kernels", "plain backward", KERNEL_EXP_RUN, "plain",
                 "kernels, faulted dq"):
        twin = loop.build_train_model(config, dev)
        twin.load_state_dict(state)
        tw = loop.Trainer(twin, config, steps_per_epoch, torch.Generator(dev).manual_seed(1))
        tw.step = trainer.step
        reset_counts()
        if mode == "kernels":
            swap = contextlib.nullcontext()
        elif mode == "split kernels":
            swap = split_backward()
        elif mode == "kernels, faulted dq":
            swap = SwapFlash(ca_mod, attn_ops.flash_attention_tokens_fwd_lse, faulted_bwd)
        else:
            swap = PlainFlash(attn_ops, ca_mod, forward=mode == "plain",
                              kernel_exp=mode == KERNEL_EXP_RUN)
        with swap:
            m = tw.train_step(batch, chaos_fields=fields)
        torch.cuda.synchronize()
        counts = read_counts()
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
    last = f"layer_{layers - 1}."

    def proj_gap(got, ref):
        """{name: ||d||/||ref||} of the q, k, v projection gradients, and
        the largest of the last layer's."""
        rel = {n: rel_norm(got[n], ref[n]) for n in ref}
        return rel, max([x for n, x in rel.items() if n.startswith(last)], default=math.inf)

    # this state's own bf16 rounding-flip noise: the two plain backwards
    bg, eg = runs["plain backward"][3], runs[KERNEL_EXP_RUN][3]
    noise, n_top = proj_gap(eg, bg)
    n_all = max(noise.values())
    top_bound = max(TRAIN_BWD_TOP_PROJ_GRAD_REL_NORM, 2 * n_top)
    all_bound = max(TRAIN_BWD_PROJ_GRAD_REL_NORM, 2 * n_all)
    rel, top = proj_gap(kg, runs["plain"][3])
    worst = max(rel, key=rel.get)
    say(f"train: q, k, v projection gradients, kernels vs plain: {len(rel)} tensors, "
        f"||d||/||ref|| median {statistics.median(rel.values()):.3e}, largest "
        f"{rel[worst]:.3e} ({worst}; bound {TRAIN_PROJ_GRAD_REL_NORM:.3e}); by layer, q k "
        f"v: {[float(f'{x:.3e}') for x in rel.values()]}")
    proj_ok = len(rel) == 3 * layers and max(rel.values()) <= TRAIN_PROJ_GRAD_REL_NORM
    c6 = {"n_top": n_top, "n_all": n_all, "top_bound": top_bound, "all_bound": all_bound}
    for route, got in (("fused", kg), ("split", runs["split kernels"][3])):
        for ref_mode in ("plain backward", KERNEL_EXP_RUN):
            rel, top = proj_gap(got, runs[ref_mode][3])
            say(f"train: C.6 {route} kernels vs {ref_mode}: q, k, v projection gradients "
                f"||d||/||ref||, last layer {top:.3e} (n {n_top:.3e}, bound "
                f"{top_bound:.3e}), all layers {max(rel.values()):.3e} (n {n_all:.3e}, "
                f"bound {all_bound:.3e}); by layer, q k v: "
                f"{[float(f'{x:.3e}') for x in rel.values()]}")
            proj_ok &= (len(rel) == 3 * layers and top <= top_bound
                        and max(rel.values()) <= all_bound)
            c6[f"{route} vs {ref_mode}"] = (top, max(rel.values()))
    # the negative control: the derived bound still catches a fault in dq
    _, control = proj_gap(runs["kernels, faulted dq"][3], bg)
    c6["control"] = control
    say(f"train: C.6 negative control, the kernels with the {attn_ops.BLOCK}-query tile of "
        f"one head of dq of the largest norm zeroed vs plain backward: last layer "
        f"{control:.3e} (must exceed the bound {top_bound:.3e})")
    if not control > top_bound:
        fail("the derived bound on the kernels' backward does not catch a zeroed dq tile")
    none = dict.fromkeys(COUNTERS, 0)
    lse_only = none | {"flash_attention_tokens_fwd_lse": layers}
    fused_counts = lse_only | {"flash_attention_tokens_bwd": layers}
    if not (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_GRAD_NORM_RTOL and proj_ok
            and kc == fused_counts and runs["kernels, faulted dq"][2] == fused_counts
            and runs["plain backward"][2] == lse_only
            and runs[KERNEL_EXP_RUN][2] == lse_only and pc == none):
        fail("the kernels' train step disagrees with the plain versions'")

    # the split backward's step against the plain backward's (its
    # projection gradients were held above)
    sl, sn, sc, _ = runs["split kernels"]
    bl, bn, _, _ = runs["plain backward"]
    loss_rel, norm_rel = abs(sl - bl) / abs(bl), abs(sn - bn) / abs(bn)
    say(f"train: one step, split backward kernels (SMOKEPHYS_FUSED_BWD=0) vs the plain "
        f"backward: loss {sl:.6f} vs {bl:.6f} (rel {loss_rel:.3e}, bound "
        f"{TRAIN_LOSS_RTOL:g}), gradient norm {sn:.5f} vs {bn:.5f} (rel {norm_rel:.3e}, "
        f"bound {TRAIN_GRAD_NORM_RTOL:g}); launches {sc}")
    split_counts = lse_only | {"flash_attention_tokens_bwd_dq": layers,
                               "flash_attention_tokens_bwd_dkv": layers}
    if not (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_GRAD_NORM_RTOL
            and sc == split_counts):
        fail("the split backward's train step disagrees with the plain backward's")

    # the train step on both backward routes, in turns
    route_ms = {"fused": [], "split": []}
    for i in range(2 * ROUTE_STEPS):
        route = ("fused", "split")[i % 2]
        step_batch = next(it)
        reset_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with split_backward() if route == "split" else contextlib.nullcontext():
            a.record()
            metrics = trainer.train_step(step_batch)
            b.record()
            b.synchronize()
        counts = read_counts()
        if route == "split":
            expect_counts("train step, split backward", counts, **split_counts)
        else:
            expect_counts("train step, fused backward", counts,
                          flash_attention_tokens_fwd_lse=layers,
                          flash_attention_tokens_bwd=layers)
        if not math.isfinite(float(metrics["total_loss"])):
            fail(f"non-finite training loss on the {route} backward route")
        route_ms[route].append(a.elapsed_time(b))
    route_med = {r: statistics.median(v) for r, v in route_ms.items()}
    say(f"train: {ROUTE_STEPS} steps on each backward route, in turns: fused "
        f"{[round(x, 2) for x in route_ms['fused']]} ms (median {route_med['fused']:.3f}), "
        f"split {[round(x, 2) for x in route_ms['split']]} ms (median "
        f"{route_med['split']:.3f}; CUDA events)")

    # recipe D's phase-1 step (config_twophase_bf16.yaml with
    # tpu.fast_math=false: exact GELU, float32 residual) from the same
    # weights, in turns with this config's fast_math step
    t = time.time()
    exact_config = apply_overrides(load_config(RECIPE_D_CONFIG), ["tpu.fast_math=false"])
    exact = loop.build_train_model(exact_config, dev)
    exact.load_state_dict(model.state_dict())
    exact_trainer = loop.Trainer(exact, exact_config, steps_per_epoch,
                                 torch.Generator(dev).manual_seed(2))
    exact_trainer.step = trainer.step
    recipe_ms = {"fast_math": [], "fast_math=false": []}
    for i in range(2 * ROUTE_STEPS):
        tag, tr = (("fast_math", trainer), ("fast_math=false", exact_trainer))[i % 2]
        step_batch = next(it)
        reset_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        metrics = tr.train_step(step_batch)
        b.record()
        b.synchronize()
        expect_counts(f"train step, {tag}", read_counts(),
                      flash_attention_tokens_fwd_lse=layers, flash_attention_tokens_bwd=layers)
        if not math.isfinite(float(metrics["total_loss"])):
            fail(f"non-finite training loss in the {tag} step")
        recipe_ms[tag].append(a.elapsed_time(b))
    recipe_med = {k: statistics.median(v) for k, v in recipe_ms.items()}
    say(f"train: recipe D's phase-1 step (config_twophase_bf16, fast_math=false, "
        f"{layers} + {layers} kernel launches a step) and the fast_math step, "
        f"{ROUTE_STEPS} each in turns: fast_math=false {[round(x, 2) for x in recipe_ms['fast_math=false']]} "
        f"ms (median {recipe_med['fast_math=false']:.3f}), fast_math "
        f"{[round(x, 2) for x in recipe_ms['fast_math']]} ms (median "
        f"{recipe_med['fast_math']:.3f}; CUDA events; {time.time() - t:.1f} s)")
    del exact_trainer, exact

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
    reset_counts()
    out = make_predictor(served, chaos_seed=seed)(frames)
    torch.cuda.synchronize()
    serve_counts = read_counts()
    finite = bool(torch.isfinite(out["reconstructed"]).all()
                  and torch.isfinite(out["physics_features"]).all())
    say(f"train: checkpoint served through load_model: weights equal {same}, "
        f"outputs finite {finite}, launches {serve_counts}")
    expect_counts("serving the trained checkpoint", serve_counts,
                  flash_attention_tokens=layers)
    if not (same and finite):
        fail("the trained checkpoint does not serve back")
    del served, out
    return trainer, it, {"step_ms": step_ms, "counts": total, "losses": losses,
                         "split_counts": sc, "route_ms": route_med, "c6": c6,
                         "recipe_ms": recipe_med}


def vorticity_phase(dev, name, trace):
    """config_256_vorticity.yaml's serving path and config_256_finetune.yaml's
    episode generation, where vorticity confinement sends each solver step
    per op through the Jacobi and diffusion kernels: both kernels against
    their plain versions, the slice on smokephysnet_256_vort_best.npz with
    launch counts, eight episodes generated, and their timings."""
    import numpy as np
    import torch

    from smokephysai_tpu_torch import inference
    from smokephysai_tpu_torch.data.synthetic import sample_source_params
    from smokephysai_tpu_torch.ops import jacobi as jacobi_ops
    from smokephysai_tpu_torch.ops import stencil as stencil_ops
    from smokephysai_tpu_torch.physics import solver
    from smokephysai_tpu_torch.physics.simulator import simulate_episode
    from smokephysai_tpu_torch.train.serving import load_model, make_predictor
    from smokephysai_tpu_torch.utils.config import load_config

    config = load_config(VORT_CONFIG)
    sim = config["simulation"]
    dt, visc, iters = sim["dt"], sim["viscosity"], sim["num_jacobi_iters"]
    grid = tuple(sim["grid_size"])
    eps = config["tpu"]["vorticity_eps"]
    h, w = grid
    gen = torch.Generator().manual_seed(2)

    # ------------------------------------------------ kernels vs plain versions
    def pressure_inputs(episodes, hh, ww):
        p = (0.1 * torch.randn(episodes, hh, ww, generator=gen)).to(dev)
        return p, torch.randn(episodes, hh, ww, generator=gen).to(dev)

    card = jacobi_ops.card_active_clusters(torch.cuda.current_device())

    def smallest_cluster(episodes, hh, ww, k):
        """The plan of the fewest CTAs a cluster that the card can run."""
        return min(jacobi_ops.plan_candidates(episodes, hh, ww, card),
                   key=lambda pl: (pl.cluster, -pl.threads))

    def forced_band(episodes, hh, ww, k):
        """The band plan of the smallest shared-memory budget a CTA that
        gives one on a grid that fits one cluster: the most bands."""
        for rows in range(1, hh):
            plans = list(jacobi_ops.band_candidates(
                episodes, hh, ww, k, card, smem_max=jacobi_ops.stripe_bytes(rows, ww)))
            if plans:
                return min(plans, key=lambda pl: (pl.waves, -pl.rows, -pl.cluster))
        fail(f"no band plan of the card fits [{episodes},{hh},{ww}] x{k}")

    jacobi_err = 0.0
    # (episodes, h, w, sweeps, the mode its plan must take, forced plans)
    for episodes, hh, ww, k, mode, forced in (
            (1, h, w, iters, "cluster", ("band",)), (8, h, w, iters, "cluster", ("smallest",)),
            (2, 37, 53, 0, "cluster", ()), (2, 37, 53, 1, "cluster", ()),
            (1, 512, 512, iters, "cluster", ()), (1, 1024, 1024, iters, "band", ()),
            (1, 2048, 2048, iters, "band", ()), (2, 101, 67, 45, "cluster", ("band",)),
            (2, 1100, 900, 45, "band", ())):
        p, div = pressure_inputs(episodes, hh, ww)
        before = (p.clone(), div.clone())
        plan = jacobi_ops.launch_plan(episodes, hh, ww, device=dev, num_iters=k)
        n0 = jacobi_ops.LAUNCHES
        out = jacobi_ops.jacobi_pressure(p, div, k)
        launched = jacobi_ops.LAUNCHES - n0
        ref = jacobi_ops.jacobi_pressure_reference(p, div, k)
        runs = [("plan", plan, out)]
        for which in forced:
            alt = (forced_band if which == "band" else smallest_cluster)(episodes, hh, ww, k)
            runs.append((f"forced {which}", alt, jacobi_ops._launch(p, div, k, alt)))
        torch.cuda.synchronize()
        kept = torch.equal(p, before[0]) and torch.equal(div, before[1])
        for label, pl, got in runs:
            err = maxerr(got, ref)
            say(f"kernel jacobi_pressure [{episodes},{hh},{ww}] x{k} sweeps, {label}: "
                f"{pl.describe()}; max|d| {err:.3e} (bound 0), inputs unchanged {kept}")
            if not (err == 0.0 and kept):
                fail("jacobi_pressure disagrees with its plain version")
            jacobi_err = max(jacobi_err, err)
        if plan.mode != mode or launched != plan.launches(k):
            fail(f"jacobi_pressure [{episodes},{hh},{ww}] x{k}: expected the {mode} mode "
                 f"and {plan.launches(k)} launches, got {plan.mode} and {launched}")
        del p, div, before, out, ref, runs
    coef_uv = np.float32(dt) * np.float32(visc)
    coef_d = np.float32(dt) * (np.float32(visc) * np.float32(0.1))
    shapes = {"u": ((h + 1, w), coef_uv), "v": ((h, w + 1), coef_uv),
              "density": ((h, w), coef_d)}
    diffuse_err = 0.0
    for episodes in (1, GEN_EPISODES):  # serving's batch and generation's
        for field, (shape, coef) in shapes.items():
            f = torch.rand(episodes, *shape, generator=gen).to(dev)
            before = f.clone()
            err = maxerr(stencil_ops.diffuse(f, coef), stencil_ops.diffuse_reference(f, coef))
            kept = torch.equal(f, before)
            say(f"kernel diffuse {field} [{episodes},{shape[0]},{shape[1]}] coef {coef:.3e}: "
                f"max|d| {err:.3e} (bound 0), input unchanged {kept}")
            if not (err == 0.0 and kept):
                fail("diffuse disagrees with its plain version")
            diffuse_err = max(diffuse_err, err)
        fields = [torch.rand(episodes, *shape, generator=gen).to(dev)
                  for shape, _ in shapes.values()]
        before = [f.clone() for f in fields]
        n0 = stencil_ops.LAUNCHES
        outs = stencil_ops.diffuse_fields(*fields, coef_uv, coef_d)
        launched = stencil_ops.LAUNCHES - n0
        errs = [maxerr(o, stencil_ops.diffuse_reference(f, coef))
                for o, f, (_, coef) in zip(outs, fields, shapes.values())]
        kept = all(torch.equal(f, b) for f, b in zip(fields, before))
        say(f"kernel diffuse_fields u, v, density [{episodes},{h},{w}] in {launched} "
            f"launch: max|d| {max(errs):.3e} (bound 0), inputs unchanged {kept}")
        if not (max(errs) == 0.0 and kept and launched == 1):
            fail("diffuse_fields disagrees with its plain version or took more than one "
                 "launch")
        diffuse_err = max(diffuse_err, *errs)

    # ------------------------------------------------ the slice
    if not os.path.exists(VORT_CHECKPOINT):
        fail(f"checkpoint {VORT_CHECKPOINT} is missing")
    t = time.time()
    model = load_model(config, VORT_CHECKPOINT, dev)
    predict = make_predictor(model, chaos_seed=config["tpu"]["seed"])
    simulator = inference.make_simulator(config, dev)
    torch.cuda.synchronize()
    say(f"vorticity slice: model and simulator ready in {time.time() - t:.2f} s "
        f"(compute {model.dtype}, flash {model.layer_0.chaos_attention.use_flash})")
    reset_counts()
    t = time.time()
    sequence = inference.generate_test_sequence(simulator, 20)
    inputs = torch.stack(sequence[:-1])[..., None]
    outputs = predict(inputs)
    torch.cuda.synchronize()
    slice_s = time.time() - t
    launches = read_counts()
    say(f"vorticity slice: {grid[0]}x{grid[1]}, vorticity_eps {eps}, 20 frames and one "
        f"batched forward of 19 in {slice_s * 1e3:.1f} ms (host clock, first call); "
        f"launches {launches}")
    expect_counts("vorticity slice", launches, jacobi_pressure=20, diffuse=20)
    recon, phys = outputs["reconstructed"], outputs["physics_features"]
    if tuple(recon.shape) != (19, *grid, 1) or tuple(phys.shape) != (19, 3):
        fail(f"unexpected output shapes {tuple(recon.shape)}, {tuple(phys.shape)}")
    if not (torch.isfinite(recon).all() and torch.isfinite(phys).all()
            and all(torch.isfinite(f).all() for f in sequence)):
        fail("non-finite frames or model outputs")
    plain_sim = inference.make_simulator(config, dev)
    plain_sim.use_pallas = False
    plain_seq = inference.generate_test_sequence(plain_sim, 20)
    sim_err = maxerr(torch.stack(sequence), torch.stack(plain_seq))
    say(f"vorticity slice: sequence vs the plain per-op solver on the card: max|d| "
        f"{sim_err:.3e} (bound 0: every stage is the plain version's)")
    if sim_err != 0.0:
        fail("the vorticity slice's sequence disagrees with the plain per-op solver")
    f32_config = json.loads(json.dumps(config))
    f32_config["tpu"].update(compute_dtype="float32", use_flash=False, fast_math=False)
    model32 = load_model(f32_config, VORT_CHECKPOINT, dev)
    out32 = make_predictor(model32, chaos_seed=config["tpu"]["seed"])(inputs)
    recon_err = maxerr(recon, out32["reconstructed"])
    truth = torch.stack(sequence[1:])[..., None]
    mse = float(((recon.float() - truth) ** 2).mean())
    mse32 = float(((out32["reconstructed"] - truth) ** 2).mean())
    say(f"vorticity slice: bf16 vs float32 einsum: reconstructed max|d| {recon_err:.3e} "
        f"(bound {RECON_BF16_VS_F32:g}), physics max|d| "
        f"{maxerr(phys, out32['physics_features']):.3e}; next-frame MSE bf16 {mse:.6e}, "
        f"float32 {mse32:.6e}")
    if not (recon_err <= RECON_BF16_VS_F32 and math.isfinite(mse) and math.isfinite(mse32)):
        fail("the vorticity slice's bf16 forward disagrees with the float32 model")
    del model32, out32

    # ------------------------------------------------ generation
    src = {k: v.to(dev) for k, v in
           sample_source_params(torch.Generator().manual_seed(3), GEN_EPISODES, grid).items()}
    T = load_config(FINETUNE_CONFIG)["data"]["sequence_length"]

    def generate(use_pallas):
        return simulate_episode(src["xy"], src["intensity"], src["active"],
                                grid, T, dt, visc, iters, eps, use_pallas)

    reset_counts()
    t = time.time()
    seqs, labels = generate(True)
    torch.cuda.synchronize()
    gen_s = time.time() - t
    gen_counts = read_counts()
    say(f"vorticity generation: {GEN_EPISODES} episodes at {grid[0]}x{grid[1]}, T={T}, "
        f"in {gen_s * 1e3:.1f} ms (host clock, first call); launches {gen_counts}")
    expect_counts("vorticity generation", gen_counts, jacobi_pressure=T, diffuse=T)
    if not (torch.isfinite(seqs).all() and torch.isfinite(labels).all()):
        fail("non-finite generated episodes or labels")
    pseqs, plabels = generate(False)
    gen_err = max(maxerr(seqs, pseqs), maxerr(labels, plabels))
    say(f"vorticity generation: all {GEN_EPISODES} episodes vs the plain per-op loop: "
        f"max|d| {gen_err:.3e} (bound 0); labels mean {labels.mean(dim=0).tolist()}")
    if gen_err != 0.0:
        fail("generated vorticity episodes disagree with the plain per-op loop")

    # ------------------------------------------------ the per-op step at 1024^2
    # config_streaming_1024.yaml's grid with the vorticity configs' eps: the
    # Jacobi kernel's band mode on the JAX package's own per-op path
    big = load_config(STREAM_CONFIG)["simulation"]
    bgrid = tuple(big["grid_size"])
    bdt, bvisc, biters = big["dt"], big["viscosity"], big["num_jacobi_iters"]
    bplan = jacobi_ops.launch_plan(1, *bgrid, device=dev, num_iters=biters)
    u0, v0, _, d0 = smoke_state(dev, 1, bgrid[0], seed=4)
    big_state = solver.init_state(bgrid, device=dev, batch=(1,)).replace(
        u=u0, v=v0, density=d0)

    def big_steps(use_pallas):
        states = [big_state]
        for _ in range(BIG_VORT_STEPS):
            states.append(solver.step(states[-1], bdt, bvisc, biters, eps,
                                      use_pallas=use_pallas))
        return states[1:]

    reset_counts()
    swept0, grid0 = jacobi_ops.SWEPT_CELLS, jacobi_ops.GRID_CELLS
    big_seq = big_steps(True)
    torch.cuda.synchronize()
    big_counts = read_counts()
    swept = (jacobi_ops.SWEPT_CELLS - swept0) / (jacobi_ops.GRID_CELLS - grid0)
    say(f"vorticity steps at {bgrid[0]}x{bgrid[1]}: {BIG_VORT_STEPS} per-op steps "
        f"(vorticity_eps {eps}, {biters} sweeps), launches {big_counts}; Jacobi plan: "
        f"{bplan.describe()}; cells swept per grid cell {swept:.3f}")
    expect_counts(f"vorticity steps at {bgrid[0]}x{bgrid[1]}", big_counts,
                  jacobi_pressure=BIG_VORT_STEPS * bplan.launches(biters),
                  diffuse=BIG_VORT_STEPS)
    if bplan.mode != "band":
        fail(f"the Jacobi kernel at {bgrid[0]}x{bgrid[1]} took the {bplan.mode} mode, "
             f"not the band mode")
    plain_big = big_steps(False)
    big_err = max(maxerr(getattr(a_, f), getattr(b_, f)) for a_, b_ in zip(big_seq, plain_big)
                  for f in ("u", "v", "p", "density"))
    finite = all(torch.isfinite(getattr(s_, f)).all() for s_ in big_seq
                 for f in ("u", "v", "p", "density"))
    say(f"vorticity steps at {bgrid[0]}x{bgrid[1]}: all {BIG_VORT_STEPS} states vs the plain "
        f"per-op solver: max|d| {big_err:.3e} (bound 0), finite {finite}")
    if big_err != 0.0 or not finite:
        fail(f"the per-op steps at {bgrid[0]}x{bgrid[1]} disagree with the plain solver")
    big_ms = timed(lambda: solver.step(big_state, bdt, bvisc, biters, eps, use_pallas=True),
                   runs=10)
    big_plain_ms = timed(lambda: solver.step(big_state, bdt, bvisc, biters, eps,
                                             use_pallas=False), runs=5)
    say(f"time vorticity step {bgrid[0]}x{bgrid[1]} x1 on {name}: kernels {big_ms:.4f} ms, "
        f"plain per-op {big_plain_ms:.4f} ms")
    del big_seq, plain_big

    # ------------------------------------------------ timing
    timings = {}
    for episodes, hh, ww in ((1, h, w), (GEN_EPISODES, h, w), (1, 512, 512), (1, 1024, 1024),
                             (1, 2048, 2048)):
        p, div = pressure_inputs(episodes, hh, ww)
        call = lambda: jacobi_ops.jacobi_pressure(p, div, iters)  # noqa: E731
        ms, dev_ms = timed(call), device_ms(call)
        plain_ms = timed(lambda: jacobi_ops.jacobi_pressure_reference(p, div, iters), runs=5)
        cells = episodes * hh * ww
        bound = lower_bound(3 * 4 * cells, 5 * cells * iters, F32_FLOPS)
        timings[("jacobi_pressure", episodes, hh)] = (ms, plain_ms, *bound)
        say(f"time jacobi_pressure [{episodes},{hh},{ww}] x{iters} sweeps on {name}: wrapper "
            f"{ms:.4f} ms, kernel device {dev_ms:.4f} ms "
            f"({100 * bound[0] / dev_ms:.1f} % of bound), plain {plain_ms:.4f} ms, bound "
            f"{bound[0]:.6f} ms ({bound[1]}); "
            f"{jacobi_ops.launch_plan(episodes, hh, ww, device=dev).describe()}")
    for field, (shape, coef) in shapes.items():
        f = torch.rand(1, *shape, generator=gen).to(dev)
        ms = timed(lambda: stencil_ops.diffuse(f, coef))
        plain_ms = timed(lambda: stencil_ops.diffuse_reference(f, coef))
        n = shape[0] * shape[1]
        bound = lower_bound(2 * 4 * n, 7 * n, F32_FLOPS)
        timings[("diffuse", field)] = (ms, plain_ms, *bound)
        say(f"time diffuse {field} {shape} on {name}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound[0]:.6f} ms ({bound[1]})")
    for episodes in (1, GEN_EPISODES):
        fields = [torch.rand(episodes, *shape, generator=gen).to(dev)
                  for shape, _ in shapes.values()]
        call = lambda: stencil_ops.diffuse_fields(*fields, coef_uv, coef_d)  # noqa: E731
        ms, dev_ms = timed(call), device_ms(call)
        plain_ms = timed(lambda: [stencil_ops.diffuse_reference(f, coef) for f, (_, coef)
                                  in zip(fields, shapes.values())])
        n = sum(f.numel() for f in fields)
        bound = lower_bound(2 * 4 * n, 7 * n, F32_FLOPS)
        timings[("diffuse_fields", episodes)] = (ms, plain_ms, *bound)
        say(f"time diffuse_fields u, v, density [{episodes},{h},{w}] in one launch on "
            f"{name}: wrapper {ms:.4f} ms, kernel device {dev_ms:.4f} ms "
            f"({100 * bound[0] / dev_ms:.1f} % of bound), plain {plain_ms:.4f} ms, bound "
            f"{bound[0]:.6f} ms ({bound[1]})")

    def state_of(episodes):
        s = solver.init_state(grid, device=dev, batch=(episodes,))
        return s.replace(density=seqs[:episodes, T // 2].contiguous())

    step_ms = {}
    for episodes in (1, GEN_EPISODES):
        s = state_of(episodes)
        ms = timed(lambda: solver.step(s, dt, visc, iters, eps, use_pallas=True))
        plain_ms = timed(lambda: solver.step(s, dt, visc, iters, eps, use_pallas=False),
                         runs=5)
        step_ms[episodes] = ms
        say(f"time vorticity step {grid[0]}x{grid[1]} x{episodes} on {name}: kernels "
            f"{ms:.4f} ms, plain per-op {plain_ms:.4f} ms")
    chunk_ms = timed(lambda: generate(True), runs=5, warmup=1)
    say(f"time vorticity generation chunk ({GEN_EPISODES} episodes x {T} steps at "
        f"{grid[0]}x{grid[1]}: sources, steps, perturbation, chaos labels) on {name}: "
        f"{chunk_ms:.4f} ms")
    serve_batch = config["training"]["batch_size"]
    fwd_ms = {b: timed(lambda: predict(inputs[:b])) for b in (19, serve_batch)}
    say(f"time vorticity serving forward (bf16, einsum) on {name}: B=19 {fwd_ms[19]:.3f} "
        f"ms, B={serve_batch} {fwd_ms[serve_batch]:.3f} ms")
    if trace:
        s = state_of(1)
        profile(lambda: solver.step(s, dt, visc, iters, eps, use_pallas=True), 20,
                f"vorticity step {grid[0]}x{grid[1]}", top=25)
    del model, predict
    return {"launches": launches, "jacobi_err": jacobi_err, "diffuse_err": diffuse_err,
            "timings": timings, "big_counts": big_counts, "big_grid": bgrid,
            "big_plan": bplan.describe(), "big_ms": big_ms}


def flash_check(attn_ops, q, k, v, g, heads, tag):
    """The three flash kernels and the split backward pair against their
    plain versions at one shape, with the head_dim-64 checks' bounds; each
    forward run twice, bit-equal, and the lean output equal to the LSE
    forward's to the bit; returns the largest |d| of each."""
    import torch

    o = attn_ops.flash_attention_tokens(q, k, v, heads)
    r = attn_ops.flash_attention_tokens_reference(q, k, v, heads)
    ol, lse = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)
    rl, rlse = attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads)
    kg = attn_ops.flash_attention_tokens_bwd(q, k, v, rl, rlse, g, heads)
    pg = attn_ops.flash_attention_tokens_bwd_reference(q, k, v, rl, rlse, g, heads)
    again, (ol2, lse2) = (attn_ops.flash_attention_tokens(q, k, v, heads),
                          attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads))
    torch.cuda.synchronize()
    same = (torch.equal(o, ol) and torch.equal(o, again) and torch.equal(ol, ol2)
            and torch.equal(lse, lse2))
    say(f"kernel flash_attention_tokens (+ _fwd_lse) {tag}: lean = LSE output, and each "
        f"forward = its second run, bit for bit: {same}")
    errs = {}
    ok = same
    for kname, a, b in (("flash_attention_tokens", o, r),
                        ("flash_attention_tokens_fwd_lse", ol, rl)):
        err, rel = maxerr(a, b), rel_norm(a, b)
        if q.dtype == torch.bfloat16:
            bound = FLASH_BF16_ULPS * bf16_ulp(float(b.float().abs().max()))
            ok &= err <= bound and rel <= FLASH_BF16_REL_NORM
        else:
            bound = FLASH_F32_ATOL
            ok &= err <= bound
        errs[kname] = err
        say(f"kernel {kname} {tag}: max|d| {err:.3e} (bound {bound:.3e}), "
            f"||d||/||ref|| {rel:.3e}")
    lse_err = maxerr(lse, rlse)
    ok &= lse_err <= LSE_ATOL
    rels = [rel_norm(a, b) for a, b in zip(kg, pg)]
    bwd_bound = BWD_BF16_REL_NORM if q.dtype == torch.bfloat16 else BWD_F32_REL_NORM
    ok &= max(rels) <= bwd_bound
    errs["flash_attention_tokens_bwd"] = max(maxerr(a, b) for a, b in zip(kg, pg))
    say(f"kernel flash_attention_tokens_fwd_lse {tag}: lse max|d| {lse_err:.3e} (bound "
        f"{LSE_ATOL:g}); flash_attention_tokens_bwd {tag}: ||d||/||ref|| dq {rels[0]:.3e} "
        f"dk {rels[1]:.3e} dv {rels[2]:.3e} (bound {bwd_bound:.3e})")
    if not ok:
        fail(f"a flash kernel disagrees with its plain version at {tag}")
    errs.update(split_check(attn_ops, (q, k, v, rl, rlse, g), heads, tag, bwd_bound, kg))
    return errs


def flash_timings(attn_ops, dev, gen, batch, length, width, heads, dtype, name):
    """The lean and LSE forwards, the fused backward (with its delta, dq
    zeroing and cast) and the split pair's kernels alone (delta given) at
    [batch, length, width], each beside its plain version, its bound and one
    PyTorch call (SDPA: the forward with inputs that need a gradient for the
    LSE forward, its autograd backward for the backward kernels); the
    backward kernels and SDPA's backward in turns, three rounds. Bounds:
    bf16 at the bf16 tensor-core rate, float32 at F32_FLASH_FLOPS. Returns
    {kname: (ms, plain ms, bound ms, bound by, library ms)}."""
    import torch

    hd = width // heads
    q, k, v, g = (torch.randn(batch, length, width, generator=gen).to(dev, dtype)
                  for _ in range(4))
    f32 = dtype == torch.float32
    peak, tname = (F32_FLASH_FLOPS, "f32") if f32 else (BF16_FLOPS, "bf16")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t_.view(batch, length, heads, hd).transpose(1, 2).detach().requires_grad_()
                  for t_ in (q, k, v))
    gh = g.view(batch, length, heads, hd).transpose(1, 2)
    o, lse = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)
    pair = batch * heads * length * length * hd
    io = 4 * batch * length * width * q.element_size()
    lse_bytes = batch * heads * length * 4
    lean = (timed(lambda: attn_ops.flash_attention_tokens(q, k, v, heads)),
            timed(lambda: attn_ops.flash_attention_tokens_reference(q, k, v, heads)),
            *lower_bound(io, 4 * pair, peak),
            timed(lambda: sdpa(qh.detach(), kh.detach(), vh.detach())))
    fwd = (timed(lambda: attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)),
           timed(lambda: attn_ops.flash_attention_tokens_fwd_lse_reference(q, k, v, heads)),
           *lower_bound(io + lse_bytes, 4 * pair, peak),
           timed(lambda: sdpa(qh, kh, vh)))
    oh = sdpa(qh, kh, vh)
    delta = attn_ops._delta(o, g, heads)
    turns = in_turns({  # the backward kernels and SDPA's backward, three rounds
        "kernel": lambda: attn_ops.flash_attention_tokens_bwd(q, k, v, o, lse, g, heads),
        "dq": lambda: attn_ops._launch_bwd_dq(q, k, v, g, lse, delta, heads, 1.0),
        "dkv": lambda: attn_ops._launch_bwd_dkv(q, k, v, g, lse, delta, heads, 1.0),
        "sdpa": lambda: torch.autograd.grad(oh, (qh, kh, vh), gh, retain_graph=True)})
    bwd = (turns["kernel"],
           timed(lambda: attn_ops.flash_attention_tokens_bwd_reference(
               q, k, v, o, lse, g, heads), runs=5),
           *lower_bound(2 * io + lse_bytes, 10 * pair, peak),
           turns["sdpa"])
    out = {}
    tag = f"[{batch},{length},{width}] {tname} head_dim {hd} on {name}"
    for kname, t_, flops in (("flash_attention_tokens", lean, 4 * pair),
                             ("flash_attention_tokens_fwd_lse", fwd, 4 * pair),
                             ("flash_attention_tokens_bwd", bwd, 10 * pair)):
        out[kname] = t_
        say(f"time {kname} {tag}: kernel {t_[0]:.4f} ms ({flash_rate(flops, t_[0], t_[2])}), "
            f"plain {t_[1]:.4f} ms, SDPA {t_[4]:.4f} ms, bound {t_[2]:.6f} ms ({t_[3]})")
    # the split pair's kernels alone on one delta (q, k, v, dO, lse and
    # delta read once, the gradients written once)
    for kname, products, outs, ref in (
            ("flash_attention_tokens_bwd_dq", 3, 1,
             attn_ops.flash_attention_tokens_bwd_dq_reference),
            ("flash_attention_tokens_bwd_dkv", 4, 2,
             attn_ops.flash_attention_tokens_bwd_dkv_reference)):
        ms = turns[kname.rsplit("_", 1)[1]]
        kb = lower_bound((4 + outs) * io // 4 + 2 * lse_bytes, 2 * products * pair, peak)
        plain_ms = timed(lambda: ref(q, k, v, o, lse, g, heads), runs=5)
        out[kname] = (ms, plain_ms, *kb, turns["sdpa"])
        say(f"time {kname} {tag}: kernel {ms:.4f} ms (delta given; "
            f"{flash_rate(2 * products * pair, ms, kb[0])}), plain {plain_ms:.4f} ms, SDPA "
            f"backward {turns['sdpa']:.4f} ms, bound {kb[0]:.6f} ms ({kb[1]}); medians of "
            f"three rounds in turns")
    return out


def lean_f32_check(attn_ops, dev, gen, batch, width, heads, name):
    """The float32 lean forward at [batch, 1024, width] (the PGD report
    under use_flash runs it on one batch of GATE_SAMPLES): against its plain
    version at FLASH_F32_ATOL, run twice bit-equal and equal to the LSE
    forward's output to the bit, then timed beside its plain version, its
    bound and SDPA on the same tensors. Returns (max |d|, (ms, plain ms,
    bound ms, bound by, SDPA ms))."""
    import torch

    hd = width // heads
    q, k, v = (torch.randn(batch, 1024, width, generator=gen).to(dev) for _ in range(3))
    o = attn_ops.flash_attention_tokens(q, k, v, heads)
    again = attn_ops.flash_attention_tokens(q, k, v, heads)
    ol, _ = attn_ops.flash_attention_tokens_fwd_lse(q, k, v, heads)
    r = attn_ops.flash_attention_tokens_reference(q, k, v, heads)
    torch.cuda.synchronize()
    same = torch.equal(o, again) and torch.equal(o, ol)
    err, rel = maxerr(o, r), rel_norm(o, r)
    tag = f"[{batch},1024,{width}] f32 head_dim {hd}"
    say(f"kernel flash_attention_tokens {tag}: max|d| {err:.3e} (bound "
        f"{FLASH_F32_ATOL:g}), ||d||/||ref|| {rel:.3e}; rerun and LSE output bit-equal: "
        f"{same}")
    if not (same and err <= FLASH_F32_ATOL):
        fail(f"the float32 lean forward disagrees with its plain version at {tag}")
    del o, again, ol, r
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t_.view(batch, 1024, heads, hd).transpose(1, 2) for t_ in (q, k, v))
    pair = batch * heads * 1024 * 1024 * hd
    t_ = (timed(lambda: attn_ops.flash_attention_tokens(q, k, v, heads)),
          timed(lambda: attn_ops.flash_attention_tokens_reference(q, k, v, heads), runs=5),
          *lower_bound(4 * batch * 1024 * width * 4, 4 * pair, F32_FLASH_FLOPS),
          timed(lambda: sdpa(qh, kh, vh)))
    say(f"time flash_attention_tokens {tag} on {name}: kernel {t_[0]:.4f} ms "
        f"({flash_rate(4 * pair, t_[0], t_[2])}), plain {t_[1]:.4f} ms, SDPA {t_[4]:.4f} "
        f"ms, bound {t_[2]:.6f} ms ({t_[3]})")
    return err, t_


def volumetric_phase(dev, name, trace):
    """config_128cubed.yaml's path: the CG kernel against its plain version,
    two 128^3 episodes generated through the 3D dataset (one CG solve per
    step), smokephysnet3d_128cubed.npz served on them through load_model and
    make_predictor (against the same model in float64), the flash kernels at
    head_dim 32 (bf16 and float32) and the model with use_flash, and their
    timings."""
    import copy

    import numpy as np
    import torch

    from smokephysai_tpu_torch.data.synthetic3d import SyntheticSmokeDataset3D
    from smokephysai_tpu_torch.models.net3d import SmokePhysNet3D
    from smokephysai_tpu_torch.ops import attention as attn_ops
    from smokephysai_tpu_torch.ops import cg3d as cg_ops
    from smokephysai_tpu_torch.physics import solver3d
    from smokephysai_tpu_torch.physics.simulator3d import simulate_episode3d
    from smokephysai_tpu_torch.train.serving import load_model, make_predictor
    from smokephysai_tpu_torch.utils.config import load_config

    config = load_config(VOL_CONFIG)
    sim, data, tpu = config["simulation"], config["data"], config["tpu"]
    dt, visc = sim["dt"], sim["viscosity"]
    grid = tuple(data["grid_size"])
    T, seed = data["sequence_length"], tpu["seed"]
    iters = 30  # step3d's num_cg_iters, which no config sets
    gen = torch.Generator().manual_seed(4)

    # ------------------------------------------------ CG kernel vs plain version
    cg_err, cg_rel = 0.0, 0.0
    card = cg_ops.card_occupancy(torch.cuda.current_device())
    for shape, k, warm in (((1, *grid), iters, False), ((1, *grid), iters, True),
                           ((2, *grid), iters, True), ((1, 160, 160, 160), iters, True),
                           ((2, 64, 64, 64), iters, True), ((1, 37, 53, 29), iters, True),
                           ((1, 37, 53, 29), 0, True), ((1, 37, 53, 29), 1, True)):
        div = torch.randn(*shape, generator=gen).to(dev)
        p0 = ((0.1 * torch.randn(*shape, generator=gen)).to(dev) if warm
              else torch.zeros(*shape, device=dev))
        before = (p0.clone(), div.clone())
        plan = cg_ops.launch_plan(*shape, device=dev)
        out = cg_ops.cg_pressure(p0, div, k)
        again = cg_ops.cg_pressure(p0, div, k)
        ref = cg_ops.cg_pressure_reference(p0, div, k)
        solo = [cg_ops.cg_pressure(p0[e:e + 1].contiguous(), div[e:e + 1].contiguous(), k)
                for e in range(shape[0])]
        # the global mode forced on what runs on chip, batches included: the
        # same bits
        forced = (cg_ops._launch(p0, div, k, cg_ops.plan_launch(*shape, *card, mode="global"))
                  if plan.mode == "chip" and warm and k == iters else out)
        torch.cuda.synchronize()
        err = maxerr(out, ref)
        rel = rel_norm(out, ref) if err > 0.0 else 0.0
        solo_ok = all(torch.equal(out[e:e + 1], s_) for e, s_ in enumerate(solo))
        kept = torch.equal(p0, before[0]) and torch.equal(div, before[1])
        say(f"kernel cg_pressure {list(shape)} x{k} from {'a warm' if warm else 'zero'} p0 "
            f"({plan.describe()}; {cg_ops.launches_per_solve(k)} launch): ||d||/||ref|| "
            f"{rel:.3e} (bound {CG_REL_NORM:g}), max|d| {err:.3e}, two runs bit-equal "
            f"{torch.equal(out, again)}, each episode = its solo solve {solo_ok}, inputs "
            f"unchanged {kept}" + (f", forced global mode bit-equal {torch.equal(forced, out)}"
                                   if forced is not out else ""))
        if not (rel <= CG_REL_NORM and torch.equal(out, again) and solo_ok and kept
                and torch.equal(forced, out)):
            fail("cg_pressure disagrees with its plain version, itself, its solo solves or "
                 "its global mode")
        cg_err, cg_rel = max(cg_err, err), max(cg_rel, rel)
        del div, p0, before, out, again, ref, solo, forced
    zero = torch.zeros(2, 32, 32, 32, device=dev)
    zout = cg_ops.cg_pressure(zero, zero, iters)
    say(f"kernel cg_pressure zero divergence from p0 = 0: p stays p0 exactly "
        f"{torch.equal(zout, zero)} (the denom > 0 and rs > 0 guards)")
    if not torch.equal(zout, zero):
        fail("cg_pressure moves p on zero divergence")

    # ------------------------------------------------ generation (dataset path)
    reset_counts()
    t = time.time()
    ds = SyntheticSmokeDataset3D(num_samples=VOL_EPISODES, grid_size=grid,
                                 sequence_length=T, seed=seed,
                                 use_pallas=tpu["use_pallas"], device=dev)
    torch.cuda.synchronize()
    gen_s = time.time() - t
    gen_counts = read_counts()
    say(f"volumetric generation: {VOL_EPISODES} episodes at {grid}, T={T}, dt {dt}, "
        f"viscosity {visc}, {iters} CG iterations, through SyntheticSmokeDataset3D "
        f"(use_pallas {tpu['use_pallas']}) in {gen_s:.2f} s (host clock, first call, "
        f"labels and the host copy included); launches {gen_counts}")
    expect_counts("volumetric generation", gen_counts, cg_pressure=VOL_EPISODES * T)
    seqs = ds._sequences
    labels = ds._chaos
    if not (torch.isfinite(seqs).all() and torch.isfinite(labels).all()):
        fail("non-finite volumetric episodes or labels")
    src = [torch.from_numpy(ds.data[k]).to(dev)
           for k in ("source_xyz", "source_intensity", "source_active")]
    pseqs, plabels = simulate_episode3d(*src, grid_size=grid, num_steps=T, dt=dt,
                                        viscosity=visc, use_pallas=False)
    frame_err = (seqs - pseqs).abs().amax(dim=(0, 2, 3, 4))
    seq_err, lab_err = float(frame_err.max()), maxerr(labels, plabels)
    say(f"volumetric generation vs the plain CG on the card: density max|d| per frame "
        f"{[float(f'{x:.3e}') for x in frame_err.tolist()]} (bound {VOL_EPISODE_ATOL:g}); "
        f"chaos labels max|d| {lab_err:.3e} (bound {VOL_LABEL_ATOL:g}), labels "
        f"{labels.tolist()}")
    if not (seq_err <= VOL_EPISODE_ATOL and lab_err <= VOL_LABEL_ATOL):
        fail("generated volumetric episodes disagree with the plain CG path")
    del pseqs

    # ------------------------------------------------ serving
    if not os.path.exists(VOL_CHECKPOINT):
        fail(f"checkpoint {VOL_CHECKPOINT} is missing")
    t = time.time()
    model = load_model(config, VOL_CHECKPOINT, dev)
    predict = make_predictor(model, chaos_seed=seed)
    torch.cuda.synchronize()
    say(f"volumetric serving: model ready in {time.time() - t:.2f} s (hidden "
        f"{model.hidden_dim}, {model.num_layers} layers, "
        f"{model.layer_0.chaos_attention.num_heads} heads, compute {model.dtype}, flash "
        f"{model.layer_0.chaos_attention.use_flash}, "
        f"{sum(p.numel() for p in model.parameters())} parameters)")
    tf = T // 2
    x = seqs[:1, tf][..., None].contiguous()
    truth = seqs[:1, tf + 1][..., None]
    reset_counts()
    t = time.time()
    out = predict(x)
    torch.cuda.synchronize()
    serve_counts = read_counts()
    say(f"volumetric serving: frame {tf} -> {tf + 1} of episode 0 at batch 1 in "
        f"{(time.time() - t) * 1e3:.1f} ms (host clock, first call); launches {serve_counts}")
    expect_counts("volumetric serving", serve_counts)
    recon, phys = out["reconstructed"], out["physics_features"]
    if tuple(recon.shape) != (1, *grid, 1) or tuple(phys.shape) != (1, 3):
        fail(f"unexpected volumetric output shapes {tuple(recon.shape)}, {tuple(phys.shape)}")
    if not (torch.isfinite(recon).all() and torch.isfinite(phys).all()):
        fail("non-finite volumetric model outputs")
    mc = config["model"]
    model64 = SmokePhysNet3D(mc["hidden_dim"], mc["num_layers"], mc["num_heads"],
                             mc["output_channels"], mc["chaos_strength"],
                             dtype=torch.float64).double().to(dev)
    model64.load_state_dict(model.state_dict(), strict=True)
    out64 = make_predictor(model64.eval(), chaos_seed=seed)(x.double())
    recon_err = maxerr(recon, out64["reconstructed"])
    mse = float(((recon - truth) ** 2).mean())
    say(f"volumetric serving: float32 vs float64 on the card: reconstructed max|d| "
        f"{recon_err:.3e} (bound {VOL_RECON_F64:g}), physics max|d| "
        f"{maxerr(phys, out64['physics_features']):.3e}; next-volume MSE {mse:.6e} "
        f"(PARITY.md: {PARITY_VOL_MSE} for the JAX model on JAX's held-out draws, "
        f"other episodes; not a target)")
    if not (recon_err <= VOL_RECON_F64 and math.isfinite(mse)):
        fail("the volumetric forward disagrees with its float64 run")
    del model64, out64

    # ------------------------------------------------ head_dim 32 (C.3)
    width, heads = config["model"]["hidden_dim"], config["model"]["num_heads"]
    hd = width // heads
    flash_errs = {"bf16": {}, "f32": {}}  # the model paths run float32 (B = 1)
    for batch, dtype in ((1, torch.float32), (1, torch.bfloat16), (8, torch.bfloat16)):
        q, k, v, g = (torch.randn(batch, 512, width, generator=gen).to(dev, dtype)
                      for _ in range(4))
        tag = f"[{batch},512,{width}] {str(dtype)[6:]} head_dim {hd}"
        errs = flash_errs["bf16" if dtype == torch.bfloat16 else "f32"]
        for kname, err in flash_check(attn_ops, q, k, v, g, heads, tag).items():
            errs[kname] = max(errs.get(kname, 0.0), err)
    cfg_flash = copy.deepcopy(config)
    cfg_flash["tpu"]["use_flash"] = True
    model_fl = load_model(cfg_flash, VOL_CHECKPOINT, dev)
    reset_counts()
    out_fl = make_predictor(model_fl, chaos_seed=seed)(x)
    torch.cuda.synchronize()
    flash_serve_counts = read_counts()
    fl_err = maxerr(out_fl["reconstructed"], recon)
    say(f"volumetric serving with use_flash (head_dim {hd}, float32 kernel) vs einsum: "
        f"reconstructed max|d| {fl_err:.3e} (bound {VOL_FLASH_RECON:g}); launches "
        f"{flash_serve_counts}")
    expect_counts("volumetric serving with use_flash", flash_serve_counts,
                  flash_attention_tokens=model.num_layers)
    if not fl_err <= VOL_FLASH_RECON:
        fail("the volumetric forward with use_flash disagrees with einsum")
    # the input gradient of the eval forward (what a gradient attack on the
    # evaluation takes): the forward-with-lse and backward kernels
    grads = {}
    for tag, m in (("flash", model_fl), ("einsum", model)):
        m.requires_grad_(False)
        xg = x.clone().requires_grad_()
        reset_counts()
        o = m(xg, generator=torch.Generator().manual_seed(seed))
        (o["reconstructed"] - truth).pow(2).mean().backward()
        torch.cuda.synchronize()
        grads[tag] = (xg.grad, read_counts())
    grad_rel = rel_norm(grads["flash"][0], grads["einsum"][0])
    grad_counts = grads["flash"][1]
    say(f"volumetric input gradient, flash vs einsum: ||d||/||ref|| {grad_rel:.3e} "
        f"(bound {VOL_FLASH_GRAD_REL_NORM:g}); launches {grad_counts}")
    expect_counts("volumetric input gradient with use_flash", grad_counts,
                  flash_attention_tokens_fwd_lse=model.num_layers,
                  flash_attention_tokens_bwd=model.num_layers)
    expect_counts("volumetric input gradient, einsum", grads["einsum"][1])
    if not grad_rel <= VOL_FLASH_GRAD_REL_NORM:
        fail("the flash input gradient disagrees with einsum")
    del model_fl, out_fl, grads, o, xg

    # ------------------------------------------------ timing
    timings = {}
    div = torch.randn(1, *grid, generator=gen).to(dev)
    p0 = torch.zeros(1, *grid, device=dev)
    ms = timed(lambda: cg_ops.cg_pressure(p0, div, iters))
    cg_device_ms = device_ms(lambda: cg_ops.cg_pressure(p0, div, iters))
    plain_ms = timed(lambda: cg_ops.cg_pressure_reference(p0, div, iters), runs=5)
    cells = div.numel()
    # per cell and iteration: matvec 8 (6 adds, a multiply, the negation),
    # d.Ad 2, p update 2, r update 2, r.r 2, d = r + beta d 2
    cg_bound = lower_bound(3 * 4 * cells, 18 * cells * iters + 12 * cells, F32_FLOPS)
    timings["cg_pressure"] = (ms, plain_ms, *cg_bound)
    cg_plan = cg_ops.launch_plan(1, *grid, device=dev).describe()
    say(f"time cg_pressure [1,{grid[0]},{grid[1]},{grid[2]}] x{iters} on {name}: kernel "
        f"{ms:.4f} ms, device {cg_device_ms:.4f} ms ({cg_ops.launches_per_solve(iters)} "
        f"launch, {cg_plan}), plain {plain_ms:.4f} ms, bound {cg_bound[0]:.6f} ms "
        f"({cg_bound[1]})")
    state = solver3d.init_state3d(grid, device=dev, batch=(1,))
    state = state.replace(density=seqs[:1, tf].contiguous())
    step_ms = timed(lambda: solver3d.step3d(state, dt, visc, use_pallas=True), runs=10)
    plain_step_ms = timed(lambda: solver3d.step3d(state, dt, visc, use_pallas=False), runs=5)
    say(f"time volumetric step {grid} x1 on {name}: CG kernel {step_ms:.4f} ms, plain CG "
        f"{plain_step_ms:.4f} ms")
    src1 = [t_[:1] for t_ in src]
    episode_ms = timed(lambda: simulate_episode3d(*src1, grid_size=grid, num_steps=T, dt=dt,
                                                  viscosity=visc, use_pallas=True),
                       runs=3, warmup=1)
    say(f"time volumetric episode (1 x {T} steps at {grid}, sources and chaos label "
        f"included) on {name}: {episode_ms:.4f} ms")
    fwd_ms = timed(lambda: predict(x), runs=10)
    say(f"time volumetric serving forward B=1 (float32, einsum) on {name}: {fwd_ms:.3f} ms")
    profile(lambda: solver3d.step3d(state, dt, visc, use_pallas=True), 5,
            f"volumetric step {grid}", top=12 if trace else 6)

    # the flash kernels at head_dim 32: bf16 at B = 1 and 8, and float32 at
    # B = 1 (what the 3D model's paths launch: serving, the input gradient
    # and the train step under use_flash), keyed (kname, batch) and
    # (kname, "f32")
    for batch, dtype in ((1, torch.bfloat16), (8, torch.bfloat16), (1, torch.float32)):
        key = "f32" if dtype == torch.float32 else batch
        for kname, t_ in flash_timings(attn_ops, dev, gen, batch, 512, width, heads, dtype,
                                       name).items():
            timings[(kname, key)] = t_
    del model, predict, ds, seqs
    return {"gen_counts": gen_counts, "flash_counts": {**flash_serve_counts, **{
        k_: grad_counts[k_] for k_ in ("flash_attention_tokens_fwd_lse",
                                       "flash_attention_tokens_bwd")}},
            "cg_err": cg_err, "cg_plan": cg_plan, "flash_errs": flash_errs, "timings": timings,
            "hd": hd,
            "width": width, "heads": heads}


def plume_phase(dev, name):
    """config_512_plume.yaml's physics at 512^2 (vorticity_eps 2.0: per-op
    steps): one chunk of PLUME_EPISODES episodes of T steps through
    `simulate_episode`, one Jacobi launch (the cluster mode, strips of 4
    rows) and one three-field diffusion launch a step, all episodes and
    labels bit-equal to the plain per-op loop, as at 256^2; the step timed
    at 1 and 8 episodes, the Jacobi kernel at [8,512,512] and the diffusion
    at the chunk's fields against their plain versions."""
    import numpy as np
    import torch

    from smokephysai_tpu_torch.data.synthetic import sample_source_params
    from smokephysai_tpu_torch.ops import jacobi as jacobi_ops
    from smokephysai_tpu_torch.ops import stencil as stencil_ops
    from smokephysai_tpu_torch.physics import solver
    from smokephysai_tpu_torch.physics.simulator import simulate_episode
    from smokephysai_tpu_torch.utils.config import load_config

    config = load_config(PLUME_CONFIG)
    sim = config["simulation"]
    dt, visc, iters = sim["dt"], sim["viscosity"], sim["num_jacobi_iters"]
    grid = tuple(sim["grid_size"])
    h, w = grid
    eps = config["tpu"]["vorticity_eps"]
    T = config["data"]["sequence_length"]
    n = PLUME_EPISODES
    plan = jacobi_ops.launch_plan(n, h, w, device=dev, num_iters=iters)
    say(f"plume: {n} episodes at {h}x{w}, T={T}, vorticity_eps {eps}; Jacobi plan "
        f"{plan.describe()}")
    if plan.mode != "cluster" or plan.strip != 4:
        fail(f"the Jacobi kernel at [{n},{h},{w}] took {plan.describe()}, not the cluster "
             f"mode with strips of 4 rows")
    src = {k: v.to(dev) for k, v in
           sample_source_params(torch.Generator().manual_seed(5), n, grid).items()}

    def generate(use_pallas):
        return simulate_episode(src["xy"], src["intensity"], src["active"],
                                grid, T, dt, visc, iters, eps, use_pallas)

    reset_counts()
    t = time.time()
    seqs, labels = generate(True)
    torch.cuda.synchronize()
    gen_s = time.time() - t
    counts = read_counts()
    say(f"plume: chunk in {gen_s * 1e3:.1f} ms (host clock, first call); launches {counts}")
    expect_counts("512^2 plume chunk", counts, jacobi_pressure=T * plan.launches(iters),
                  diffuse=T)
    if not (torch.isfinite(seqs).all() and torch.isfinite(labels).all()):
        fail("non-finite 512^2 episodes or labels")
    pseqs, plabels = generate(False)
    err = max(maxerr(seqs, pseqs), maxerr(labels, plabels))
    say(f"plume: all {n} episodes and labels vs the plain per-op loop: max|d| {err:.3e} "
        f"(bound 0); labels mean {labels.mean(dim=0).tolist()}")
    if err != 0.0:
        fail("the 512^2 plume chunk disagrees with the plain per-op loop")
    del pseqs, plabels

    step_ms = {}
    for episodes in (1, n):
        s = solver.init_state(grid, device=dev, batch=(episodes,)).replace(
            density=seqs[:episodes, T // 2].contiguous())
        reset_counts()
        solver.step(s, dt, visc, iters, eps, use_pallas=True)
        torch.cuda.synchronize()
        expect_counts(f"512^2 step x{episodes}", read_counts(), jacobi_pressure=1, diffuse=1)
        ms = timed(lambda: solver.step(s, dt, visc, iters, eps, use_pallas=True), runs=10)
        plain_ms = timed(lambda: solver.step(s, dt, visc, iters, eps, use_pallas=False),
                         runs=5)
        step_ms[episodes] = (ms, plain_ms)
        say(f"time plume step {h}x{w} x{episodes} on {name}: kernels {ms:.4f} ms, plain "
            f"per-op {plain_ms:.4f} ms")
    gen = torch.Generator().manual_seed(6)
    p = (0.1 * torch.randn(n, h, w, generator=gen)).to(dev)
    div = torch.randn(n, h, w, generator=gen).to(dev)
    call = lambda: jacobi_ops.jacobi_pressure(p, div, iters)  # noqa: E731
    jacobi_err = maxerr(call(), jacobi_ops.jacobi_pressure_reference(p, div, iters))
    ms, dev_ms = timed(call), device_ms(call)
    plain_ms = timed(lambda: jacobi_ops.jacobi_pressure_reference(p, div, iters), runs=5)
    cells = n * h * w
    bound = lower_bound(3 * 4 * cells, 5 * cells * iters, F32_FLOPS)
    timings = {"jacobi_pressure": (ms, plain_ms, *bound)}
    say(f"time jacobi_pressure [{n},{h},{w}] x{iters} sweeps on {name}: wrapper {ms:.4f} ms, "
        f"kernel device {dev_ms:.4f} ms ({100 * bound[0] / dev_ms:.1f} % of bound), plain "
        f"{plain_ms:.4f} ms, bound {bound[0]:.6f} ms ({bound[1]}); max|d| {jacobi_err:.3e}")
    coef_uv = np.float32(dt) * np.float32(visc)
    coef_d = np.float32(dt) * (np.float32(visc) * np.float32(0.1))
    shapes = (((h + 1, w), coef_uv), ((h, w + 1), coef_uv), ((h, w), coef_d))
    fields = [torch.rand(n, *shape, generator=gen).to(dev) for shape, _ in shapes]
    call = lambda: stencil_ops.diffuse_fields(*fields, coef_uv, coef_d)  # noqa: E731
    diffuse_err = max(maxerr(a, stencil_ops.diffuse_reference(f, c))
                      for a, f, (_, c) in zip(call(), fields, shapes))
    ms, dev_ms = timed(call), device_ms(call)
    plain_ms = timed(lambda: [stencil_ops.diffuse_reference(f, c)
                              for f, (_, c) in zip(fields, shapes)])
    cells = sum(f.numel() for f in fields)
    bound = lower_bound(2 * 4 * cells, 7 * cells, F32_FLOPS)
    timings["diffuse"] = (ms, plain_ms, *bound)
    say(f"time diffuse_fields u [{n},{h + 1},{w}], v [{n},{h},{w + 1}], density "
        f"[{n},{h},{w}] in one launch on {name}: wrapper {ms:.4f} ms, kernel device "
        f"{dev_ms:.4f} ms ({100 * bound[0] / dev_ms:.1f} % of bound), plain {plain_ms:.4f} "
        f"ms, bound {bound[0]:.6f} ms ({bound[1]}); max|d| {diffuse_err:.3e}")
    if jacobi_err != 0.0 or diffuse_err != 0.0:
        fail("the Jacobi or diffusion kernel at 512^2 disagrees with its plain version")
    return {"counts": counts, "err": err, "jacobi_err": jacobi_err,
            "diffuse_err": diffuse_err, "timings": timings, "plan": plan.describe(),
            "step_ms": step_ms, "grid": grid, "episodes": n, "steps": T}


def mg_phase(dev, name):
    """`step3d(pressure_solver="mg")` at config_128cubed.yaml's 128^3: on a
    warm-started system (MG_WARM_STEPS CG-kernel steps of a smoke source),
    the residual of 2 V-cycles against the CG kernel's 30 iterations on the
    same right-hand side (fails over MG_CG_RATIO times it), the V-cycles on
    the card against the same V-cycles on the CPU; one mg step (no kernel
    launch) against the CG-kernel step (one), both timed in turns."""
    import torch

    from smokephysai_tpu_torch.ops import cg3d as cg_ops
    from smokephysai_tpu_torch.physics import multigrid3d, solver3d
    from smokephysai_tpu_torch.utils.config import load_config

    config = load_config(VOL_CONFIG)
    sim = config["simulation"]
    dt, visc = sim["dt"], sim["viscosity"]
    grid = tuple(config["data"]["grid_size"])
    iters = 30  # step3d's num_cg_iters
    cycles = max(1, iters // 15)
    d, h, w = grid
    state = solver3d.init_state3d(grid, device=dev, batch=(1,))
    state = state.replace(density=solver3d.add_smoke_source3d(
        state.density, w / 2, h / 2, d / 4, radius=12.0, intensity=1.5))
    for _ in range(MG_WARM_STEPS):
        state = solver3d.step3d(state, dt, visc, num_cg_iters=iters, use_pallas=True)
    div = solver3d.divergence3d(state, dt).contiguous()
    p0 = state.p.contiguous()

    def residual(p):
        return float(torch.linalg.vector_norm(cg_ops.laplacian_dirichlet(p) - div))

    reset_counts()
    p_cg = cg_ops.cg_pressure(p0, div, iters)
    p_mg = multigrid3d.mg_pressure(p0, div, cycles)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("mg phase: one CG solve and one mg solve", counts, cg_pressure=1)
    r0, r_cg, r_mg = residual(p0), residual(p_cg), residual(p_mg)
    say(f"mg: {d}x{h}x{w} warm-started system after {MG_WARM_STEPS} steps: residual "
        f"||b + Lap p|| from p0 {r0:.6e}, CG kernel x{iters} {r_cg:.6e}, {cycles} V-cycles "
        f"{r_mg:.6e} (ratio {r_mg / r_cg:.4f}, bound {MG_CG_RATIO}; levels "
        f"{multigrid3d.num_levels(grid)})")
    if not r_mg <= MG_CG_RATIO * r_cg:
        fail("2 V-cycles do not reach the CG kernel's residual at 128^3")
    cpu = multigrid3d.mg_pressure(p0.cpu(), div.cpu(), cycles)
    cpu_err = maxerr(p_mg.cpu(), cpu) / float(cpu.abs().max())
    say(f"mg: the V-cycles on the card vs on the CPU: max|d| / max|p| {cpu_err:.3e} "
        f"(bound {MG_CPU_REL:g})")
    if not cpu_err <= MG_CPU_REL:
        fail("mg on the card disagrees with mg on the CPU")
    reset_counts()
    s_mg = solver3d.step3d(state, dt, visc, num_cg_iters=iters, pressure_solver="mg")
    torch.cuda.synchronize()
    step_counts = read_counts()
    expect_counts("mg step", step_counts)
    if not all(torch.isfinite(getattr(s_mg, f)).all() for f in ("u", "v", "w", "p", "density")):
        fail("non-finite mg step")
    ms = in_turns({
        "mg": lambda: solver3d.step3d(state, dt, visc, num_cg_iters=iters,
                                      pressure_solver="mg"),
        "cg": lambda: solver3d.step3d(state, dt, visc, num_cg_iters=iters, use_pallas=True),
        "mg solve": lambda: multigrid3d.mg_pressure(p0, div, cycles)}, rounds=2)
    say(f"time volumetric step {grid} x1 on {name}, in turns: pressure_solver='mg' "
        f"{ms['mg']:.4f} ms ({cycles} V-cycles, 0 kernel launches), CG kernel "
        f"{ms['cg']:.4f} ms (1 launch); the {cycles} V-cycles alone {ms['mg solve']:.4f} ms")
    return {"r_cg": r_cg, "r_mg": r_mg, "cpu_err": cpu_err, "ms": ms}


def bridge_phase(dev, name):
    """The reference PyTorch model's state_dict (drawn by
    `models/torch_port.synth_torch_state` from the golden's recorded keys,
    shapes and seed) converted by the port's bridge and served on the card
    through `train/serving.build_model` at config.yaml's full width (float32
    einsum, TF32 off): its eval forward on the golden's input and chaos
    fields against the reference's recorded outputs (BRIDGE_ATOL,
    BRIDGE_FEATURE_ATOL); the export back to the reference's keys bit-equal
    to the state it came from."""
    import numpy as np
    import torch

    from smokephysai_tpu_torch.models import torch_port
    from smokephysai_tpu_torch.train.serving import build_model
    from smokephysai_tpu_torch.utils.config import load_config

    with np.load(BRIDGE_GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    keys_shapes = {k: tuple(v) for k, v in json.loads(bytes(g["keys_shapes"]).decode()).items()}
    state = torch_port.synth_torch_state(keys_shapes, seed=int(g["seed"]))
    model = build_model(load_config(GATE_CONFIG), dev)
    model.load_state_dict(torch_port.convert_torch_state_dict(state), strict=True)
    x = torch.from_numpy(g["input"]).permute(0, 2, 3, 1).contiguous().to(dev)
    fields = [torch.from_numpy(f_).to(dev) for f_ in g["chaos_fields"]]
    reset_counts()
    with torch.inference_mode():
        out = model(x, chaos_fields=fields, return_features=True)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("bridged reference model, float32 einsum forward", counts)
    errs = {"reconstructed": maxerr(out["reconstructed"].permute(0, 3, 1, 2),
                                    torch.from_numpy(g["reconstructed"]).to(dev))}
    for key in ("physics_features", "latent_features", "intermediate_features"):
        errs[key] = maxerr(out[key], torch.from_numpy(g[key]).to(dev))
    exported = torch_port.export_torch_state_dict(model.state_dict())
    same = sorted(exported) == sorted(k for k in state if k in exported) and all(
        np.array_equal(v, state[k]) for k, v in exported.items())
    say(f"bridge: the reference state ({len(state)} keys, seed {int(g['seed'])}) served on "
        f"{name} at full width (float32 einsum, TF32 off) against its recorded forward: "
        f"max|d| {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (bounds "
        f"{BRIDGE_ATOL:g}, token features {BRIDGE_FEATURE_ATOL:g}); export bit-equal {same}")
    if not (max(errs[k] for k in ("reconstructed", "physics_features", "latent_features"))
            <= BRIDGE_ATOL and errs["intermediate_features"] <= BRIDGE_FEATURE_ATOL and same):
        fail("the bridged reference model disagrees with the reference's recorded forward")
    del model, out
    return {"errs": errs}


def gate_phase(dev):
    """The quality path through the port's benchmark and evaluate entry
    points at full width: the 128^2 and 256^2 50-sample gates on the JAX
    CLI's recorded draws (and the 128^2 one with the port's own streams),
    the five-section evaluation report, and the volumetric branches at 2
    volumes of 128^3. Each run's kernel launches are counted and checked."""
    import torch

    from smokephysai_tpu_torch import benchmark as bench
    from smokephysai_tpu_torch import evaluate as evaluate_cli
    from smokephysai_tpu_torch.train.serving import load_model, make_predictor
    from smokephysai_tpu_torch.utils.config import load_config

    t_phase = time.time()
    results = {}

    def numbers(tree):
        for v in tree.values():
            yield from numbers(v) if isinstance(v, dict) else [float(v)]

    def gate(label, config, checkpoint, draws, own=False):
        """evaluate_model over the held-out batches; `draws` the recorded
        JAX draws or None (the port's own streams)."""
        seed = config["tpu"]["seed"]
        samples = bench.read_samples(draws, config, GATE_SAMPLES) if draws else None
        model = load_model(config, checkpoint, dev)
        reset_counts()
        t = time.time()
        batches = bench.held_out_batches(config, GATE_SAMPLES, samples, dev)
        predict = make_predictor(model, chaos_seed=seed,
                                 chaos_traj=samples["chaos_traj"] if samples else None)
        res = bench.evaluate_model(predict, batches())
        torch.cuda.synchronize()
        counts = read_counts()
        say(f"gate {label}: {GATE_SAMPLES} samples, MSE {res['mse']:.6f}, physics "
            f"correlation {res['physics_correlation']:.4f}, "
            f"{res['inference_time'] * 1e3:.3f} ms per sample (batch "
            f"{bench.BATCH_SIZE}, timed to the card's completion), "
            f"{time.time() - t:.2f} s with the episodes; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not all(math.isfinite(res[k]) for k in ("mse", "physics_correlation")):
            fail(f"gate {label}: non-finite results {res}")
        out = {"result": res, "counts": counts}
        if own:
            own_predict = make_predictor(model, chaos_seed=seed)
            own_res = bench.evaluate_model(own_predict, batches())
            say(f"gate {label}, the same episodes under the port's own chaos stream: MSE "
                f"{own_res['mse']:.6f}, physics correlation "
                f"{own_res['physics_correlation']:.4f}")
            out["own_chaos"] = own_res
        return out

    # a. the 128^2 gate: float32 einsum, the numerics behind PARITY.md's figures
    config = load_config(GATE_CONFIG)
    g128 = gate("128^2 (config.yaml, smokephysnet_128_best.npz, the JAX CLI's draws)",
                config, CHECKPOINT, GATE_DRAWS, own=True)
    expect_counts("gate 128^2", g128["counts"], fused_multi_step=1)
    mse = g128["result"]["mse"]
    say(f"gate 128^2: MSE {mse:.6f} against PARITY.md's {PARITY_GATE_MSE} (the JAX CLI "
        f"on a TPU; gap {100 * (mse - PARITY_GATE_MSE) / PARITY_GATE_MSE:+.2f} %), "
        f"bound {GATE_MSE}")
    if not mse <= GATE_MSE:
        fail(f"the 128^2 gate fails: MSE {mse:.6f} > {GATE_MSE}")
    default = gate("128^2, the CLI's default (the port's own sources, frames and chaos "
                   "stream)", config, CHECKPOINT, None)
    expect_counts("gate 128^2 default", default["counts"], fused_multi_step=1)
    results["gate_128"] = g128
    results["gate_128_default"] = default

    # b. the 256^2 vorticity gate: the per-op step, Jacobi and diffusion kernels
    vconfig = load_config(VORT_CONFIG)
    g256 = gate("256^2 vorticity (config_256_vorticity.yaml, smokephysnet_256_vort_best.npz, "
                "the JAX CLI's draws)", vconfig, VORT_CHECKPOINT, VORT_GATE_DRAWS)
    steps = vconfig["data"]["sequence_length"]
    expect_counts("gate 256^2", g256["counts"], jacobi_pressure=steps, diffuse=steps)
    vmse, vcorr = g256["result"]["mse"], g256["result"]["physics_correlation"]
    gap = (vmse - PARITY_VORT_MSE) / PARITY_VORT_MSE
    say(f"gate 256^2: MSE {vmse:.6f}, correlation {vcorr:.4f} against PARITY.md's "
        f"{PARITY_VORT_MSE} / {PARITY_VORT_CORR} (gap {100 * gap:+.2f} %"
        f"{'; over 10 %: see PERF.md' if abs(gap) > VORT_GAP else ''}), bound {GATE_MSE}")
    if not vmse <= GATE_MSE:
        fail(f"the 256^2 gate fails: MSE {vmse:.6f} > {GATE_MSE}")
    results["gate_256"] = g256

    # c. the evaluation report: five sections, launches and seconds per section
    sections = {}
    mark = {"stage": None, "t": time.time()}

    def progress(stage):
        torch.cuda.synchronize()
        if mark["stage"] is not None:
            sections[mark["stage"]] = (time.time() - mark["t"],
                                       {k: v for k, v in read_counts().items() if v})
        reset_counts()
        mark.update(stage=stage, t=time.time())

    t = time.time()
    report = evaluate_cli.run_evaluation(config, CHECKPOINT, GATE_SAMPLES, EVAL_PHYSICS_TESTS,
                                         device=dev, progress=progress)
    say(f"evaluate (config.yaml, smokephysnet_128_best.npz, {GATE_SAMPLES} samples, "
        f"{EVAL_PHYSICS_TESTS} scenarios) in {time.time() - t:.2f} s: {json.dumps(report)}")
    for stage, (secs, counts) in sections.items():
        say(f"  evaluate {stage}: {secs:.3f} s, launches {counts}")
    if set(report) != set(evaluate_cli.SECTIONS):
        fail(f"the evaluation report lacks sections: {sorted(report)}")
    if not all(math.isfinite(x) for x in numbers(report)):
        fail("the evaluation report holds a NaN or an infinity")
    if sections["generate episodes"][1] != {"fused_multi_step": 1} or any(
            c for stage, (_, c) in sections.items() if stage != "generate episodes"):
        fail(f"evaluate launched other kernels than one multi-step for its episodes: {sections}")
    results["evaluate"] = {"report": report, "sections": sections}

    # e. PGD under --set tpu.use_flash=true: the forward-with-logsumexp and
    # backward kernels (float32) under autograd, the lean kernel for the
    # two inference-mode forwards
    flash_config = json.loads(json.dumps(config))
    flash_config["tpu"]["use_flash"] = True
    sections.clear()
    mark["stage"] = None
    t = time.time()
    flash_report = evaluate_cli.run_evaluation(flash_config, CHECKPOINT, FLASH_PGD_SAMPLES,
                                               sections={"adversarial"}, device=dev,
                                               progress=progress)
    layers = config["model"]["num_layers"]
    counts = sections["adversarial"][1]
    say(f"evaluate adversarial under tpu.use_flash=true, {FLASH_PGD_SAMPLES} samples, in "
        f"{time.time() - t:.2f} s (PGD {sections['adversarial'][0]:.3f} s): "
        f"{json.dumps(flash_report)} (einsum's at {GATE_SAMPLES} samples: "
        f"{json.dumps(report['adversarial'])}); launches {counts}")
    pgd_steps = 10  # adversarial_test's default
    if counts != {"flash_attention_tokens": 2 * layers,
                  "flash_attention_tokens_fwd_lse": pgd_steps * layers,
                  "flash_attention_tokens_bwd": pgd_steps * layers}:
        fail(f"PGD under use_flash launched {counts}")
    if not all(math.isfinite(x) for x in numbers(flash_report)):
        fail("the use_flash PGD report holds a NaN or an infinity")
    results["flash_pgd"] = {"counts": counts, "seconds": sections["adversarial"][0]}

    # d. the volumetric branches at 2 volumes of 128^3
    vol = load_config(VOL_CONFIG)
    vol_model = load_model(vol, VOL_CHECKPOINT, dev)
    reset_counts()
    t = time.time()
    batches = bench.held_out_batches(vol, GATE_VOLUMES, None, dev)
    row = bench.evaluate_model(make_predictor(vol_model, chaos_seed=vol["tpu"]["seed"]),
                               batches())
    cv = bench.evaluate_traditional_cv3d(batches())
    counts = read_counts()
    solves = GATE_VOLUMES * vol["data"]["sequence_length"]
    say(f"benchmark 128^3 ({GATE_VOLUMES} volumes, batch 1) in {time.time() - t:.2f} s: "
        f"model MSE {row['mse']:.6f}, correlation {row['physics_correlation']:.4f}, "
        f"{row['inference_time'] * 1e3:.3f} ms per volume; baselines {cv} (cv2 "
        f"{'present' if bench.have_cv2() else 'absent: persistence only'}); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    expect_counts("benchmark 128^3", counts, cg_pressure=solves)
    del vol_model
    reset_counts()
    t = time.time()
    vreport = evaluate_cli.run_evaluation(vol, VOL_CHECKPOINT, GATE_VOLUMES, device=dev,
                                          sections={"physics_consistency", "reconstruction"})
    counts = read_counts()
    say(f"evaluate 128^3 ({GATE_VOLUMES} volumes) in {time.time() - t:.2f} s: "
        f"{json.dumps(vreport)}; launches { {k: v for k, v in counts.items() if v} }")
    expect_counts("evaluate 128^3", counts, cg_pressure=solves)
    if not (math.isfinite(row["mse"]) and all(math.isfinite(x) for x in numbers(vreport))
            and math.isfinite(cv["Persistence"]["mse"])):
        fail("non-finite volumetric benchmark or report")
    results["volumetric"] = {"row": row, "baselines": cv, "report": vreport}
    say(f"gate phase: {time.time() - t_phase:.1f} s")
    return results


def timed_train_steps(trainer, next_batch, label, name):
    """The median of TIMED_STEPS train steps after WARM_STEPS (CUDA events)
    and their peak memory, with TF32 off (this script's setting) and then
    with cuDNN's TF32 on (PyTorch's default for convolutions); fails on a
    kernel launch (the float32 einsum steps timed here launch none) or a
    non-finite loss. Returns {tag: (median ms, peak GiB)}."""
    import torch

    result = {}
    for tag, tf32 in (("no TF32", False), ("cuDNN TF32 (PyTorch's default)", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            for _ in range(WARM_STEPS):
                trainer.train_step(next_batch())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            ms = []
            for _ in range(TIMED_STEPS):
                batch = next_batch()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                m = trainer.train_step(batch)
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
                if not math.isfinite(float(m["total_loss"])):
                    fail(f"non-finite loss in the {label} train step")
            counts = read_counts()
        finally:
            torch.backends.cudnn.allow_tf32 = False
        expect_counts(f"{label} train step", counts)
        result[tag] = (statistics.median(ms), torch.cuda.max_memory_allocated() / 2 ** 30)
        say(f"time train step ({label}, {tag}) on {name}: median {result[tag][0]:.3f} ms of "
            f"{TIMED_STEPS} after {WARM_STEPS} warm-up (CUDA events; "
            f"{[round(x, 2) for x in ms]}), peak memory {result[tag][1]:.2f} GiB")
    return result


def f32_train_step(train_ds, dev, name):
    """config_twophase_f32.yaml's train step (float32 einsum, batch 8, full
    width) on the dataset phase's episodes, timed by `timed_train_steps`."""
    import torch

    from smokephysai_tpu_torch.train import loop
    from smokephysai_tpu_torch.utils.config import load_config

    config = load_config(F32_CONFIG)
    bs, seed = config["training"]["batch_size"], config["tpu"]["seed"]
    model = loop.build_train_model(config, dev)
    loop.init_parameters(model, torch.Generator(dev).manual_seed(seed))
    trainer = loop.Trainer(model, config, len(train_ds) // bs,
                           torch.Generator(dev).manual_seed(seed))
    data_gen = torch.Generator().manual_seed(seed)

    def batches():
        while True:
            yield from train_ds.epoch_batches(data_gen, bs, shuffle=True)

    it = batches()
    result = timed_train_steps(trainer, lambda: next(it),
                               f"config_twophase_f32: float32 einsum, B={bs}, full width",
                               name)
    del trainer, model
    return result


def polish_f32_phase(train_ds, dev, name):
    """config_polish_f32.yaml's train step (float32, use_flash, batch 8, full
    width: the float32 flash kernels at [8,1024,512], 8 heads of 64) on the
    dataset phase's episodes. One step from the same weights, batch, chaos
    fields and dropout stream on the fused route (6 forward-with-logsumexp
    and 6 fused backward launches) and on the split route (6 dq and 6 dk/dv)
    held against the same step with use_flash off (float32 einsum, no
    launch): loss, gradient norm and each q, k, v projection's gradient.
    Then the flash step and that einsum step in turns, WARM_STEPS of each
    and then TIMED_STEPS (CUDA events, TF32 off), the medians and each one's
    peak memory."""
    import copy

    import torch

    from smokephysai_tpu_torch.train import loop
    from smokephysai_tpu_torch.utils.config import load_config

    config = load_config(POLISH_CONFIG)
    if not (config["tpu"]["use_flash"] and config["tpu"]["train_compute_dtype"] == "float32"):
        fail("config_polish_f32.yaml no longer trains in float32 with use_flash")
    bs, seed = config["training"]["batch_size"], config["tpu"]["seed"]
    layers = config["model"]["num_layers"]
    einsum_config = copy.deepcopy(config)
    einsum_config["tpu"]["use_flash"] = False
    data_gen = torch.Generator().manual_seed(seed)

    def batches():
        while True:
            yield from train_ds.epoch_batches(data_gen, bs, shuffle=True)

    it = batches()
    model = loop.init_parameters(loop.build_train_model(config, dev),
                                 torch.Generator(dev).manual_seed(seed))
    state = copy.deepcopy(model.state_dict())
    batch = next(it)
    fields = model.chaos_fields(torch.Generator(dev).manual_seed(7), bs, dev)
    trainers, runs = {}, {}
    for mode in ("einsum", "flash", "flash, split backward"):
        cfg = einsum_config if mode == "einsum" else config
        twin = loop.build_train_model(cfg, dev)
        twin.load_state_dict(state)
        tw = loop.Trainer(twin, cfg, len(train_ds) // bs, torch.Generator(dev).manual_seed(1))
        reset_counts()
        with split_backward() if "split" in mode else contextlib.nullcontext():
            m = tw.train_step(batch, chaos_fields=fields)
        torch.cuda.synchronize()
        # the clipped gradients the optimizer applied, back to their scale
        clip = min(1.0, 1.0 / float(m["grad_norm"]))
        proj = {n: p.grad / clip for n, p in twin.named_parameters()
                if n.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight"))}
        runs[mode] = (float(m["total_loss"]), float(m["grad_norm"]), read_counts(), proj)
        if "split" not in mode:
            trainers[mode] = tw
    el, en, ec, eg = runs["einsum"]
    expect_counts("config_polish_f32 train step, einsum", ec)
    want = {"flash": dict(flash_attention_tokens_fwd_lse=layers,
                          flash_attention_tokens_bwd=layers),
            "flash, split backward": dict(flash_attention_tokens_fwd_lse=layers,
                                          flash_attention_tokens_bwd_dq=layers,
                                          flash_attention_tokens_bwd_dkv=layers)}
    ok = True
    for mode, counts in want.items():
        expect_counts(f"config_polish_f32 train step, {mode}", runs[mode][2], **counts)
        fl, fn, fc, fg = runs[mode]
        loss_rel, norm_rel = abs(fl - el) / abs(el), abs(fn - en) / abs(en)
        rel = {n: rel_norm(fg[n], eg[n]) for n in eg}
        say(f"config_polish_f32 train step (float32, B={bs}, full width), {mode} vs einsum: "
            f"loss {fl:.6f} vs {el:.6f} (rel {loss_rel:.3e}, bound {TRAIN_LOSS_RTOL:g}), "
            f"gradient norm {fn:.5f} vs {en:.5f} (rel {norm_rel:.3e}, bound "
            f"{TRAIN_GRAD_NORM_RTOL:g}); q, k, v projection gradients ||d||/||ref|| "
            f"largest {max(rel.values()):.3e} (bound {TRAIN_F32_PROJ_GRAD_REL_NORM:g}); by "
            f"layer, q k v: {[float(f'{x:.3e}') for x in rel.values()]}; launches {fc}")
        ok &= (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_GRAD_NORM_RTOL
               and len(rel) == 3 * layers and max(rel.values()) <= TRAIN_F32_PROJ_GRAD_REL_NORM)
    if not ok:
        fail("the float32 flash train step disagrees with the einsum step")

    # the flash and einsum steps in turns
    ms, peak = {m_: [] for m_ in trainers}, dict.fromkeys(trainers, 0.0)
    for i in range(WARM_STEPS + TIMED_STEPS):
        for mode, tw in trainers.items():
            step_batch = next(it)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            m = tw.train_step(step_batch)
            b.record()
            b.synchronize()
            expect_counts(f"config_polish_f32 timed step, {mode}", read_counts(),
                          **want.get(mode, {}))
            if not math.isfinite(float(m["total_loss"])):
                fail(f"non-finite loss in the config_polish_f32 {mode} step")
            if i >= WARM_STEPS:
                ms[mode].append(a.elapsed_time(b))
                peak[mode] = max(peak[mode], torch.cuda.max_memory_allocated() / 2 ** 30)
    result = {m_: (statistics.median(v), peak[m_]) for m_, v in ms.items()}
    for mode, (med, gib) in result.items():
        say(f"time train step (config_polish_f32: float32, B={bs}, full width, {mode}; no "
            f"TF32) on {name}: median {med:.3f} ms of {TIMED_STEPS} after {WARM_STEPS} "
            f"warm-up, in turns with the other (CUDA events; "
            f"{[round(x, 2) for x in ms[mode]]}), peak memory {gib:.2f} GiB")
    del trainers, model
    return {"counts": runs["flash"][2], "split_counts": runs["flash, split backward"][2],
            "steps": result}


def streaming_phase(dev, name, smi_line, trace):
    """config_streaming_1024.yaml on smokephysnet_128_best.npz, uncut (1024^2,
    batch 1, STREAM_FRAMES frames as bench.py measures them), in three
    variants: the config (bf16 einsum), plus use_flash and fast_math, plus
    fast_encoder as well. Each variant's rollout through
    `train/streaming.streaming_rollout` is checked for its launches (one
    fused step a frame in the global mode, no Jacobi or diffusion launch,
    num_layers lean flash launches a frame under use_flash), its frames
    against a loop of the plain step, and its features and the mean token
    its physics head takes (and one frame's reconstruction) against the
    same frames through a float32 einsum model; then frames per second, the
    busy share of one traced frame of the rollout's step, the lean flash
    kernel at the frame's shape, and the stream CLI once."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from smokephysai_tpu_torch import stream as stream_cli
    from smokephysai_tpu_torch.models.convert import (
        jax_variables_to_state_dict,
        load_npz_variables,
    )
    from smokephysai_tpu_torch.ops import attention as attn_ops
    from smokephysai_tpu_torch.ops import fused_step as step_ops
    from smokephysai_tpu_torch.physics import solver
    from smokephysai_tpu_torch.physics.fractal import (
        apply_fractal_perturbation,
        fractal_field,
    )
    from smokephysai_tpu_torch.physics.simulator import FRACTAL_INTENSITY
    from smokephysai_tpu_torch.train.serving import build_model
    from smokephysai_tpu_torch.train.streaming import make_streaming_step, streaming_rollout
    from smokephysai_tpu_torch.utils.config import load_config

    t_phase = time.time()
    config = load_config(STREAM_CONFIG)
    sim, seed = config["simulation"], config["tpu"]["seed"]
    grid = tuple(sim["grid_size"])
    dt, visc, iters = sim["dt"], sim["viscosity"], sim["num_jacobi_iters"]
    layers, width = config["model"]["num_layers"], config["model"]["hidden_dim"]
    heads = config["model"]["num_heads"]
    T = STREAM_FRAMES

    def source_state():  # the stream CLI's source
        s = solver.init_state(grid, device=dev)
        return s.replace(density=solver.add_smoke_source(
            s.density, grid[1] / 2, grid[0] / 2, max(8.0, grid[0] / 32), 1.5))

    # the plain step's frames, and the float32 einsum model's features on them
    fractal = fractal_field(grid, device=dev)
    s, plain_frames = source_state(), []
    for _ in range(T):
        s = solver.SimState(*step_ops.fused_step_reference(
            s.u, s.v, s.p, s.density, dt, visc, iters, 1))
        plain_frames.append(apply_fractal_perturbation(s.density, FRACTAL_INTENSITY, fractal))
    plain_frames = torch.stack(plain_frames)
    plan = step_ops.launch_plan(1, *grid, 1, device=dev).describe()

    weights = jax_variables_to_state_dict(load_npz_variables(CHECKPOINT))  # read once

    def model_for(**tpu):  # what load_model gives for the config with `tpu` set
        cfg = copy.deepcopy(config)
        cfg["tpu"].update(tpu)
        model = build_model(cfg, dev)
        model.load_state_dict(weights, strict=True)
        return model

    refs = {}
    for fast_encoder in (False, True):
        m32 = model_for(compute_dtype="float32", use_flash=False, fast_math=False,
                        fast_encoder=fast_encoder)
        fields = m32.chaos_fields(torch.Generator().manual_seed(seed), 1, dev)
        with torch.inference_mode():
            outs32 = [m32(f[None, :, :, None], chaos_fields=fields) for f in plain_frames]
            refs[fast_encoder] = (
                torch.stack([o["physics_features"][0] for o in outs32]),
                outs32[-1]["reconstructed"],
                torch.stack([o["latent_features"][0] for o in outs32]))
            del outs32
        del m32

    results = {}
    for tag, opts in (("bf16 einsum", {}),
                      ("+ use_flash, fast_math", {"use_flash": True, "fast_math": True}),
                      ("+ fast_encoder", {"use_flash": True, "fast_math": True,
                                          "fast_encoder": True})):
        model = model_for(**opts)
        # the mean token each frame's physics head takes (after the encoder
        # and the trunk), read where the rollout hands it to phys1
        pooled = []
        hook = model.phys1.register_forward_hook(
            lambda mod, args, out: pooled.append(args[0][0].float()))
        reset_counts()
        t = time.time()
        final, outs = streaming_rollout(model, source_state(), T, dt, visc, iters,
                                        use_pallas=True, chaos_seed=seed)
        torch.cuda.synchronize()
        first_s = time.time() - t
        counts = read_counts()
        hook.remove()
        flash = opts.get("use_flash", False)
        expect_counts(f"streaming ({tag})", counts, fused_step=T,
                      flash_attention_tokens=layers * T if flash else 0)
        frames, feats = outs["frame"], outs["physics_features"]
        if tuple(frames.shape) != (T, *grid) or tuple(feats.shape) != (T, 3):
            fail(f"streaming ({tag}): shapes {tuple(frames.shape)}, {tuple(feats.shape)}")
        frame_err = maxerr(frames, plain_frames)
        ref_feats, ref_recon, ref_pooled = refs[opts.get("fast_encoder", False)]
        feat_err = maxerr(feats, ref_feats)
        if len(pooled) != T:
            fail(f"streaming ({tag}): the physics head ran {len(pooled)} times in {T} frames")
        pooled = torch.stack(pooled)
        pooled_err = maxerr(pooled, ref_pooled)
        pooled_bound = RECON_BF16_VS_F32 * max(1.0, float(ref_pooled.abs().max()))
        # one frame's whole forward (the decoder too) against float32
        step = make_streaming_step(model, dt, visc, iters, use_pallas=True, chaos_seed=seed)
        s_prev = source_state()
        for f in range(T - 1):  # the state before the last frame, by the kernel
            s_prev = solver.step(s_prev, dt, visc, iters, use_pallas=True)
        _, one = step(s_prev)
        recon_err = maxerr(one["reconstructed"], ref_recon[0, :, :, 0])
        say(f"streaming {grid[0]}^2 ({tag}): {T} frames, launches {counts}; frames vs "
            f"a loop of the plain step: max|d| {frame_err:.3e} (bound {FUSED_ATOL:g}, "
            f"bit-equal {torch.equal(frames, plain_frames)}); physics features vs the "
            f"float32 einsum model on the plain frames: max|d| {feat_err:.3e}, the last "
            f"frame's reconstruction {recon_err:.3e} (bound {RECON_BF16_VS_F32:g}), the "
            f"mean token into the physics head {pooled_err:.3e} (bound {pooled_bound:.3e}: "
            f"{RECON_BF16_VS_F32:g} of the float32 token's largest |x|, at least 1; "
            f"||d||/||ref|| {rel_norm(pooled, ref_pooled):.3e}); first rollout {first_s:.2f} "
            f"s (host clock)")
        if not (frame_err <= FUSED_ATOL and feat_err <= RECON_BF16_VS_F32
                and recon_err <= RECON_BF16_VS_F32 and pooled_err <= pooled_bound
                and torch.isfinite(feats).all()):
            fail(f"streaming ({tag}) disagrees with the plain step or the float32 model")
        walls = []
        for _ in range(STREAM_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            streaming_rollout(model, source_state(), T, dt, visc, iters, use_pallas=True,
                              chaos_seed=seed)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        fps = T / statistics.median(walls)
        # one frame of the rollout's own per-frame step (streaming_rollout
        # loops over it)
        fstate = [final]
        frame_step = make_streaming_step(model, dt, visc, iters, use_pallas=True,
                                         chaos_seed=seed, return_reconstruction=False)

        def one_frame():
            fstate[0], _ = frame_step(fstate[0])

        busy = profile(one_frame, 1, f"streaming frame {grid[0]}^2 ({tag})",
                       top=12 if trace else 6)
        results[tag] = {"fps": fps, "counts": counts, "frame_err": frame_err,
                        "busy": busy, "walls": walls}
        say(f"time streaming {grid[0]}^2 ({tag}) on {name} [{smi_line}]: {fps:.2f} frames "
            f"per second (median of {STREAM_RUNS} rollouts of {T} frames, host clock to the "
            f"card's completion: {[round(w * 1e3, 2) for w in walls]} ms); busy share of "
            f"one traced frame {busy:.3f}; fused step plan {plan}")
        del model, outs, frames, feats, final, fstate, step, frame_step, one, pooled

    # the lean flash kernel at the streaming frame's shape [1, 1024, width]
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 1024, width, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    qh, kh, vh = (x.view(1, 1024, heads, width // heads).transpose(1, 2) for x in (q, k, v))
    o = attn_ops.flash_attention_tokens(q, k, v, heads).float()
    r = attn_ops.flash_attention_tokens_reference(q, k, v, heads).float()
    lean_err = maxerr(o, r)
    lean_bound = FLASH_BF16_ULPS * bf16_ulp(float(r.abs().max()))
    if not lean_err <= lean_bound:
        fail("flash_attention_tokens at [1,1024,width] disagrees with its plain version")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lean = (timed(lambda: attn_ops.flash_attention_tokens(q, k, v, heads)),
            timed(lambda: attn_ops.flash_attention_tokens_reference(q, k, v, heads)),
            *lower_bound(4 * 1024 * width * 2, 4 * heads * 1024 * 1024 * (width // heads),
                         BF16_FLOPS),
            timed(lambda: sdpa(qh, kh, vh)))
    say(f"time flash_attention_tokens [1,1024,{width}] bf16 (the streaming frame) on {name}: "
        f"kernel {lean[0]:.4f} ms, plain {lean[1]:.4f} ms, SDPA {lean[4]:.4f} ms, bound "
        f"{lean[2]:.6f} ms ({lean[3]}); max|d| {lean_err:.3e} (bound {lean_bound:.3e})")
    del q, k, v, qh, kh, vh, o, r

    # the stream CLI once
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        summary = stream_cli.main(["--config", STREAM_CONFIG, "--checkpoint", CHECKPOINT,
                                   "--frames", str(T), "--output_dir", tmp])
        torch.cuda.synchronize()
        cli_counts = read_counts()
        feats = np.load(os.path.join(tmp, "physics_features.npy"))
        frames = np.load(os.path.join(tmp, "frames.npy"))
        with open(os.path.join(tmp, "summary.json")) as f:
            written = json.load(f)
    ds = grid[0] // 4
    ok = (feats.shape == (T, 3) and frames.shape == (T, ds, ds) and written == summary
          and np.isfinite(feats).all() and np.isfinite(frames).all()
          and np.array_equal(frames, plain_frames[:, ::4, ::4].cpu().numpy()))
    say(f"stream CLI: {T} frames at {grid[0]}^2: physics_features.npy {feats.shape}, "
        f"frames.npy {frames.shape} (the plain step's frames {ok}), summary.json {written}; "
        f"launches {cli_counts}")
    expect_counts("stream CLI", cli_counts, fused_step=T)
    if not ok:
        fail("the stream CLI's files are wrong")
    say(f"streaming phase: {time.time() - t_phase:.1f} s")
    return {"results": results, "lean": lean, "lean_err": lean_err,
            "frame_err": max(r_["frame_err"] for r_ in results.values())}


def volumetric_training_phase(dev, name):
    """`python -m smokephysai_tpu_torch.train --config config_128cubed.yaml`
    at full width cut to one epoch (its 32 + 8 episodes generated with the
    CG kernel, 32 steps at batch 1, the validation pass) in a scratch
    directory, its checkpoint served back through `load_model`; then, on a
    generated episode, the config's train step timed (and its peak memory)
    and traced, and one step with use_flash held against the einsum step on
    the fused and the split backward routes."""
    import contextlib
    import copy
    import tempfile

    import torch

    from smokephysai_tpu_torch.data.synthetic3d import SyntheticSmokeDataset3D
    from smokephysai_tpu_torch.train import loop
    from smokephysai_tpu_torch.train.__main__ import main as train_main
    from smokephysai_tpu_torch.train.serving import load_model, make_predictor
    from smokephysai_tpu_torch.utils.config import load_config

    t_phase = time.time()
    config = load_config(VOL_CONFIG)
    grid, T = tuple(config["data"]["grid_size"]), config["data"]["sequence_length"]
    seed, layers = config["tpu"]["seed"], config["model"]["num_layers"]
    if config["data"]["num_train"] + config["data"]["num_val"] != VOL_TRAIN_EPISODES:
        fail("config_128cubed.yaml no longer has 32 + 8 episodes")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t = time.time()
            exp_dir = os.path.join(tmp, train_main(
                ["--config", VOL_CONFIG, "--set", "training.num_epochs=1"]))
            torch.cuda.synchronize()
            cli_s = time.time() - t
            counts = read_counts()
        finally:
            os.chdir(cwd)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        say(f"volumetric training CLI: one epoch of config_128cubed.yaml ({VOL_TRAIN_EPISODES} "
            f"episodes at {grid}, T={T}, generated; {config['data']['num_train']} steps at "
            f"batch {config['training']['batch_size']}; the validation pass) in {cli_s:.1f} s "
            f"(host clock, generation and checkpoints included), peak memory {peak:.2f} GiB; "
            f"launches {counts}")
        expect_counts("volumetric training CLI", counts, cg_pressure=VOL_TRAIN_EPISODES * T)
        payload = torch.load(os.path.join(exp_dir, "last_model.pt"), map_location=dev,
                             weights_only=False)
        served = load_model(config, os.path.join(exp_dir, "last_model.npz"), dev)
    same = all(torch.equal(v, payload["model"][k]) for k, v in served.state_dict().items())
    if payload["step"] != config["data"]["num_train"] or not same:
        fail(f"the volumetric checkpoint does not serve back (step {payload['step']}, "
             f"weights equal {same})")
    del payload

    ds = SyntheticSmokeDataset3D(num_samples=1, grid_size=grid, sequence_length=T,
                                 seed=seed + 2, use_pallas=True, device=dev)
    batch = ds.get_batch(torch.tensor([0]), torch.tensor([T // 2]))
    reset_counts()
    out = make_predictor(served, chaos_seed=seed)(batch["input"])
    torch.cuda.synchronize()
    serve_counts = read_counts()
    finite = bool(torch.isfinite(out["reconstructed"]).all()
                  and torch.isfinite(out["physics_features"]).all())
    mse = float(((out["reconstructed"] - batch["target"]) ** 2).mean())
    say(f"volumetric training: last_model.npz served through load_model: weights equal "
        f"{same}, outputs finite {finite}, next-volume MSE {mse:.6e} after one epoch; "
        f"launches {serve_counts}")
    expect_counts("serving the trained volumetric checkpoint", serve_counts)
    if not finite:
        fail("the trained volumetric model gives non-finite outputs")
    del served, out

    # the config's step (float32 einsum), timed with its peak memory, and traced
    model = loop.init_parameters(loop.build_train_model(config, dev),
                                 torch.Generator(dev).manual_seed(seed))
    trainer = loop.Trainer(model, config, config["data"]["num_train"],
                           torch.Generator(dev).manual_seed(seed))
    steps = timed_train_steps(
        trainer, lambda: batch, f"config_128cubed: SmokePhysNet3D float32 einsum, B=1, "
        f"hidden {config['model']['hidden_dim']}, {layers} layers", name)
    busy = profile(lambda: trainer.train_step(batch), 1, "volumetric train step B=1",
                   top=8)

    # one step with use_flash (float32 kernels, head_dim 32) against einsum,
    # on the fused and the split backward routes
    state = copy.deepcopy(model.state_dict())
    fields = model.chaos_fields(torch.Generator(dev).manual_seed(7), 1, dev)
    runs = {}
    for mode in ("einsum", "flash", "flash, split backward"):
        cfg = copy.deepcopy(config)
        cfg["tpu"]["use_flash"] = mode != "einsum"
        twin = loop.build_train_model(cfg, dev)
        twin.load_state_dict(state)
        tw = loop.Trainer(twin, cfg, config["data"]["num_train"],
                          torch.Generator(dev).manual_seed(1))
        tw.step = trainer.step
        reset_counts()
        with split_backward() if "split" in mode else contextlib.nullcontext():
            m = tw.train_step(batch, chaos_fields=fields)
        torch.cuda.synchronize()
        runs[mode] = (float(m["total_loss"]), float(m["grad_norm"]), read_counts())
        del twin, tw
    el, en, ec = runs["einsum"]
    expect_counts("volumetric train step, einsum", ec)
    expect_counts("volumetric train step, flash", runs["flash"][2],
                  flash_attention_tokens_fwd_lse=layers, flash_attention_tokens_bwd=layers)
    expect_counts("volumetric train step, flash, split backward",
                  runs["flash, split backward"][2], flash_attention_tokens_fwd_lse=layers,
                  flash_attention_tokens_bwd_dq=layers, flash_attention_tokens_bwd_dkv=layers)
    ok = True
    for mode in ("flash", "flash, split backward"):
        fl, fn, fc = runs[mode]
        loss_rel, norm_rel = abs(fl - el) / abs(el), abs(fn - en) / abs(en)
        say(f"volumetric train step, {mode} vs einsum (float32): loss {fl:.6f} vs {el:.6f} "
            f"(rel {loss_rel:.3e}, bound {TRAIN_LOSS_RTOL:g}), gradient norm {fn:.5f} vs "
            f"{en:.5f} (rel {norm_rel:.3e}, bound {TRAIN_GRAD_NORM_RTOL:g}); launches {fc}")
        ok &= loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_GRAD_NORM_RTOL
    if not ok:
        fail("the volumetric train step with use_flash disagrees with einsum")
    say(f"volumetric training phase: {time.time() - t_phase:.1f} s")
    del trainer, model, ds, batch
    return {"cli_counts": counts, "steps": steps, "busy": busy,
            "flash_counts": runs["flash"][2], "split_counts": runs["flash, split backward"][2],
            "cli_s": cli_s}


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
    if os.environ.get("SMOKEPHYS_FUSED_BWD") == "0":
        fail("SMOKEPHYS_FUSED_BWD=0 is set: unset it; this script drives the default "
             "(fused) backward and sets the split one itself")
    import numpy as np

    from smokephysai_tpu_torch import inference
    from smokephysai_tpu_torch.ops import _build
    from smokephysai_tpu_torch.ops import attention as attn_ops
    from smokephysai_tpu_torch.ops import cg3d as cg_ops
    from smokephysai_tpu_torch.ops import fused_step as step_ops
    from smokephysai_tpu_torch.ops import jacobi as jacobi_ops
    from smokephysai_tpu_torch.ops import stencil as stencil_ops
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
                      (attn_ops.BWD_SOURCE, attn_ops.FLAGS),
                      (jacobi_ops.SOURCE, jacobi_ops.FLAGS),
                      (stencil_ops.SOURCE, stencil_ops.FLAGS),
                      (cg_ops.SOURCE, cg_ops.FLAGS)])
    build_s = time.time() - t
    say(f"build: six sources in {build_s:.2f} s (nvcc, sm_90a, one process each)")
    sass_lines = []
    for src in (attn_ops.SOURCE, attn_ops.BWD_SOURCE):
        lib = os.path.basename(_build.library_path(src, attn_ops.FLAGS))
        sass = sass_counts(_build.library_path(src, attn_ops.FLAGS),
                           ("HGMMA", "UTMALDG", TF32_MMA))
        sass_lines.append(f"sass {lib}: cuobjdump not in the toolkit" if sass is None else
                          f"sass {lib}: HGMMA {sass[0]}, UTMALDG {sass[1]}, {TF32_MMA} "
                          f"{sass[2]} (cuobjdump -sass)")
        if sass is not None and min(sass[:2]) == 0:
            fail(f"the flash kernels of {src} do not run on wgmma and TMA: {sass_lines[-1]}")
        if sass is not None and sass[2] == 0:
            fail(f"the float32 flash kernels of {src} do not run on the TF32 tensor cores: "
                 f"{sass_lines[-1]}")
    dq_lib = _build.library_path(attn_ops.BWD_SOURCE, attn_ops.FLAGS)
    dq_mma = sass_counts(dq_lib, (TF32_MMA,), function="flash_bwd_dq_f32_kernel")
    if dq_mma is not None:
        sass_lines.append(f"sass {os.path.basename(dq_lib)} flash_bwd_dq_f32_kernel: "
                          f"{TF32_MMA} {dq_mma[0]}")
        if dq_mma[0] == 0:
            fail(f"the float32 dq kernel does not run on the TF32 tensor cores: "
                 f"{sass_lines[-1]}")
    step_lib = _build.library_path(step_ops.SOURCE, step_ops.FLAGS)
    bars = sass_counts(step_lib, ("UCGABAR_ARV", "UCGABAR_WAIT"))
    sass_lines.append(f"sass {os.path.basename(step_lib)}: cuobjdump not in the toolkit"
                      if bars is None else
                      f"sass {os.path.basename(step_lib)}: UCGABAR_ARV {bars[0]}, "
                      f"UCGABAR_WAIT {bars[1]} (cluster barriers)")
    if bars is not None and min(bars) == 0:
        fail(f"the fused solver kernels have no cluster barrier: {sass_lines[-1]}")
    for src in (step_ops.SOURCE, cg_ops.SOURCE):
        log = _build.build_logs.get(src)
        if log is None:
            say(f"  {src}: built before this run, no ptxas log to read")
            continue
        regs = [line.split("Used")[1].split(",")[0].strip() for line in log.splitlines()
                if "registers" in line and "Used" in line]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 bytes spill stores, "
                                                                      "0 bytes spill loads")]
        say(f"ptxas {src}: {len(regs)} kernels, registers per thread "
            f"{sorted(set(regs))}; spills: {spills or 'none'}")
    sass_line = "; ".join(sass_lines)
    for src, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "serialized" in line:
                say(f"  {src}: {line.strip()}")
    for src in (attn_ops.SOURCE, attn_ops.BWD_SOURCE):
        for kname, use in f32_kernel_resources(_build.build_logs.get(src, "")):
            say(f"ptxas {src} {kname}: {use}")
            if not use.endswith("0 bytes spill stores, 0 bytes spill loads"):
                fail(f"ptxas spilled registers of the float32 flash kernel {kname}: {use}")
    serialised = [line.strip() for line in _build.build_logs.get(attn_ops.BWD_SOURCE, "")
                  .splitlines() if "wgmma.mma_async instructions are serialized" in line]
    if serialised:
        fail(f"ptxas serialised the wgmma of a bf16 backward kernel: {serialised[0]}")
    if attn_ops.BWD_SOURCE not in _build.build_logs:
        say(f"  {attn_ops.BWD_SOURCE}: built before this run, no ptxas log to read")

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

    say(f"  plan: {step_ops.launch_plan(1, *grid, 1, device=dev).describe()}")
    far_errs = {}
    for size, max_disp in ((grid[0], 2), (grid[0], 3), (BIG_GRID, 3)):
        far = smoke_state(dev, 1, size, seed=max_disp, shear=SHEAR)
        plan = step_ops.launch_plan(1, size, size, max_disp, device=dev)
        near_ref = step_ops.fused_step_reference(*far, FAST_DT, visc, iters, max_disp - 1)
        pout = step_ops.fused_step_reference(*far, FAST_DT, visc, iters, max_disp)
        kout = step_ops.fused_step(*far, FAST_DT, visc, iters, max_disp)
        torch.cuda.synchronize()
        weight = max(maxerr(a, b) for a, b in zip(near_ref, pout))
        err = max(maxerr(a, b) for a, b in zip(kout, pout))
        far_errs[(size, max_disp)] = err
        say(f"kernel fused_step {size}^2 x1 max_disp {max_disp} "
            f"({'compiled' if max_disp <= 2 else 'runtime'} tap radius), dt {FAST_DT:g}, "
            f"shear {SHEAR:g}: max|d| {err:.3e} (bound {FUSED_ATOL:g}); the plain step at "
            f"max_disp {max_disp - 1} differs by {weight:.3f} (must exceed "
            f"{FAR_TAPS_DIFF:g}); plan: {plan.describe()}")
        if not weight > FAR_TAPS_DIFF:
            fail(f"the far-tap check at {size}^2 max_disp {max_disp} gives the outermost "
                 f"taps no weight")
        if plan.cluster < 2:
            fail(f"the far-tap check at {size}^2 runs on one CTA: no tap crosses a stripe")
        if not err <= FUSED_ATOL:
            fail(f"fused_step at {size}^2 max_disp {max_disp} disagrees with its plain version")
    err3 = max(far_errs.values())
    big = smoke_state(dev, 1, BIG_GRID)
    kout = step_ops.fused_step(*big, dt, visc, iters, 1)
    pout = step_ops.fused_step_reference(*big, dt, visc, iters, 1)
    torch.cuda.synchronize()
    err_big = max(maxerr(a, b) for a, b in zip(kout, pout))
    say(f"kernel fused_step {BIG_GRID}^2 x1: max|d| {err_big:.3e} (bound {FUSED_ATOL:g}); "
        f"plan: {step_ops.launch_plan(1, BIG_GRID, BIG_GRID, 1, device=dev).describe()}")
    if not err_big <= FUSED_ATOL:
        fail(f"fused_step at {BIG_GRID}^2 disagrees with its plain version")
    del kout, pout, near_ref, far, big
    fused_err = max(fused_err, err3, err_big)

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
    bwd_errs, split_errs = {}, {}
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
        split_errs[tag] = split_check(
            attn_ops, (qd, kd, vd, od, lsed, gd), heads,
            f"B={train_batch} L=1024 D={width} H={heads} {tag}", rel_bound, kg)
        del qd, kd, vd, gd, od, lsed, kg, pg
    del q, k, v, g, o, lse, ro, rlse
    # the float32 kernels at the float32 train step's shape (config_polish_f32
    # and the PGD report under use_flash: 8 heads of 64)
    t = time.time()
    q, k, v, g = (torch.randn(train_batch, 1024, width, generator=gen).to(dev)
                  for _ in range(4))
    f32_errs = flash_check(attn_ops, q, k, v, g, heads,
                           f"[{train_batch},1024,{width}] f32 head_dim {width // heads}")
    del q, k, v, g
    say(f"float32 flash checks at [{train_batch},1024,{width}]: {time.time() - t:.1f} s")
    hm_counts, hm_err = head_major_check(attn_ops, dev, gen, train_batch, heads,
                                         width // heads)
    extra_lean_err, extra_lse_err = forward_extra_checks(attn_ops, dev, gen)
    for kname, err in backward_extra_checks(attn_ops, dev, gen).items():
        if kname == "flash_attention_tokens_bwd":
            bwd_errs["bfloat16"] = max(bwd_errs["bfloat16"], err)
        else:
            split_errs["bfloat16"][kname] = max(split_errs["bfloat16"][kname], err)
    flash_errs[("extra", "bfloat16")] = extra_lean_err
    lse_out_err = max(lse_out_err, extra_lse_err)

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

    reset_counts()
    t = time.time()
    sequence = inference.generate_test_sequence(simulator, 20)
    inputs = torch.stack(sequence[:-1])[..., None]
    outputs = predict(inputs)
    torch.cuda.synchronize()
    slice_s = time.time() - t
    launches = read_counts()
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
    train_config, train_ds, val_ds, data_info = dataset_phase(dev)

    # ---------------------------------------------------------------- training
    trainer, train_batches, train_info = training_phase(
        train_config, train_ds, val_ds, dev)
    f32_train_step(train_ds, dev, name)
    t = time.time()
    polish = polish_f32_phase(train_ds, dev, name)
    say(f"config_polish_f32 phase: {time.time() - t:.1f} s")

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
        dev_ms = device_ms(lambda: step_ops.fused_step(*f, dt, visc, iters, 1))
        plain_ms = timed(lambda: step_ops.fused_step_reference(*f, dt, visc, iters, 1))
        bound, by = step_bound(episodes_n)
        timings[("fused_step", episodes_n)] = (ms, plain_ms, bound, by)
        say(f"time fused_step 128^2 x{episodes_n} on {name}: kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by}); plan: "
            f"{step_ops.launch_plan(episodes_n, *grid, 1, device=dev).describe()}")
    big = smoke_state(dev, 1, BIG_GRID)
    ms = timed(lambda: step_ops.fused_step(*big, dt, visc, iters, 1))
    plain_ms = timed(lambda: step_ops.fused_step_reference(*big, dt, visc, iters, 1), runs=5)
    bound, by = lower_bound(2 * step_bytes(BIG_GRID, BIG_GRID),
                            step_flops(BIG_GRID, BIG_GRID, iters), F32_FLOPS)
    timings[("fused_step", BIG_GRID)] = (ms, plain_ms, bound, by)
    say(f"time fused_step {BIG_GRID}^2 x1 on {name}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by}); plan: "
        f"{step_ops.launch_plan(1, BIG_GRID, BIG_GRID, 1, device=dev).describe()}")
    del big

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
        fl = 4 * batch * heads * 1024 * 1024 * (width // heads)
        say(f"time flash_attention_tokens B={batch} L=1024 D={width} H={heads} bf16 "
            f"on {name}: kernel {ms:.4f} ms ({flash_rate(fl, ms, bound)}), plain "
            f"{plain_ms:.4f} ms, SDPA {library[batch]:.4f} ms "
            f"({flash_rate(fl, library[batch], bound)}), bound {bound:.4f} ms ({by})")
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
        f"plain {plain_ms:.4f} ms, bound {mb[0]:.6f} ms ({mb[1]}); plan: "
        f"{step_ops.launch_plan(64, *tgrid, 1, multi=True, device=dev).describe()}; "
        f"whole 64-episode "
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
    fl = 4 * tb * heads * 1024 * 1024 * hd
    say(f"time flash_attention_tokens_fwd_lse B={tb} L=1024 D={width} H={heads} bf16 "
        f"on {name}: kernel {ms:.4f} ms ({flash_rate(fl, ms, fb[0])}), plain "
        f"{plain_ms:.4f} ms, SDPA forward (inputs need grad) {lib_ms:.4f} ms "
        f"({flash_rate(fl, lib_ms, fb[0])}), bound {fb[0]:.4f} ms ({fb[1]})")
    # the backward: the fused route (delta, dq zeroing, kernel, cast), the
    # split pair's kernels each alone on one precomputed delta, and SDPA's
    # backward, in turns, three rounds
    args = (q, k, v, o, lse, g, heads)
    delta = attn_ops._delta(o, g, heads)
    oh = sdpa(qh, kh, vh)
    turns = in_turns({
        "flash_attention_tokens_bwd":
            lambda: attn_ops.flash_attention_tokens_bwd(*args),
        "flash_attention_tokens_bwd_dq":
            lambda: attn_ops._launch_bwd_dq(q, k, v, g, lse, delta, heads, 1.0),
        "flash_attention_tokens_bwd_dkv":
            lambda: attn_ops._launch_bwd_dkv(q, k, v, g, lse, delta, heads, 1.0),
        "sdpa": lambda: torch.autograd.grad(oh, (qh, kh, vh), gh, retain_graph=True)})
    lib_ms = turns["sdpa"]
    plain_ms = timed(lambda: attn_ops.flash_attention_tokens_bwd_reference(*args), runs=5)
    bb = lower_bound(8 * tb * 1024 * width * 2 + tb * heads * 1024 * 4,
                     10 * tb * heads * 1024 * 1024 * hd, BF16_FLOPS)
    ms = turns["flash_attention_tokens_bwd"]
    timings["flash_attention_tokens_bwd"] = (ms, plain_ms, *bb, lib_ms)
    fl = 10 * tb * heads * 1024 * 1024 * hd
    say(f"time flash_attention_tokens_bwd B={tb} L=1024 D={width} H={heads} bf16 "
        f"on {name}: kernel {ms:.4f} ms (with the delta reduce, the dq buffer's "
        f"zeroing and its cast; {flash_rate(fl, ms, bb[0])}), plain {plain_ms:.4f} ms, "
        f"SDPA backward (autograd) {lib_ms:.4f} ms ({flash_rate(fl, lib_ms, bb[0])}), "
        f"bound {bb[0]:.4f} ms ({bb[1]}); medians of three rounds in turns")
    pair_flops = tb * heads * 1024 * 1024 * hd
    io, lse_bytes = tb * 1024 * width * 2, tb * heads * 1024 * 4
    for kname, ref, products, outs in (
            ("flash_attention_tokens_bwd_dq",
             attn_ops.flash_attention_tokens_bwd_dq_reference, 3, 1),
            ("flash_attention_tokens_bwd_dkv",
             attn_ops.flash_attention_tokens_bwd_dkv_reference, 4, 2)):
        ms = turns[kname]
        plain_ms = timed(lambda: ref(*args), runs=5)
        # q, k, v, dO, lse and delta read once, the gradients written once
        kb = lower_bound((4 + outs) * io + 2 * lse_bytes, 2 * products * pair_flops,
                         BF16_FLOPS)
        timings[kname] = (ms, plain_ms, *kb, lib_ms)
        say(f"time {kname} B={tb} L=1024 D={width} H={heads} bf16 on {name}: kernel "
            f"{ms:.4f} ms (delta given; {flash_rate(2 * products * pair_flops, ms, kb[0])}), "
            f"plain {plain_ms:.4f} ms, SDPA backward (autograd, all three gradients) "
            f"{lib_ms:.4f} ms, bound {kb[0]:.4f} ms ({kb[1]}); medians of three rounds "
            f"in turns")
    with split_backward():
        split_ms = timed(lambda: attn_ops.flash_attention_tokens_bwd(*args))
    say(f"time flash_attention_tokens_bwd under SMOKEPHYS_FUSED_BWD=0 (delta, dq kernel, "
        f"dk/dv kernel) B={tb} bf16 on {name}: {split_ms:.4f} ms, against the fused "
        f"{timings['flash_attention_tokens_bwd'][0]:.4f} ms and SDPA's backward "
        f"{lib_ms:.4f} ms")
    del q, k, v, g, o, lse, qh, kh, vh, gh, oh, args, delta
    # the head-major forward on SDPA's own layout
    qh, kh, vh = (torch.randn(tb, heads, 1024, hd, generator=gen).to(dev, torch.bfloat16)
                  for _ in range(3))
    ms = timed(lambda: attn_ops.flash_attention(qh, kh, vh))
    plain_ms = timed(lambda: attn_ops.flash_attention_reference(qh, kh, vh))
    lib_ms = timed(lambda: sdpa(qh, kh, vh))
    hb = lower_bound(4 * tb * heads * 1024 * hd * 2, 4 * tb * heads * 1024 * 1024 * hd,
                     BF16_FLOPS)
    timings["flash_attention"] = (ms, plain_ms, *hb, lib_ms)
    fl = 4 * tb * heads * 1024 * 1024 * hd
    say(f"time flash_attention [{tb},{heads},1024,{hd}] bf16 on {name}: kernel {ms:.4f} "
        f"ms ({flash_rate(fl, ms, hb[0])}), plain {plain_ms:.4f} ms, SDPA (same "
        f"head-major tensors) {lib_ms:.4f} ms ({flash_rate(fl, lib_ms, hb[0])}), bound "
        f"{hb[0]:.4f} ms ({hb[1]})")
    del qh, kh, vh
    # the float32 kernels at [8,1024,512] (config_polish_f32's step, the PGD
    # report under use_flash)
    t = time.time()
    f32_times = flash_timings(attn_ops, dev, gen, tb, 1024, width, heads, torch.float32, name)
    say(f"float32 flash timings at [{tb},1024,{width}]: {time.time() - t:.1f} s")
    # the lean one at the PGD report's batch
    t = time.time()
    pgd_lean_err, pgd_lean_times = lean_f32_check(attn_ops, dev, gen, GATE_SAMPLES, width,
                                                  heads, name)
    say(f"float32 lean check at [{GATE_SAMPLES},1024,{width}]: {time.time() - t:.1f} s")
    train_ms = statistics.median(train_info["step_ms"][1:])
    say(f"time train step B={tb} (config_train_fast: bf16, flash, fast_math, full "
        f"width) on {name}: {train_ms:.3f} ms (median of steps 2-{TRAIN_STEPS}, "
        f"CUDA events); in turns, fused backward {train_info['route_ms']['fused']:.3f} "
        f"ms, split backward {train_info['route_ms']['split']:.3f} ms (medians of "
        f"{ROUTE_STEPS} each)")

    if trace:
        profile(lambda: predict(frames), TRACE_RUNS, f"serving forward B={serve_batch}")
        profile(simulator.simulate_step, 20, "simulate_step 128^2")
        profile(lambda: trainer.train_step(next(train_batches)), 3,
                f"train step B={tb}")

    # ---------------------------------------------------------------- vorticity
    vort = vorticity_phase(dev, name, trace)

    # ---------------------------------------------------------------- 512^2 plume
    t = time.time()
    plume = plume_phase(dev, name)
    say(f"plume phase: {time.time() - t:.1f} s")

    # ---------------------------------------------------------------- volumetric
    vol = volumetric_phase(dev, name, trace)

    # ---------------------------------------------------------------- multigrid
    t = time.time()
    mg = mg_phase(dev, name)
    say(f"mg phase: {time.time() - t:.1f} s")

    # ---------------------------------------------------------------- quality gate
    gate = gate_phase(dev)

    # ---------------------------------------------------------------- reference bridge
    t = time.time()
    bridge_phase(dev, name)
    say(f"bridge phase: {time.time() - t:.1f} s")

    # ---------------------------------------------------------------- streaming
    stream = streaming_phase(dev, name, smi_line, trace)

    # ---------------------------------------------------------------- volumetric training
    vtrain = volumetric_training_phase(dev, name)

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
    for kname, line, launches_, err in (
            ("flash_attention_tokens_bwd_dq", 436,
             train_info["split_counts"]["flash_attention_tokens_bwd_dq"],
             split_errs["bfloat16"]["flash_attention_tokens_bwd_dq"]),
            ("flash_attention_tokens_bwd_dkv", 449,
             train_info["split_counts"]["flash_attention_tokens_bwd_dkv"],
             split_errs["bfloat16"]["flash_attention_tokens_bwd_dkv"]),
            ("flash_attention", 82, hm_counts["flash_attention"], hm_err)):
        t_ = timings[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "smokephysai_tpu_torch/csrc/" + (
                "flash_tokens.cu" if kname == "flash_attention" else "flash_bwd.cu"),
            "replaces": f"smokephysai_tpu/ops/pallas/attention.py:{line}",
            "launches": launches_,
            "max_abs_err": err,
            "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
            "library_ms": t_[4],
            "shape": (f"[{tb},{heads},1024,{hd}] bf16 head-major, one call (no model "
                      f"path calls it)" if kname == "flash_attention" else
                      f"[{tb},1024,{width}] bf16, {heads} heads of {hd}, per train step "
                      f"under SMOKEPHYS_FUSED_BWD=0"),
        })
    vgrid = "256x256"
    for kname, source, line, key, err, shape in (
            ("jacobi_pressure", "jacobi.cu", "jacobi.py:122", ("jacobi_pressure", 1, 256),
             vort["jacobi_err"], f"p, div [1,{vgrid}] f32, 20 sweeps"),
            ("diffuse", "stencil.cu", "stencil.py:35", ("diffuse_fields", 1),
             vort["diffuse_err"], f"u [1,257,256], v [1,256,257], density [1,{vgrid}] f32 "
             f"in one launch (diffuse_fields)")):
        t_ = vort["timings"][key]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"smokephysai_tpu_torch/csrc/{source}",
            "replaces": f"smokephysai_tpu/ops/pallas/{line}",
            "launches": vort["launches"][kname],
            "max_abs_err": err,
            "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
            "library_ms": None,
            "shape": shape,
        })
    t_ = vort["timings"][("jacobi_pressure", 1, vort["big_grid"][0])]
    kernels.append({
        "name": f"jacobi_pressure[band mode, per-op step {vort['big_grid'][0]}^2]",
        "route": "cuda",
        "source": "smokephysai_tpu_torch/csrc/jacobi.cu",
        "replaces": "smokephysai_tpu/ops/pallas/jacobi.py:149",
        "launches": vort["big_counts"]["jacobi_pressure"],
        "max_abs_err": vort["jacobi_err"],
        "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
        "library_ms": None,
        "shape": (f"p, div [1,{vort['big_grid'][0]},{vort['big_grid'][1]}] f32, 20 sweeps, "
                  f"one a vorticity step ({vort['big_plan']})"),
    })
    pg = plume["grid"]
    for kname, source, line, err, shape in (
            ("jacobi_pressure", "jacobi.cu", "jacobi.py:122", plume["jacobi_err"],
             f"p, div [{plume['episodes']},{pg[0]},{pg[1]}] f32, 20 sweeps ({plume['plan']})"),
            ("diffuse", "stencil.cu", "stencil.py:35", plume["diffuse_err"],
             f"u [{plume['episodes']},{pg[0] + 1},{pg[1]}], v [{plume['episodes']},{pg[0]},"
             f"{pg[1] + 1}], density [{plume['episodes']},{pg[0]},{pg[1]}] f32 in one launch")):
        t_ = plume["timings"][kname]
        kernels.append({
            "name": f"{kname}[512^2 plume chunk]",
            "route": "cuda",
            "source": f"smokephysai_tpu_torch/csrc/{source}",
            "replaces": f"smokephysai_tpu/ops/pallas/{line}",
            "launches": plume["counts"][kname],
            "max_abs_err": max(err, plume["err"]),
            "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
            "library_ms": None,
            "shape": f"{shape}; one a step of the {plume['steps']}-step chunk",
        })
    t_ = vol["timings"]["cg_pressure"]
    kernels.append({
        "name": "cg_pressure",
        "route": "cuda",
        "source": "smokephysai_tpu_torch/csrc/cg3d.cu",
        "replaces": "smokephysai_tpu/ops/pallas/cg3d.py:86",
        "launches": vol["gen_counts"]["cg_pressure"],
        "max_abs_err": vol["cg_err"],
        "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
        "library_ms": None,
        "shape": (f"p0, div [1,128,128,128] f32, 30 iterations ("
                  f"{cg_ops.launches_per_solve(30)} launch per solve, {vol['cg_plan']})"),
    })
    hd, vw, vh = vol["hd"], vol["width"], vol["heads"]
    for kname, source, line in (
            ("flash_attention_tokens", "flash_tokens.cu", 521),
            ("flash_attention_tokens_fwd_lse", "flash_tokens.cu", 315),
            ("flash_attention_tokens_bwd", "flash_bwd.cu", 366)):
        t_ = vol["timings"][(kname, "f32")]
        kernels.append({
            "name": f"{kname}[head_dim={hd}]",
            "route": "cuda",
            "source": f"smokephysai_tpu_torch/csrc/{source}",
            "replaces": f"smokephysai_tpu/ops/pallas/attention.py:{line}",
            "launches": vol["flash_counts"][kname],
            "max_abs_err": vol["flash_errs"]["f32"][kname],
            "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
            "library_ms": t_[4],
            "shape": f"[1,512,{vw}] f32, {vh} heads of {hd} (the volumetric trunk's "
                     f"serving forward and input gradient under use_flash)",
        })
    # this slice's paths: streaming at 1024^2 and volumetric training
    t_ = timings[("fused_step", BIG_GRID)]
    first = stream["results"]["bf16 einsum"]["counts"]
    flash_run = stream["results"]["+ use_flash, fast_math"]["counts"]
    kernels.append({
        "name": f"fused_step[streaming {BIG_GRID}^2]",
        "route": "cuda",
        "source": "smokephysai_tpu_torch/csrc/fused_step.cu",
        "replaces": "smokephysai_tpu/ops/pallas/fused_step.py:239",
        "launches": first["fused_step"],
        "max_abs_err": max(stream["frame_err"], err_big),
        "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
        "library_ms": None,
        "shape": (f"u({BIG_GRID + 1},{BIG_GRID}) v({BIG_GRID},{BIG_GRID + 1}) "
                  f"p,d({BIG_GRID},{BIG_GRID}) f32, 1 episode (global mode), one a frame "
                  f"of {STREAM_FRAMES}"),
    })
    t_ = stream["lean"]
    kernels.append({
        "name": "flash_attention_tokens[streaming]",
        "route": "cuda",
        "source": "smokephysai_tpu_torch/csrc/flash_tokens.cu",
        "replaces": "smokephysai_tpu/ops/pallas/attention.py:521",
        "launches": flash_run["flash_attention_tokens"],
        "max_abs_err": stream["lean_err"],
        "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
        "library_ms": t_[4],
        "shape": f"[1,1024,{width}] bf16, {heads} heads of 64, "
                 f"{flash_run['flash_attention_tokens'] // STREAM_FRAMES} a frame under use_flash",
    })
    t_ = vol["timings"]["cg_pressure"]
    kernels.append({
        "name": "cg_pressure[volumetric training]",
        "route": "cuda",
        "source": "smokephysai_tpu_torch/csrc/cg3d.cu",
        "replaces": "smokephysai_tpu/ops/pallas/cg3d.py:86",
        "launches": vtrain["cli_counts"]["cg_pressure"],
        "max_abs_err": vol["cg_err"],
        "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
        "library_ms": None,
        "shape": f"p0, div [1,128,128,128] f32, 30 iterations, 12 a generated episode of "
                 f"{VOL_TRAIN_EPISODES}",
    })
    for kname, source, line, counts_ in (
            ("flash_attention_tokens_fwd_lse", "flash_tokens.cu", 315, vtrain["flash_counts"]),
            ("flash_attention_tokens_bwd", "flash_bwd.cu", 366, vtrain["flash_counts"]),
            ("flash_attention_tokens_bwd_dq", "flash_bwd.cu", 436, vtrain["split_counts"]),
            ("flash_attention_tokens_bwd_dkv", "flash_bwd.cu", 449, vtrain["split_counts"])):
        t_ = vol["timings"][(kname, "f32")]
        kernels.append({
            "name": f"{kname}[head_dim={hd}, volumetric train step]",
            "route": "cuda",
            "source": f"smokephysai_tpu_torch/csrc/{source}",
            "replaces": f"smokephysai_tpu/ops/pallas/attention.py:{line}",
            "launches": counts_[kname],
            "max_abs_err": vol["flash_errs"]["f32"][kname],
            "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
            "library_ms": t_[4],
            "shape": f"[1,512,{vw}] f32, {vh} heads of {hd} (the train step under "
                     f"tpu.use_flash" + (", SMOKEPHYS_FUSED_BWD=0)" if "_d" in kname[-4:]
                                         else ")"),
        })
    # the float32 lean kernel at the PGD report's [50,1024,512] and the
    # float32 kernels of the config_polish_f32 train step at [8,1024,512]
    # (fused and split routes)
    t_ = pgd_lean_times
    kernels.append({
        "name": f"flash_attention_tokens[float32, head_dim={width // heads}]",
        "route": "cuda",
        "source": "smokephysai_tpu_torch/csrc/flash_tokens.cu",
        "replaces": "smokephysai_tpu/ops/pallas/attention.py:521",
        "launches": gate["flash_pgd"]["counts"]["flash_attention_tokens"],
        "max_abs_err": pgd_lean_err,
        "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
        "library_ms": t_[4],
        "shape": f"[{GATE_SAMPLES},1024,{width}] f32, {heads} heads of {width // heads} "
                 f"(the PGD report under use_flash)",
    })
    for kname, source, line, launches_, path in (
            ("flash_attention_tokens_fwd_lse", "flash_tokens.cu", 315,
             polish["counts"]["flash_attention_tokens_fwd_lse"], "a config_polish_f32 step"),
            ("flash_attention_tokens_bwd", "flash_bwd.cu", 366,
             polish["counts"]["flash_attention_tokens_bwd"], "a config_polish_f32 step"),
            ("flash_attention_tokens_bwd_dq", "flash_bwd.cu", 436,
             polish["split_counts"]["flash_attention_tokens_bwd_dq"],
             "a config_polish_f32 step under SMOKEPHYS_FUSED_BWD=0"),
            ("flash_attention_tokens_bwd_dkv", "flash_bwd.cu", 449,
             polish["split_counts"]["flash_attention_tokens_bwd_dkv"],
             "a config_polish_f32 step under SMOKEPHYS_FUSED_BWD=0")):
        t_ = f32_times[kname]
        kernels.append({
            "name": f"{kname}[float32, head_dim={width // heads}]",
            "route": "cuda",
            "source": f"smokephysai_tpu_torch/csrc/{source}",
            "replaces": f"smokephysai_tpu/ops/pallas/attention.py:{line}",
            "launches": launches_,
            "max_abs_err": f32_errs[kname],
            "ms": t_[0], "plain_ms": t_[1], "bound_ms": t_[2], "bound_by": t_[3],
            "library_ms": t_[4],
            "shape": f"[{tb},1024,{width}] f32, {heads} heads of {width // heads} ({path})",
        })
    say(f"wall: {time.time() - T0:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(sass_line)
    say(smi_line)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
