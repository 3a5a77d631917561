#!/usr/bin/env python3
"""Drive the PyTorch port (gan3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line:
1. device  — requires torch.cuda.is_available(); prints the nvidia-smi
             name and power limit;
2. build   — compiles csrc/pooled_attention.cu, conv3d_k3.cu,
             conv3d_toeplitz.cu and probe_ladder.cu with nvcc for sm_90a,
             one nvcc each, started together, and prints the kernels' ptxas
             lines (registers, spills), the registers and spills of each
             tensor-core kernel (the attention's bf16 and 3xTF32 ones) and
             of the ladder's wide_fwd, box_copy and im2col27 kernels, and
             fails if one of them spills (the attention kernels: at the
             instances the trainers run, c = 16, 32, 64 and 128);
3. kernels — runs the pooled-attention forward and backward kernels at the
             two shapes of the 64^3 BigGAN-Deep flagship (G: L=32768,
             M=4096, c=16; D: L=4096, M=512, c=32), the two of the 64^3
             DCGAN with --sagan (G: L=4096, M=512, c=16; D: L=512, M=64,
             c=32) and the two of the 128^3 BigGAN-Deep at filters 128 (G:
             L=32768, M=4096, c=64; D: L=4096, M=512, c=128), N=16, in f32
             and bf16, the flagship's two on a rank of a space group
             of 2 and 4 (L / S queries against the whole M keys) in bf16,
             and the 256^3 flagship's two (the 128^3 model's shapes) on a
             rank of a space group of 4 (G: L=8192, M=4096, c=64; D:
             L=1024, M=512, c=128) at sp_nccl4_r256's batch, f32 and bf16
             (each pass has two routes on the tensor cores: bf16 in bf16
             products, f32 in 3xTF32 ones; the backward's check runs on
             the forward's o and lse),
             holds each against the plain PyTorch version, and times the
             kernel, the plain version and F.scaled_dot_product_attention
             (a yardstick the port never calls) with CUDA events, and the
             kernel's and the yardstick's device time in a profiler trace
             (in f32 traced at the flagship's G and the 128^3 D alone),
             each case beside its bound and the kernel's share of it;
             then
             checks every c and ragged L/M tails at small shapes, the
             flagship's G and D shapes at a data-parallel rank's rows (N =
             8 and 4: 16 // world at 2 and 4 ranks), that a repeated
             forward and backward are bit-identical and that a double
             backward through the kernels raises;
4. conv    — finds the eligible k3 convs of the flagship's G and D and of
             the StyleGAN-1 G (512 -> 32 channels at 4^3-64^3) with forward
             hooks on the port's models, and at each distinct shape (N=16,
             f32 and
             bf16: the wide conv's and dW's bf16 routes on the tensor
             cores, their f32 routes in 3xTF32 on them) holds the wide-N
             conv kernel (forward, and dx
             with the flipped weights) and the dW kernel against their
             plain versions, timing each beside the one PyTorch call that
             computes the same function (F.conv3d;
             aten.convolution_backward for dW), yardsticks the port never
             calls (the median of three windows; the device time in a
             profiler trace for bf16 and for f32 at 32ch@64^3, whose
             plain version is timed too);
             then ragged shapes (one whose f32 dW blocks sum two chains
             of MMAs, several with split-K parts), a repeated dW and a
             repeated wide conv (both routes) bit-identical, both routes'
             weight repacks
             bit-equal to their plain versions and an f16 input refused;
5. train   — trains the flagship (64^3, filters 64, z 512, batch 16,
             iterD 2, biggan, hinge) through gan3d_tpu_torch.cli.train:
             the default run (a few steps and a resume; no conv kernel
             launches), the run with --wide_conv=on --fast_dw=on (a few
             steps and a resume), a short --fast_dw=on run and a default
             run with --profile_dir (10 steps); then the DCGAN-3D family
             at the same widths: --dcgan (WGAN loss, LayerNorm D; a few
             steps and a resume; no attention), --dcgan --sagan --hinge
             (K1 8 and K2 6 launches a step), --dcgan --msl, the hybrid
             (--hybrid --biggan: K1/K2 in G only) and --dcgan
             --gp_weight=10 (the double backward through conv and
             LayerNorm); then StyleGAN2 at the reference's widths (64^3,
             filters 128, z 512, batch 16, iterD 2): --stylegan2 (18
             steps, with the lazy R1/PL steps 0 and 16, and a resume to
             20), --sg2_reg_grads=True (2 steps: the double backward
             through the modulated and FIR convs) and a run with
             --profile_dir (10 steps); then StyleGAN-1 at the same widths
             (its G's table runs 512 -> 32 channels): --stylegan (8 steps
             and a resume to 10, R1 on every D step; no conv kernel),
             --stylegan --wide_conv=on --fast_dw=on (4 steps: K4 and K3 at
             the G's 8 eligible convs, 3 G forwards a step and one a
             logged sample) and a run with --profile_dir (10 steps); all
             bf16.
             Each checks the kernel launch counts the step implies (on the
             bf16 routes' counters; the f32 routes' and K5's stay 0, and
             the StyleGAN2 path launches none of K1-K5), its log line,
             checkpoint and sample grid; after each run but the flagship's
             short --fast_dw=on and the profiled ones, the trained G and D on
             the card (kernels) are held against the same networks on the
             CPU at batch 1 (plain path; the msl D at fixed
             crop offsets; StyleGAN2's
             G at fixed ws and noise, its modulated convs both unfused and
             fused); a StyleGAN2 checkpoint must hold a nonzero pl_mean,
             a StyleGAN-1 checkpoint a pl_mean of 0.
             Last, the gradient penalty with attention in D must be
             refused. Every run logs its FID as nan and says once that
             no Inception weights were found;
   train128 — 128^3, z 512, iterD 2, bf16 (TRAIN128_RUNS): the
             reference's default widths (filters 128) with the flagship's
             flags, --remat=True --remat_scope=stage --fused_step=False (2
             steps; its resume to 3 went in PR 16 for the spatial
             phase's time), then --remat_scope=block with the
             fused step (1 step), both at batch 16; the
             flagship's widths (filters 64, batch 16) without remat and
             with it per stage (1 step each: the same step-0 losses to
             bf16 rounding, the same K1/K2 launches, both peaks);
             StyleGAN2 at filters 128 with remat and without, StyleGAN-1
             at batch 8 (1 step each: the first run keeps
             the 128^3 steady rate). Each run's checks as above (K1 8 and
             K2 6 launches a step in the BigGAN runs, at c = 64 in G and
             c = 128 in D) and peak memory; the trained G and D of the
             first run, of the StyleGAN2 runs and of StyleGAN-1 on the
             card against the CPU at batch 1 (StyleGAN2:
             sg2_model_check);
   dp      — data parallelism (slice 8): the flagship through the train
             CLI's data-parallel entry point (cli.train.train_rank): world
             1 over NCCL against the one-process run (6 steps each:
             step-0 losses bit-equal with cuDNN deterministic, the
             outputs, K1 8 / K2 6 launches a step, vol/s); two ranks
             sharing the card over a gloo group the script makes, f32,
             against one process on the global batch (2 steps: step-0
             losses 1e-4, step 0's all-reduced gradients before Adam 5e-4
             of each update's largest, beside the floor of a one-process
             run with BN's statistics in another order, G and D outputs,
             the replica check, each rank's K1/K2 launches, energy.json
             with 2 chips and the card's power limit), then
             --sync_bn=False (1 step;
             the running stats against the mean of the two halves'), then
             a control with a planted fault (the gradients summed over
             ranks, not averaged), which the gradient check must catch;
             NCCL across 2 or 4 cards where there are several (else a
             line says it was not run);
   tp      — tensor parallelism (slice 11): the flagship through the same
             entry point with --model_devices=2: two ranks sharing the
             card over a gloo group the script makes (data 1 x model 2),
             f32 at batch TP_GLOO_BATCH, against one process on the same
             batch (2 steps: step-0 losses 1e-4, step 1's DP_TOL or 3x
             the floor's, step 0's gradients before Adam gathered whole
             within 5e-4 of each update's largest beside the floor of a
             one-process run with BN's statistics by the sharded BN's
             formula, and bit-equal on both ranks; G and D outputs, the
             replica check, K1 8 / K2 6 launches a step on each rank,
             energy.json with 2 chips, each rank's peak memory beside one
             process's, vol/s; a memory probe at batch 8: one G update's
             forward and backward, the bytes alive after the forward and
             the peak on each rank beside one process), then a control
             with a planted fault (a
             sharded spectral norm's sigma on the rank's slice, not summed
             over the model group; 1 step), which the checks must catch;
             NCCL in bf16 at batch 16 over 2 cards (model 2) and 4 (data
             2 x model 2) where there are that many (else a line says it
             was not run);
   spatial — spatial parallelism (slice 12): the flagship through the
             same entry point with --spatial_devices=2: two ranks sharing
             the card over a gloo group the script makes (data 1 x space
             2, each rank a depth slab), f32 at the tp phase's batch,
             against the tp phase's one-process f32 run (2 steps: step-0
             losses 1e-5, step 0's gradients before Adam within the tp
             phase's limit and bit-equal on both ranks, G and D outputs,
             the replica check, K1 8 / K2 6 launches a step on each rank,
             energy.json with 2 chips, each rank's peak; step 1's losses
             read; the checkpoint resumed for one more step at space 2
             and in one process, losses 1e-5), a control with a planted
             fault (every conv's halo taken as zeros; 1 step), which the
             gradient check must catch, --dcgan and --msl (1 step each;
             step-0 losses 1e-4 against one process), StyleGAN2 and
             StyleGAN-1 with --wide_conv=on --fast_dw=on at their widths
             (slice 13; 1 step each against one-process f32 runs: step-0
             losses 1e-4, step 0's gradients within the same limit and
             bit-equal on both ranks, the replica check, K4 48 / K3 8
             launches on each rank's halo'd slabs; then StyleGAN2 with
             halos of zeros, which the gradient check must catch), and a
             memory probe at batch 16 (one G update's forward and
             backward: bytes alive after the forward and the peak, each
             rank beside one process); after the train128 phase, NCCL in
             bf16 at batch 16 over 2 cards (space 2: the flagship,
             StyleGAN2, StyleGAN-1 and the reference's 128^3 widths
             without remat, its step-0 losses to bf16 rounding of the
             train128 phase's remat run) and 4 (data 2 x space 2, the
             flagship) where there are that many (else a line says it was
             not run); and 256^3: ``sp_gloo4_r256``, four gloo
             ranks sharing the card (data 1 x space 4) at
             scripts/run_spatial_256.py's parity config with filters 8,
             remat per stage and the split step, f32, one step against one
             process (losses 1e-5, gradients, the ranks bit-equal, K1 7 /
             K2 4 on each rank, each rank's peak), and ``sp_nccl4_r256``,
             the flagship's widths on data 1 x space 4 over 4 NCCL cards
             where there are 4 (batch 16, 3 steps: the trainer's
             steady vol/s over steps 1-2, each rank's peak, reserved
             memory and allocator retries, K1/K2, the unsharded step's
             peak reckoned; step-0 losses at batch 2 against one process
             to bf16 rounding; else a line says it was not run);
   inloop_fid — the flagship with in-loop FID: the random stand-in
             (--fid_in_loop=True, 4 steps, a log and a checkpoint every 2),
             a random-init Inception-V3 weights file the script writes in
             the pt_inception layout (--inception_weights, 1 step, a log
             every step), the stand-in with --async_log=True, and the
             stand-in at the default steps_per_log=10 over 10 steps; each
             run's log lines and finite FIDs, the
             checkpoint's FID history, K1/K2 launches as in training; the
             steady vol/s of each beside the default run's; each in-loop
             FID's seconds, split into the host's Fréchet distance and
             the card's feature pass;
   eval    — on the --stylegan run's directory: the generate CLI (16
             volumes), then the eval CLI with --n_seeds=1 on a synthetic
             test set (16 volumes tanh(N(0, 1)) at 64^3, seed 0; batch
             16: one batch) with random-init extractors; checks the
             stats file's keys and finite values, ms_ssim_3d(x, x) = 1, and the 3D-FID
             and slice-FID features on the card against the CPU on the
             same 4 volumes (f32, 1e-3 of the largest value); prints the
             seconds a batch of each metric;
   tournament — cli/tournament on the flagship, --dcgan --sagan and
             hybrid runs (one seed each) over the eval phase's test set,
             by default and with --compat_last_batch: the results block,
             three win rates in [0, 1], K1's forward launches as the loop
             implies (2 D scores and 1 own sample a judge batch, 1 sample
             and 1 score a rival round) and no other kernel's, the seconds
             of each judge; the flagship's D in f32 scoring the same reals
             on the card and the CPU (1e-3 of the largest score);
   export  — cli/export_torch on the flagship and StyleGAN2 runs: the
             reference's params.pkl and checkpoint keys, torch.optim.Adam
             loading the exported optimizer states, and the exported dir
             sampling bit-identically to its source;
   eval_metrics — calibrate(reps=1) at 64^3, batch 16, on the card
             (random ResNet-50, slice-FID stand-in; its two random
             controls, without data batches): randn vs randn below
             randn vs uniform in 3D-FID, axial FID and MMD; its seconds
             (it launches none of the kernels and runs in a thread while
             they build: its line follows the build's);
   step_trace — reads each profiled run's trace of steps 5-9 (the
             flagship's, then StyleGAN2's and StyleGAN-1's): each device
             op's time (the top 15), the device's busy time a step and
             its idle share over the window, and for the flagship the
             attention kernels' share of the device time (K1: the
             forward, K2: the backward);
6. toeplitz_conv — the W-Toeplitz direct conv op (K5, ops/toeplitz_conv.py,
             the port of scripts/bench_lane_conv.py's "pl" variant): at the
             bench's shapes (16/32/32/64/128 channels at 64/64/32/32/16^3,
             batch 16, t = pick_tile; none at 128@16^3, whose kernel is
             skipped as the bench skips it), f32 (the 3xTF32 kernel) and
             bf16 (the bf16 one, both on the tensor cores), drives the op's
             forward and
             forward+backward with each route's launch counter read around
             that run; holds the forward, dx and dW against autograd
             through the plain version; times the forward (the median of
             three windows, and the device time in a profiler trace) and
             forward+backward, the plain forward and F.conv3d on the same
             tensors viewed as NCDHW channels_last_3d (a yardstick the port
             never calls, timed the same way); then the tests' shapes and
             ragged Cin != Cout ones, a repeated forward bit-identical,
             the f32 weight split bit-equal to its plain version, a bad
             tile and an f16 input refused, and 1 launch per forward, 2
             per forward+backward on the dtype's route;
7. probe_ladder — the 14 rungs of the Mosaic probe ladders
             (probes/mosaic_ladder.py) on the card, each held against its
             plain version, with each kernel's launches from that run, and
             a repeated t_fwd, t_dma2 and t_concat bit-identical; then
             each rung's time per call (CUDA events) and its kernel's
             device time (a torch.profiler trace) beside its plain
             version, its bound and one PyTorch call computing the same
             thing (its time per call and its device time; a clone for
             the rungs that copy a whole array); then the bulk copy rungs'
             device time by variants (the launch alone, + the barrier
             init, + the copies, the whole kernel) and under other plans;
8. the kernels JSON line (K1 adds the tournament's launches to its
   launches_by_path, K1 and K2 the 128^3 BigGAN runs'), then the result
   line.

Any failure raises and the script exits non-zero without the result line.
It needs no arguments and one card; it imports nothing of JAX.

``python3 chip_smoke.py --r256`` runs the 256^3 runs alone (for a
machine with 4 cards; on fewer, ``sp_gloo4_r256`` and the one-process
control of ``sp_nccl4_r256``), then times the slab BatchNorm's two
routes (``slab_bn``).

On a machine with 4 cards, ``python3 chip_smoke.py --c4`` reads PERF.md's
C4 (a hang of the 128^3 run at space 2 over 2 cards): that run with the
slab BatchNorm's statistics on a second communicator, as it hung, under
TORCH_DISTRIBUTED_DEBUG=DETAIL at filters 128 and 64 (two pairs of cards
at once), then the spatial phase's multi-card runs beside short
one-process controls; ``--c4-repeat`` runs the 128^3 run as it hung (no
DETAIL) C4_TRIALS times with two communicators and as many with one.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()
# Before torch first touches the card: the 128^3 runs allocate and free
# 8 GiB activations (16 x 128 channels x 128^3 in bf16), and the cache's
# fixed-size segments fragment at that size (the per-block run at
# filters 128 peaks at ~75 of the card's 85 GB and once failed an 8 GiB
# request with 13 GiB reserved but free). Expandable segments grow one
# mapping instead, so freed memory is reusable at any size.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

# Tolerances, as max |kernel - plain| / max |plain|. f32: both sides
# accumulate in f32 in different orders over up to 32768 terms. bf16: both
# sides compute in f32 from the same bf16 inputs and round the result to
# bf16 (2^-8 relative); the kernel's backward also uses the bf16-rounded o
# in delta = sum(dO * o), where the plain autograd uses its f32 o.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32
# (non-tensor), TF32 and bf16 tensor-core FLOP/s; exponentials: 132 SMs x
# 16 special-function ops per clock at the 1.98 GHz boost clock, the clock
# of the f32 figure (132 x 128 FMA x 2 x 1.98 GHz = 67 TF). The bf16 figure
# implies 1.83 GHz; the higher clock gives the least time.
HBM_BPS = 3.35e12
# The products of K1-K5 and the ladder: bf16 at the tensor cores' rate; f32
# at the faster of the card's two ways to f32 accuracy, whatever a kernel
# uses: the FMA pipes (67 TF) or 3xTF32 on the tensor cores (three TF32
# products at 495 TF, 165 TF of f32-accurate ones).
PRODUCT_FLOPS = {"float32": max(67e12, 495e12 / 3), "bfloat16": 989e12}
SFU_OPS = 132 * 16 * 1.98e9
# K1/K2 placements (name, L, M, c), N=16: the 64^3 BigGAN-Deep flagship's
# G (32^3) and D (16^3) attention, then the 64^3 DCGAN's with --sagan, G at
# 16^3 and D at 8^3, then the 128^3 BigGAN-Deep's at the reference's
# filters 128: G at 32^3 on 512 channels (c = 64), D at 16^3 on 1024
# (c = 128).
PLACEMENTS = (("G", 32768, 4096, 16), ("D", 4096, 512, 32),
              ("dcgan_G", 4096, 512, 16), ("dcgan_D", 512, 64, 32),
              ("G128", 32768, 4096, 64), ("D128", 4096, 512, 128))
# The flagship's placements on a rank of a space group of S (slice 12):
# the rank's L / S queries against the whole M keys, bf16 (the trainer's
# route), S = 2 and 4.
SPATIAL_PLACEMENTS = tuple(
    (f"{place}_s{s}", L // s, m, c)
    for s in (2, 4) for place, L, m, c in PLACEMENTS[:2])
# The 256^3 flagship's placements (filters 64: G at 32^3 on 512 channels,
# c = 64; D at 16^3 on 1024, c = 128, as the 128^3 reference model's) on a
# rank of a space group of 4, at sp_nccl4_r256's batch
# R256_KERNEL_N, f32 and bf16.
R256_PLACEMENTS = (("G_r256_s4", 32768 // 4, 4096, 64),
                   ("D_r256_s4", 4096 // 4, 512, 128))
R256_KERNEL_N = 16
# Kernel instances that must not spill (ptxas): every K3, K4 and K5
# instance of both routes (bf16, 3xTF32), the K1 and K2
# kernels of both routes at the flagship's c = 16 and 32 and the 128^3
# model's c = 64 and 128, and the ladder's wide_fwd, box_copy (both modes)
# and im2col27.
NO_SPILL = re.compile(r"(wide|dw|toeplitz)_(tc|tf32x3)_kernel|"
                      r"(fwd|bwd_\w+)_(tc|tf32x3)_kernel<(16|32|64|128)>|"
                      r"wide_fwd_kernel|box_copy_kernel|im2col27_kernel")
# The f32 conv kernels' instances: wide_tf32x3_kernel<wm, vec>,
# dw_tf32x3_kernel<vec>, toeplitz_tf32x3_kernel<wn, vec>.
X3_CONV_INSTANCES = (
    *(f"wide_tf32x3_kernel<{wm},{v}>" for wm in (1, 2, 4) for v in (0, 1)),
    *(f"dw_tf32x3_kernel<{v}>" for v in (0, 1)),
    *(f"toeplitz_tf32x3_kernel<{wn},{v}>" for wn in (1, 2) for v in (0, 1)))
# The kernels whose registers and spills the build phase reports: the
# tensor-core kernels (the attention's 3xTF32 ones too), the ladder's
# wide_fwd, box_copy and im2col27.
REPORTED = (r"[a-z_]+_tc_kernel|[a-z_]+_tf32x3_kernel|wide_fwd_kernel|"
            r"box_copy_kernel|im2col27_kernel")
# Off the main path, checked but not timed: every template instance of c,
# and ragged L and M tails (neither a multiple of any tile).
EXTRA_SHAPES = ((2, 1000, 125, 8), (3, 300, 38, 16), (1, 4133, 517, 32),
                (2, 777, 97, 64), (1, 4133, 517, 128))
N_FLAGSHIP = 16
# The CLI's defaults otherwise (steps_per_log=10, steps_per_img_log=50).
WIDTHS = ["--resolution=64", "--filterG=64", "--filterD=64", "--z_size=512",
          "--batch_size=16", "--iterD=2"]
FLAGSHIP = ["--biggan=True", "--hinge=True"] + WIDTHS
# bench.py's dcgan config (BASELINE config 2 without its eval loop): WGAN
# loss, the LayerNorm D by default
DCGAN = ["--dcgan=True"] + WIDTHS
# the hybrid: the BigGAN-Deep G (attention at 32^3) and the DCGAN WGAN-LN D
HYBRID = ["--hybrid=True", "--biggan=True"] + WIDTHS
# StyleGAN2 (bench.py --family=stylegan2, BASELINE config 4) at the
# reference's channel base 128: channels 32/16/8/4/2 at 4^3-64^3
SG2 = ["--stylegan2=True", "--resolution=64", "--filterG=128",
       "--filterD=128", "--z_size=512", "--batch_size=16", "--iterD=2"]
# StyleGAN-1 (bench.py --family=stylegan) with the D at StyleGAN2's channel
# base 128; its G runs the reference's table, 512/256/128/64/32 channels at
# 4^3-64^3, whatever filterG
SG1 = ["--stylegan=True", "--resolution=64", "--filterG=128",
       "--filterD=128", "--z_size=512", "--batch_size=16", "--iterD=2"]
# Runs of the train phase: (name, flags, ((niters, step it resumes from),
# ...), (SelfAttention3d blocks in G, in D)); the CLI's defaults
# otherwise. The flagship's default path trains 12 steps and resumes for
# 2; its conv kernel paths take fewer steps (each of their steps is
# slower), at the same widths. Then the DCGAN family (slice 4): the
# default WGAN-LN D (6 steps and a resume), --sagan (K1/K2 at 16^3 in G
# and 8^3 in D), --msl, the hybrid, and the gradient penalty's double
# backward through conv and LayerNorm. Then StyleGAN2 (slice 5): 18 steps
# (steps 0 and 16 run the lazy R1 and PL) and a resume to 20, the double
# backward of --sg2_reg_grads=True, and a traced run. Then StyleGAN-1
# (slice 6): 8 steps and a resume to 10, 4 steps with the conv knobs, and
# a traced run.
TRAIN_RUNS = (
    ("default", FLAGSHIP, ((12, 0), (14, 12)), (1, 1)),
    ("wide_conv+fast_dw", FLAGSHIP + ["--wide_conv=on", "--fast_dw=on"],
     ((6, 0), (8, 6)), (1, 1)),
    ("fast_dw", FLAGSHIP + ["--fast_dw=on"], ((3, 0),), (1, 1)),
    ("profiled", FLAGSHIP + ["--profile_dir={tmp}/trace"], ((10, 0),),
     (1, 1)),
    ("dcgan", DCGAN, ((6, 0), (8, 6)), (0, 0)),
    ("dcgan_sagan", DCGAN + ["--sagan=True", "--hinge=True"], ((6, 0),),
     (1, 1)),
    ("dcgan_msl", DCGAN + ["--msl=True"], ((3, 0),), (0, 0)),
    ("hybrid", HYBRID, ((3, 0),), (1, 0)),
    ("dcgan_gp", DCGAN + ["--gp_weight=10"], ((2, 0),), (0, 0)),
    ("stylegan2", SG2, ((18, 0), (20, 18)), (0, 0)),
    ("stylegan2_reg_grads", SG2 + ["--sg2_reg_grads=True"], ((2, 0),),
     (0, 0)),
    ("stylegan2_profiled", SG2 + ["--profile_dir={tmp}/sg2_trace"],
     ((10, 0),), (0, 0)),
    ("stylegan", SG1, ((8, 0), (10, 8)), (0, 0)),
    ("stylegan_knobs", SG1 + ["--wide_conv=on", "--fast_dw=on"], ((4, 0),),
     (0, 0)),
    ("stylegan_profiled", SG1 + ["--profile_dir={tmp}/sg1_trace"],
     ((10, 0),), (0, 0)),
)
# The 128^3 runs (z 512, iterD 2, bf16): (name, flags, ((niters, step it
# resumes from), ...), (SelfAttention3d blocks in G, in D), held against
# the CPU at batch 1). The reference's default widths (filters 128) with
# the flagship's flags at batch 16, remat per stage and the split step (2
# steps; the 64^3 runs hold the resume), then per block with the fused
# step; the flagship's widths (filters 64) without remat and with it, for
# the memory remat saves and the same step-0 losses; StyleGAN2 (a 1-channel
# block at 128^3) with remat and without; StyleGAN-1 at batch 8 without
# remat, as the JAX package trains it there. Each 2 steps unless said.
W128 = ["--resolution=128", "--z_size=512", "--iterD=2"]
REF128 = (["--biggan=True", "--hinge=True", "--filterG=128", "--filterD=128",
           "--batch_size=16"] + W128)
FLAG128 = (["--biggan=True", "--hinge=True", "--filterG=64", "--filterD=64",
            "--batch_size=16"] + W128)
SG2_128 = (["--stylegan2=True", "--filterG=128", "--filterD=128",
            "--batch_size=16"] + W128)
TRAIN128_RUNS = (
    ("ref128", REF128 + ["--remat=True", "--remat_scope=stage",
                         "--fused_step=False"], ((2, 0),), (1, 1),
     True),
    ("ref128_block", REF128 + ["--remat=True", "--remat_scope=block",
                               "--fused_step=True"], ((1, 0),), (1, 1),
     False),
    ("flagship128", FLAG128 + ["--remat=False"], ((1, 0),), (1, 1), False),
    ("flagship128_remat", FLAG128 + ["--remat=True", "--remat_scope=stage"],
     ((1, 0),), (1, 1), False),
    ("stylegan2_128_remat", SG2_128 + ["--remat=True"], ((1, 0),), (0, 0),
     True),
    ("stylegan2_128", SG2_128, ((1, 0),), (0, 0), True),
    ("stylegan_128", ["--stylegan=True", "--filterG=128", "--filterD=128",
                      "--batch_size=8"] + W128, ((1, 0),), (0, 0), True),
)
KNOB_RUN = "wide_conv+fast_dw"
# The runs whose K3/K4 launches the kernels line lists by path (the first
# part of each): the flagship's and StyleGAN-1's knob runs.
CONV_PATHS = (KNOB_RUN, "stylegan_knobs")
# The run the eval phase reads, and its synthetic test set: volumes, batch
# and seed (the eval CLI's --seed default).
EVAL_RUN = "stylegan"
# (one batch: each batch costs the host four sqrtm's; the dp phase needs
# the time)
EVAL_N, EVAL_BATCH, EVAL_SEED = 16, 16, 0
# Volumes of the eval phase's card-against-CPU feature check.
EVAL_CHECK_N = 4
PROFILED_RUN = "profiled"
# The trainer's line when in-loop FID finds no Inception weights (every
# TRAIN_RUNS run: fid_in_loop unset, no weights on the machine).
NO_WEIGHTS_LINE = "in-loop FID: no Inception weights found"
# The inloop_fid phase's runs of the flagship (name, flags, niters):
# (a) the random stand-in (fid_in_loop=True) with a log and a checkpoint
# every 2 steps; (b) a random-init Inception-V3 weights file written in
# the pt_inception layout ({weights}), a log every step (1 step, 2
# logs: the step's and the final one); (c) (a) with async_log; then the
# stand-in at the default steps_per_log=10 over 10 steps, for the steady
# rate (steps 1-9 hold the final log). The weights at steps_per_log=10
# (0.24-0.26x the flagship's rate, PERF.md) no longer run: their two
# host sqrtm's took ~57 s of the time the spatial phase needs.
INLOOP_RUNS = (
    ("stand_in", ["--fid_in_loop=True", "--steps_per_log=2",
                  "--steps_per_ckpt=2"], 4),
    ("weights", ["--inception_weights={weights}", "--steps_per_log=1"], 1),
    ("async", ["--fid_in_loop=True", "--steps_per_log=2",
               "--steps_per_ckpt=2", "--async_log=True"], 4),
    ("stand_in_rate", ["--fid_in_loop=True"], 10),
)
INCEPTION_SEED = 0
# The dp phase (slice 8): the flagship at 64^3 through the train CLI's
# data-parallel entry point (cli.train.train_rank), DP_STEPS steps a run
# on the train phase's data, each against a one-process run of the same
# flags. BN's running stats under --sync_bn=False are held against the
# two halves of DP_HALVES_N noise vectors drawn from DP_Z_SEED.
DP_STEPS = 2
DP_RATE_STEPS = 6  # the bf16 runs at world 1 and one process: 5 steady
DP_OUT_N = 4       # noise vectors / volumes of the output comparison
DP_TOL = 1e-3      # the f32 runs' comparison (module docstring's dp)
DP_G_TOL = 1e-2    # G's eval-mode outputs (_dp_compare)
# step 0's all-reduced gradients against the one-process run's
# (grad_check): each update's largest error as a share of its largest
# gradient. 3x the floor: two one-process runs that differ only in BN's
# reduction order (bn_formula) differ by 1.6e-4 on the G update, whose
# gradient crosses G's 33 BNs (an error of 1.8e-2 of some tensors' own
# largest); a tensor below DP_GRAD_ZERO of its update's largest is zero
# up to rounding
DP_GRAD_TOL = 5e-4
DP_GRAD_ZERO = 1e-6
# K1/K2's rows a rank under data parallelism: 16 // world at worlds 2 and 4
DP_KERNEL_ROWS = (8, 4)
DP_MAX_CARDS = 4
DP_HALVES_N = 16
DP_Z_SEED = 7
# The tp phase (slice 11): the flagship through the train CLI's entry
# point with --model_devices=2, TP_STEPS steps a run, against the dp
# phase's one-process f32 run (same batch, same steps); NCCL across cards
# in bf16 where there are several.
TP_STEPS = 2
TP_MODEL = 2
# The gloo run's batch: a step took ~140 s at 16 and ~40 s at 4 (every
# gather and input-gradient sum staged through the host; PERF.md, PR 14)
TP_GLOO_BATCH = 2
# The memory probe's batch (``tp_memory_probe``): activations dominate a
# one-process f32 G update there as at 16, where the two gloo ranks took
# 45 s of the script's time (PERF.md, PR 14)
TP_PROBE_BATCH = 8
# The spatial phase (slice 12): the flagship through the train CLI's entry
# point with --spatial_devices=SP_SPACE on two ranks sharing the card over
# gloo (data 1 x space 2), f32 at the tp phase's batch, against the tp
# phase's one-process f32 run (the same flags, batch and steps); the DCGAN
# --dcgan and --msl one step each; the memory probe at SP_PROBE_BATCH;
# NCCL across cards in bf16 where there are several.
SP_SPACE = 2
SP_STEPS = TP_STEPS
SP_LOSS_TOL = 1e-5  # step-0 losses against one process, relative
# the DCGAN family's step-0 losses: the dp and tp phases' limit (the
# logged D losses are the second D update's, after Adam's first update
# has moved every noise-level gradient component of the WGAN-LN D's
# LayerNorm affine by its full step; --dcgan read 4.9e-5, PERF.md)
SP_FAMILY_TOL = 1e-4
SP_PROBE_BATCH = 16
SP_DCGAN_RUNS = (("dcgan", DCGAN), ("dcgan_msl", DCGAN + ["--msl=True"]))
# StyleGAN2 and StyleGAN-1 at space 2 (slice 13), one step each on the
# gloo ranks at the tp phase's batch in f32, against one-process f32 runs
# of the same flags: StyleGAN2's step 0 is the lazy R1 + PL step;
# StyleGAN-1 runs the conv knobs, so K4 and K3 take every rank's halo'd
# slabs on their f32 routes (its G's 8 eligible convs: 3 G forwards a
# step, 2 sample forwards, ``expected_conv_launches``); then StyleGAN2
# with every halo of zeros, the control the gradient check must fail.
# Over NCCL on 2 cards both families run in bf16 at batch 16.
SP_SG_RUNS = (("stylegan2", SG2),
              ("stylegan_knobs", SG1 + ["--wide_conv=on", "--fast_dw=on"]))
# C4 (PERF.md): the reference's 128^3 widths without remat at space 2
# over 2 cards hung once in the backward. ``--c4`` reruns it with the
# slab BatchNorm's statistics on a second communicator (the code as it
# hung), at filters 128 and 64, under TORCH_DISTRIBUTED_DEBUG=DETAIL and
# a collective timeout of C4_TIMEOUT_S, then the multi-card runs of the
# spatial phase (the 128^3 one included) as the script runs them.
C4_TIMEOUT_S = 120
C4_WALL_S = 360
# ``--c4-repeat``: the run as it hung (no DETAIL), this many times with two
# communicators and as many with one, on two pairs of cards at once
C4_TRIALS = 3
# 256^3 over the space axis: BigGAN-Deep, hinge, remat and the
# split step (--fused_step=False, the same step in the port) on data 1 x
# space 4, on R256_VOLUMES volumes tanh(N(0, 1)) of 256^3 (seed 0; 1.07 GB
# in the npz).
R256_SPACE = 4
R256_VOLUMES = 16
R256 = ["--biggan=True", "--hinge=True", "--resolution=256", "--remat=True",
        "--fused_step=False"]
# ``sp_gloo4_r256``: scripts/run_spatial_256.py --mode=cpu_parity's config
# (z 16, batch 2, iterD 1, f32, remat per stage) at filters 8: its filters
# 4 give G's attention (32 channels at 32^3) c = 4, which K1/K2 do not
# take (c in 8..128); filters 8 gives c = 8 in G and 16 in D. Four gloo
# ranks share the card, against one process on it.
R256_GLOO = R256 + ["--remat_scope=stage", "--filterG=8", "--filterD=8",
                    "--z_size=16", "--batch_size=2", "--iterD=1",
                    "--compute_dtype=float32"]
# ``sp_nccl4_r256``: the flagship's widths (filters 64, z 512, iterD 2,
# bf16) on 4 NCCL cards, R256_STEPS steps at R256_BATCH, the larger of
# 16 and 8 that fits a rank (58.95 GB of 80 on an H100), remat per
# R256_SCOPE, the lighter scope in one process at batch R256_CHECK_BATCH
# (29.09 GB against 38.50-38.86 per block on an H100, PERF.md); the
# rate is the trainer's steady one, steps 1 to R256_STEPS - 1 (the sample
# grid at step 0 only: steps_per_img_log 50); the check: space 4 at batch
# R256_CHECK_BATCH against one process on one card, step-0 losses to
# bf16 rounding
R256_WIDTHS = R256 + ["--filterG=64", "--filterD=64", "--z_size=512",
                      "--iterD=2"]
R256_SCOPE = "stage"
R256_BATCH = 16
R256_CHECK_BATCH = 2
R256_STEPS = 3
R256_WALL_S = 600  # a launch of the 4 NCCL ranks, ended past it
# The tournament phase's runs (each read as name + "0"): the flagship,
# the DCGAN with --sagan, the hybrid.
TOURNAMENT_RUNS = ("default", "dcgan_sagan", "hybrid")
TOURNAMENT_ROUNDS = 2  # cli/tournament.py play_round's default
# The export phase's runs, and the keys of the reference's checkpoint
# (trainer.py:153-163).
EXPORT_RUNS = ("default", "stylegan2")
CKPT_KEYS = ["step", "modelG_state_dict", "modelD_state_dict",
             "optimizerG_state_dict", "optimizerD_state_dict", "lossG",
             "lossD", "fid"]
# Runs without a model check: the flagship's short conv-knob and profiled
# runs, StyleGAN-1's profiled run.
UNCHECKED_RUNS = ("fast_dw", PROFILED_RUN, "stylegan_profiled")
# The paths whose K1/K2 launches the kernels line lists beside the knob
# run's: each run's first part (the 128^3 runs' in ATTENTION128_PATHS).
ATTENTION_PATHS = ("default", "dcgan_sagan", "hybrid")
ATTENTION128_PATHS = ("ref128", "ref128_block", "flagship128",
                      "flagship128_remat")
# The attention kernels' device ops in the step's trace (sum_partials: the
# bf16 dk/dv pass's fixed-order sum at D; no conv kernel runs in the
# profiled default run).
TRACE_KERNELS = {"K1": ("fwd_tc_kernel",),
                 "K2": ("bwd_dq_tc_kernel", "bwd_dkdv_tc_kernel",
                        "sum_partials_kernel")}
# The traced runs: (run, its trace directory under the temporary one, the
# kernels whose share of the device time step_trace reports).
TRACED = ((PROFILED_RUN, "trace", TRACE_KERNELS),
          ("stylegan2_profiled", "sg2_trace", {}),
          ("stylegan_profiled", "sg1_trace", {}))
# The ladder's rungs that copy a whole array: a view of it is contiguous,
# so their yardstick is a clone.
WHOLE_COPIES = ("copy", "cost_estimate", "manual_dma", "dma_dyn_slot",
                "dma_when_guard")
# The flagship's eligible k3 convs, (channels, side), in call order; each
# deep block has two (conv2, conv3). The conv phase checks this list
# against forward hooks on the port's models.
CONV_G = ((128, 4), (128, 8), (128, 8), (128, 16), (64, 16), (64, 32),
          (32, 32), (32, 64))
CONV_D = ((32, 64), (32, 32), (64, 32), (64, 16), (128, 16), (128, 8),
          (256, 8), (256, 4))
# The StyleGAN-1 G's eligible convs at 64^3, (Ci, Co, side), in call order:
# C1 at 4^3, then each stage's halving and same conv, the last stage's
# halving; its D (StyleGAN2's) has none.
CONV_SG1 = ((512, 512, 4), (512, 256, 8), (256, 256, 8), (256, 128, 16),
            (128, 128, 16), (128, 64, 32), (64, 64, 32), (64, 32, 64))
# Off the main path, checked but not timed: (N, Ci, Co, D, H, W) with odd,
# non-cubic volumes, Ci != Co, the narrowest and widest channels; the last
# one's f32 dW blocks each sum 12-13 boxes of 256 positions, two chains of
# MMAs (dw_x3_plan: P = 7).
CONV_RAGGED = ((1, 8, 256, 3, 5, 7), (2, 24, 8, 5, 9, 3),
               (1, 16, 40, 1, 1, 33), (3, 40, 16, 7, 6, 70),
               (1, 256, 8, 4, 4, 4), (1, 200, 72, 20, 18, 36))
# K5's timed shapes, (channels, side): scripts/bench_lane_conv.py:59, batch
# 16, 20 iterations (its defaults).
TOEPLITZ_BENCH = ((16, 64), (32, 64), (32, 32), (64, 32), (128, 16))
TOEPLITZ_BATCH, TOEPLITZ_ITERS = 16, 20
# Checked, not timed: ((N, D, H, W), Cin, Cout, t) of
# tests/test_pallas_conv.py:25-29 and two ragged Cin != Cout ones, the
# second with ragged row, column, input- and output-channel tiles.
TOEPLITZ_EXTRA = (((2, 4, 4, 8), 32, 32, 4), ((1, 3, 5, 8), 16, 16, 8),
                  ((1, 4, 4, 8), 8, 64, 2), ((3, 5, 7, 12), 24, 40, 4),
                  ((2, 3, 37, 70), 20, 40, 2))
# The ladder's rung timed for each kernel's entry in the kernels line.
LADDER_MAIN = {"box_copy": "dma_double_buffer", "im2col27": "lane_concat27",
               "gram27": "dw_skeleton", "wide_fwd": "wide_fwd_skeleton"}
# Each rung's pallas_call (file:line).
LADDER_SITES = {
    "copy": "scripts/probe_mosaic.py:48",
    "cost_estimate": "scripts/probe_mosaic.py:301",
    "manual_dma": "scripts/probe_mosaic.py:66",
    "dma_dyn_slot": "scripts/probe_mosaic.py:220",
    "dma_when_guard": "scripts/probe_mosaic.py:246",
    "dma_pds_src": "scripts/probe_mosaic.py:267",
    "dma_pds_src_offset": "scripts/probe_mosaic.py:289",
    "dma_double_buffer": "scripts/probe_mosaic.py:99",
    "lane_concat27": "scripts/probe_mosaic.py:121",
    "wide_dot_accum": "scripts/probe_mosaic.py:153",
    "dw_skeleton": "scripts/probe_mosaic.py:199",
    "lane_value_slice": "scripts/probe_mosaic2.py:38",
    "minor_slice_reshape": "scripts/probe_mosaic2.py:56",
    "wide_fwd_skeleton": "scripts/probe_mosaic2.py:83",
}


def phase(name: str, **kw) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": name, **kw,
                      "t": round(time.time() - T0, 1)}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int) -> tuple:
    """(median, windows): cuda_ms over three windows of ``iters`` calls,
    for the K1-K4 kernels and their one-call yardsticks. A small-volume
    call's time is its wrapper's host work, which a hiccup of the shared
    host can inflate for a whole window; the median keeps one such window
    out of the number, and all three stay in the record."""
    windows = [cuda_ms(fn, iters, warmup=2 if i == 0 else 0)
               for i in range(3)]
    return sorted(windows)[1], windows


def device_ms(fn, needle: str = "", iters: int = 20, per_call: bool = False):
    """Device time (ms) of the kernels whose name holds ``needle`` (with
    "", every kernel, copy and memset), from a torch.profiler trace of
    ``iters`` calls of ``fn``: the mean per launch, or with ``per_call`` the
    sum per call, free of the host work that CUDA events over back-to-back
    calls include; None when the trace holds no such kernel. A warm-up
    round of ``iters`` calls opens the trace (its first kernels can go
    missing); only the kernels that start in the marked second round,
    after the card has finished the first, are counted. 50 ms of idle on
    each side of the mark's start keep a skew between the host's and the
    card's clocks in the trace from moving a kernel across it. The
    profiler can drop a round's kernels: up to three traces are taken
    before None."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "chip_smoke.measured"
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
            with record_function(mark):
                time.sleep(0.05)
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        start = next(e.time_range.start for e in events
                     if e.name == mark and e.device_type != cuda)
        us = [e.device_time_total for e in events
              if e.device_type == cuda and e.name != mark and needle in e.name
              and e.time_range.start >= start]
        if us:
            return sum(us) / (iters if per_call else len(us)) / 1e3
    return None


def timings(kern, lib, iters: int, traced: bool = True) -> dict:
    """A K1-K4 case's times (ms) of the kernel's wrapper and of the one
    PyTorch call computing the same function (``lib``): each the median of
    three windows of ``iters`` calls (all three kept) and, if ``traced``,
    the device time per call in a profiler trace (else None: the f32
    cases off the kernels line's main shape (the attention's: but G and
    D128), whose traces cost seconds of the script's limit)."""
    ms, windows = kernel_ms(kern, iters)
    lib_ms, lib_windows = kernel_ms(lib, iters)
    return {"ms": ms, "ms_windows": windows,
            "device_ms": (device_ms(kern, iters=iters, per_call=True)
                          if traced else None),
            "library_ms": lib_ms, "library_ms_windows": lib_windows,
            "library_device_ms": (device_ms(lib, iters=iters, per_call=True)
                                  if traced else None)}


def bound(kind: str, dtype: str, n: int, L: int, m: int, c: int):
    """Least time for the work on an H100 SXM: (ms, "bytes"|"operations").

    Forward: 2 products (q k^T, p v) and one exp per score; reads q, k, v
    once, writes o and lse. Backward: 5 products (s, dp, dv, dk, dq) and one
    exp per score; reads q, k, v, o, dO, lse, writes dq, dk, dv (the dk/dv
    partials of ``dkdv_split`` are the kernels' own traffic, not the
    function's: each backward case reports them beside its bound). Products
    at PRODUCT_FLOPS (f32: 3xTF32's 165 TF, above the FMA pipes' 67),
    exponentials at SFU_OPS.
    """
    es = 4 if dtype == "float32" else 2
    scores = n * L * m
    if kind == "fwd":
        flops = 4 * scores * c
        nbytes = (2 * n * L * c + 2 * n * m * c) * es + 4 * n * L
    else:
        flops = 10 * scores * c
        nbytes = (4 * n * L * c + 4 * n * m * c) * es + 4 * n * L
    t_bytes = nbytes / HBM_BPS
    t_ops = max(flops / PRODUCT_FLOPS[dtype], scores / SFU_OPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def rel_err(a, b) -> tuple:
    diff = (a.float() - b.float()).abs().max().item()
    return diff, diff / max(b.float().abs().max().item(), 1e-30)


def kernel_phase(ca, attention_plain) -> list:
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    both = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    runs = ([(p, N_FLAGSHIP, both) for p in PLACEMENTS]
            + [(p, N_FLAGSHIP, both[1:]) for p in SPATIAL_PLACEMENTS]
            + [(p, R256_KERNEL_N, both) for p in R256_PLACEMENTS])
    for (place, L, m, c), n, dtypes in runs:
        for dname, dt in dtypes:
            q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(dt)
                           for s in ((n, L, c), (n, m, c), (n, m, c),
                                     (n, L, c)))
            tol = TOL[dname]
            o, lse = ca.attention_fwd(q, k, v)
            dq, dk, dv = ca.attention_bwd(q, k, v, o, lse, do)
            torch.cuda.synchronize()

            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o_ref = attention_plain(*leaves)
            grads_ref = torch.autograd.grad(o_ref, leaves, do,
                                            retain_graph=True)
            lse_ref = torch.cat([
                torch.logsumexp(torch.bmm(q[:, i:i + 1024].float(),
                                          k.float().transpose(1, 2)), -1)
                for i in range(0, L, 1024)], dim=1)
            errs = {"o": rel_err(o, o_ref), "lse": rel_err(lse, lse_ref)}
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      grads_ref):
                errs[name] = rel_err(got, ref)
            for name, (_, rel) in errs.items():
                if not rel <= tol:
                    raise AssertionError(
                        f"{place} {dname} {name}: relative error {rel:.3e} "
                        f"> {tol:.0e}")

            sdpa_in = [t.detach()[:, None].clone().requires_grad_(True)
                       for t in (q, k, v)]
            sdpa_out = F.scaled_dot_product_attention(*sdpa_in, scale=1.0)
            fwd_iters = 20 if L <= 4096 else 5
            calls = {
                "fwd": (lambda: ca.attention_fwd(q, k, v),
                        lambda: attention_plain(q, k, v),
                        lambda: F.scaled_dot_product_attention(
                            q[:, None], k[:, None], v[:, None], scale=1.0)),
                "bwd": (lambda: ca.attention_bwd(q, k, v, o, lse, do),
                        lambda: torch.autograd.grad(
                            o_ref, leaves, do, retain_graph=True),
                        lambda: torch.autograd.grad(
                            sdpa_out, sdpa_in, do[:, None],
                            retain_graph=True)),
            }
            # f32 traced at the kernels line's main placement and the
            # 128^3 D alone
            traced = dname == "bfloat16" or place in ("G", "D128")
            times = {kind: {**timings(kern, lib, fwd_iters, traced),
                            "plain_ms": cuda_ms(plain, fwd_iters)}
                     for kind, (kern, plain, lib) in calls.items()}
            del calls, o_ref, grads_ref, sdpa_out
            parts = ca.dkdv_split(n, L, m, c, f32=dname == "float32")
            for kind in ("fwd", "bwd"):
                b_ms, b_by = bound(kind, dname, n, L, m, c)
                errs_k = ({"o": errs["o"], "lse": errs["lse"]}
                          if kind == "fwd" else
                          {x: errs[x] for x in ("dq", "dk", "dv")})
                case = {
                    "kernel": kind, "placement": place, "dtype": dname,
                    "route": ("tensor_core" if dname == "bfloat16"
                              else "tf32x3"),
                    "N": n, "L": L, "M": m, "c": c,
                    "max_err": max(e[1] for e in errs_k.values()),
                    "max_abs_err": max(e[0] for e in errs_k.values()),
                    "rel_err": {x: e[1] for x, e in errs_k.items()},
                    "tol": tol, **times[kind],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "share_of_bound": b_ms / times[kind]["ms"],
                }
                if kind == "bwd":
                    # the dk/dv pass's parts and the bytes of writing and
                    # reading back their f32 partials (none at one part)
                    case["dkdv_parts"] = parts
                    case["partials_bytes"] = (
                        2 * 2 * parts * n * m * c * 4 if parts > 1 else 0)
                phase("kernel_case", **case)
                cases.append(case)
            torch.cuda.empty_cache()
    return cases


def extra_checks(ca, attention_plain) -> dict:
    """The kernels against the plain version at EXTRA_SHAPES and at the
    flagship's G and D placements with a data-parallel rank's rows
    (DP_KERNEL_ROWS), a repeated forward and backward bit-identical, and
    the backward refusing a second differentiation."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst, dp_rows = {}, {}
    # then the flagship's G and D placements at a data-parallel rank's rows
    shapes = [(None, s) for s in EXTRA_SHAPES] + [
        (f"{place} N={n}", (n, L, m, c)) for place, L, m, c in PLACEMENTS[:2]
        for n in DP_KERNEL_ROWS]
    for rows, (n, L, m, c) in shapes:
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dt)
                       for s in ((n, L, c), (n, m, c), (n, m, c)))
            do = torch.randn((n, L, c), generator=gen, device="cuda").to(dt)
            o, lse = ca.attention_fwd(q, k, v)
            got = (o, *ca.attention_bwd(q, k, v, o, lse, do))
            again = (ca.attention_fwd(q, k, v)[0],
                     *ca.attention_bwd(q, k, v, o, lse, do))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{(n, L, m, c)} {dname}: a repeated "
                                     "forward or backward is not "
                                     "bit-identical")
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o_ref = attention_plain(*leaves)
            want = (o_ref, *torch.autograd.grad(o_ref, leaves, do))
            for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
                rel = rel_err(a, b)[1]
                key = f"{dname}/{name}"
                into = worst if rows is None else dp_rows.setdefault(rows, {})
                into[key] = max(into.get(key, 0.0), rel)
                if not rel <= TOL[dname]:
                    raise AssertionError(f"{(n, L, m, c)} {dname} {name}: "
                                         f"relative error {rel:.3e}")
    q = torch.randn((1, 64, 16), device="cuda", requires_grad=True)
    k = torch.randn((1, 8, 16), device="cuda", requires_grad=True)
    (g,) = torch.autograd.grad(ca.pooled_attention_cuda(q, k, k).sum(), q,
                               create_graph=True)
    try:
        torch.autograd.grad(g.sum(), q)
    except RuntimeError:
        pass
    else:
        raise AssertionError("double backward through the kernels did not "
                             "raise")
    return {"shapes": EXTRA_SHAPES, "worst_rel_err": worst,
            "dp_rank_rows_rel_err": dp_rows, "tol": TOL,
            "repeated_forward_backward": "bit-identical",
            "double_backward": "raises"}


def conv_bound(kind: str, dtype: str, n: int, ci: int, co: int, s: int):
    """Least time for one k3 conv call on an H100 SXM: (ms, "bytes" |
    "operations"). 2 * N * S * Ci * 27 * Co operations at PRODUCT_FLOPS
    (f32: 3xTF32's 165 TF, the least time the card needs for f32-accurate
    products); bytes: each input read once, each
    output written once — the conv reads
    x [N,Ci,S] and w [Co,Ci,27] and writes out [N,Co,S] in one dtype; dW
    reads x and g [N,Co,S] and writes f32 dW [Co,Ci,27]."""
    es = 4 if dtype == "float32" else 2
    flops = 2 * n * s * ci * 27 * co
    if kind == "dw":
        nbytes = n * s * (ci + co) * es + co * ci * 27 * 4
    else:
        nbytes = (n * s * (ci + co) + co * ci * 27) * es
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PRODUCT_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def conv_shapes() -> dict:
    """(Ci, Co, D, H, W) of every conv the port's rule admits, per network
    in call order, from forward pre-hooks on the flagship's G and D and on
    StyleGAN-1's G and D (on the card, N=1, the default route); checked
    against CONV_G / CONV_D / CONV_SG1 (StyleGAN-1's D: none); and
    StyleGAN-1's G on a rank of a space group of 2 ("SG1_s2": the K4 / K3
    routes take the halo'd slab, half the depth and two planes)."""
    import torch

    from gan3d_tpu_torch.config import Config
    from gan3d_tpu_torch.models import build_models
    from gan3d_tpu_torch.nn.layers import Conv3d
    from gan3d_tpu_torch.ops.conv3d import eligible

    cfg = Config(resolution=64, filterG=64, filterD=64, z_size=512,
                 biggan=True, hinge=True, compute_dtype="float32")
    G, D = (net.cuda() for net in build_models(cfg))
    sg1 = Config(stylegan=True, resolution=64, filterG=128, filterD=128,
                 z_size=512, compute_dtype="float32")
    G1, D1 = (net.cuda().eval() for net in build_models(sg1))
    seen = {"G": [], "D": [], "SG1": [], "SG1_D": []}

    def hook(name):
        def record(mod, args):
            w_shape = (mod.out_channels, mod.in_channels, *mod.kernel_size)
            if eligible(args[0].shape, w_shape, mod.stride, mod.padding):
                seen[name].append((mod.in_channels, mod.out_channels,
                                   *args[0].shape[2:]))
        return record

    for name, net in (("G", G), ("D", D), ("SG1", G1), ("SG1_D", D1)):
        for m in net.modules():
            if isinstance(m, Conv3d):
                m.register_forward_pre_hook(hook(name))
    with torch.no_grad():
        D(G(torch.zeros((1, cfg.z_size), device="cuda")))
        D1(G1(torch.zeros((1, sg1.z_size), device="cuda")))
    wants = {name: [(c, c, r, r, r) for c, r in want for _ in range(2)]
             for name, want in (("G", CONV_G), ("D", CONV_D))}
    wants["SG1"] = [(ci, co, r, r, r) for ci, co, r in CONV_SG1]
    wants["SG1_D"] = []
    for name, want in wants.items():
        if seen[name] != want:
            raise AssertionError(f"{name} eligible convs {seen[name]} != "
                                 f"{want}")
    del seen["SG1_D"]
    # a StyleGAN-1 rank's at space 2: its slab and a halo plane each side
    seen["SG1_s2"] = [(ci, co, d // SP_SPACE + 2, h, w)
                      for ci, co, d, h, w in seen["SG1"]]
    return seen


def _conv_inputs(gen, n, ci, co, d, h, w, dt):
    import torch

    x = torch.randn((n, ci, d, h, w), generator=gen, device="cuda").to(dt)
    wt = (torch.randn((co, ci, 3, 3, 3), generator=gen, device="cuda")
          / math.sqrt(27 * ci)).to(dt)
    g = torch.randn((n, co, d, h, w), generator=gen, device="cuda").to(dt)
    # dx of a k3/s1/p1 conv: the conv of g with the flipped, swapped weights
    wr = wt.flip(2, 3, 4).transpose(0, 1).contiguous()
    return x, wt, g, wr


def conv_kernel_phase(cc, shapes: dict) -> list:
    """The wide-N conv (forward; dx) and the dW kernel at each distinct
    shape of the flagship's G and D and StyleGAN-1's G, N=16, f32 and bf16:
    error against the plain version, and times of the kernel and the
    PyTorch call; their device times (a profiler trace) for bf16 and, in
    f32, at 32ch@64^3 alone (the kernels line's main shape), where the
    plain version is timed too (elsewhere ``traced`` is false and there is
    no ``plain_ms``: the plain version is no yardstick). Each case names
    the networks that run its shape ("paths": G, D, SG1, SG1_s2)."""
    import torch
    import torch.nn.functional as F

    from gan3d_tpu_torch.ops.conv3d import conv3d_dw_plain, conv3d_k3_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases = []
    n = N_FLAGSHIP
    for ci, co, d, h, w in sorted(set(sum(shapes.values(), []))):
        s = d * h * w
        paths = [p for p in shapes if (ci, co, d, h, w) in shapes[p]]
        iters = max(3, min(20, int(5e11 / (2 * n * s * ci * 27 * co))))
        main = (ci, d) == (32, 64)  # the kernels line's main shape
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            traced = dname == "bfloat16" or main
            x, wt, g, wr = _conv_inputs(gen, n, ci, co, d, h, w, dt)
            one = [1, 1, 1]
            runs = {
                "wide_fwd": (lambda: cc.wide_conv3d_cuda(x, wt),
                             lambda: conv3d_k3_plain(x, wt),
                             lambda: F.conv3d(x, wt, None, 1, 1), ci, co),
                "wide_dx": (lambda: cc.wide_conv3d_cuda(g, wr),
                            lambda: conv3d_k3_plain(g, wr),
                            lambda: F.conv3d(g, wr, None, 1, 1), co, ci),
                "dw": (lambda: cc.conv3d_dw_cuda(x, g),
                       lambda: conv3d_dw_plain(x, g),
                       lambda: torch.ops.aten.convolution_backward(
                           g, x, wt, None, one, one, one, False, [0, 0, 0],
                           1, [False, True, False])[1], ci, co),
            }
            for kind, (kern, plain, lib, cin, cout) in runs.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                abs_err, rel = rel_err(got, want)
                del got, want
                tol = TOL[dname]
                if not rel <= tol:
                    raise AssertionError(
                        f"{kind} {(n, cin, cout, d, h, w)} {dname}: "
                        f"relative error {rel:.3e} > {tol:.0e}")
                b_ms, b_by = conv_bound("dw" if kind == "dw" else "wide",
                                        dname, n, cin, cout, s)
                case = {
                    "kernel": kind, "dtype": dname, "paths": paths,
                    "route": ("tensor_core" if dname == "bfloat16"
                              else "tf32x3"),
                    "N": n, "Ci": cin, "Co": cout, "D": d, "H": h, "W": w,
                    "max_err": rel, "max_abs_err": abs_err, "tol": tol,
                    "bound_ms": b_ms, "bound_by": b_by, "traced": traced,
                    **timings(kern, lib, iters, traced),
                }
                if main:
                    case["plain_ms"] = cuda_ms(plain, max(2, iters // 4), 1)
                phase("conv_case", **case)
                cases.append(case)
            del x, wt, g, wr, runs
            torch.cuda.empty_cache()
    return cases


def dw_x3_chains(cc, shape) -> tuple:
    """(P, most MMA chains a block sums) of the f32 dW at ``shape``: its
    plan's split-K parts over the N x boxes list, and a chain of at most
    DW_X3_CHAIN // (the box rounded up to 8) boxes."""
    n, ci, co, d, h, w = shape
    td, th, tw, p = cc.dw_x3_plan(*shape)
    boxes = n * -(-d // td) * -(-h // th) * -(-w // tw)
    chain = cc.DW_X3_CHAIN // (-(-td * th * tw // 8) * 8)
    return p, -(-(-(-boxes // p)) // chain)


def conv_extra_checks(cc) -> dict:
    """The conv kernels against the plain versions at CONV_RAGGED (among
    them an f32 dW whose blocks sum more than one chain of MMAs, and ones
    split into parts: ``dw_x3_chains``); a repeated dW and a repeated wide
    conv bit-identical, both dtypes (there and at the flagship's largest
    shape); both routes' weight repacks (the f32 one split into TF32
    halves) bit-equal to their plain versions; an f16 CUDA input refused
    by both wrappers."""
    import torch

    from gan3d_tpu_torch.ops.conv3d import conv3d_dw_plain, conv3d_k3_plain

    chains = {str(s): dw_x3_chains(cc, s) for s in CONV_RAGGED}
    if not (any(p > 1 for p, _ in chains.values())
            and any(c > 1 for _, c in chains.values())):
        raise AssertionError(f"CONV_RAGGED's f32 dW plans {chains} lack a "
                             "split-K shape or a block of several chains")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    worst = {}
    for shape in CONV_RAGGED + ((N_FLAGSHIP, 32, 32, 64, 64, 64),):
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            x, wt, g, wr = _conv_inputs(gen, *shape, dt)
            dw = cc.conv3d_dw_cuda(x, g)
            if not torch.equal(dw, cc.conv3d_dw_cuda(x, g)):
                raise AssertionError(f"{shape} {dname}: a repeated dW is not "
                                     "bit-identical")
            if not torch.equal(cc.wide_conv3d_cuda(x, wt),
                               cc.wide_conv3d_cuda(x, wt)):
                raise AssertionError(f"{shape} {dname}: a repeated wide conv "
                                     "is not bit-identical")
            if shape not in CONV_RAGGED:
                continue
            got = {"wide_fwd": cc.wide_conv3d_cuda(x, wt),
                   "wide_dx": cc.wide_conv3d_cuda(g, wr), "dw": dw}
            want = {"wide_fwd": conv3d_k3_plain(x, wt),
                    "wide_dx": conv3d_k3_plain(g, wr),
                    "dw": conv3d_dw_plain(x, g)}
            for kind in got:
                rel = rel_err(got[kind], want[kind])[1]
                key = f"{dname}/{kind}"
                worst[key] = max(worst.get(key, 0.0), rel)
                if not rel <= TOL[dname]:
                    raise AssertionError(f"{kind} {shape} {dname}: relative "
                                         f"error {rel:.3e}")
    # both routes' weight repacks on the card, bit for bit against their
    # plain versions, for a forward and a dx weight
    for co, ci in ((40, 24), (256, 128)):
        w = torch.randn((co, ci, 3, 3, 3), generator=gen, device="cuda")
        for wt in (w, w.flip(2, 3, 4).transpose(0, 1).contiguous()):
            for card, plain, dt in (
                    (cc.repack_weight_cuda, cc.repack_weight, torch.bfloat16),
                    (cc.repack_weight_x3_cuda, cc.repack_weight_x3,
                     torch.float32)):
                if not torch.equal(card(wt.to(dt)), plain(wt.to(dt))):
                    raise AssertionError(
                        f"weight repack {tuple(wt.shape)} {dt} differs "
                        "from its plain version")
    x, wt, g, _ = _conv_inputs(gen, 1, 8, 8, 4, 4, 4, torch.float16)
    for what, call in (("wide", lambda: cc.wide_conv3d_cuda(x, wt)),
                       ("dW", lambda: cc.conv3d_dw_cuda(x, g))):
        try:
            call()
        except ValueError:
            pass
        else:
            raise AssertionError(f"the {what} kernel took an f16 input")
    return {"shapes": CONV_RAGGED, "worst_rel_err": worst,
            "dw_f32_parts_chains": chains,
            "repeated_dw": "bit-identical",
            "repeated_wide": "bit-identical (bf16, f32)",
            "weight_repack": "bit-equal to its plain version (bf16, f32)",
            "float16": "refused"}


def toeplitz_bound(dtype: str, n: int, s: int, ci: int, co: int):
    """Least time for one K5 forward on an H100 SXM: (ms, "bytes" |
    "operations"). 2 * N * S * Ci * Co * 27 operations at PRODUCT_FLOPS
    (f32: 3xTF32's 165 TF); bytes: x [N,S,Ci] and w [27,Ci,Co] read once,
    out [N,S,Co] written once, in one dtype."""
    es = 4 if dtype == "float32" else 2
    flops = 2 * n * s * ci * co * 27
    nbytes = (n * s * (ci + co) + 27 * ci * co) * es
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PRODUCT_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def _toeplitz_grads(tc, x, w, t, g, plain: bool):
    """(out, dx, dW) of the op (plain: of its plain version, by autograd)
    with upstream gradient g."""
    import torch

    xr, wr = (v.detach().requires_grad_(True) for v in (x, w))
    fn = tc.toeplitz_conv3d_plain if plain else tc.toeplitz_conv3d
    out = fn(xr, wr, t)
    return (out.detach(), *torch.autograd.grad(out, (xr, wr), g))


def toeplitz_phase(cc) -> list:
    """K5 at the bench's shapes, f32 and bf16: the op's forward and
    forward+backward with the launch counter read around them (the path),
    then each case's errors against the plain version and its times."""
    import torch
    import torch.nn.functional as F

    from gan3d_tpu_torch.ops import toeplitz_conv as tc

    n = TOEPLITZ_BATCH
    inputs = {}
    for seed, (c, s) in enumerate(TOEPLITZ_BENCH):
        x, w = tc.make_inputs(c, s, n, torch.float32, seed=seed)
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            inputs[(c, s, dname)] = (x.to(dt), w.to(dt))
        del x, w
    cc.reset_counters()
    runs = {"float32": 0, "bfloat16": 0}
    for (c, s, dname), (x, w) in inputs.items():
        t = tc.pick_tile(c, s)
        if t is None:
            continue
        y = tc.toeplitz_conv3d(x, w, t)
        xr, wr = (v.detach().requires_grad_(True) for v in (x, w))
        dx, dw = torch.autograd.grad(tc.toeplitz_conv3d(xr, wr, t).sum(),
                                     (xr, wr))
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(v).all()) for v in (y, dx, dw)) or \
                y.shape != (n, s, s, s, c) or dw.shape != w.shape:
            raise AssertionError(f"toeplitz {c}ch@{s}^3 {dname}: bad output "
                                 f"{tuple(y.shape)} or non-finite values")
        runs[dname] += 1
        del y, dx, dw, xr, wr
    # each route's counter: the f32 3xTF32 kernel, the bf16 one
    launches = {"float32": cc.toeplitz_launches,
                "bfloat16": cc.toeplitz_tc_launches}
    if any(launches[k] != 3 * runs[k] or not launches[k] for k in runs):
        raise AssertionError(f"toeplitz launches {launches} != 3 x {runs}")
    phase("toeplitz_path", runs=runs, launches=launches)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    cases = []
    for (c, s, dname), (x, w) in inputs.items():
        t = tc.pick_tile(c, s)
        vol = s ** 3
        useful = 2 * n * vol * c * c * 27
        xc = x.permute(0, 4, 1, 2, 3)          # NCDHW, channels_last_3d
        wc = w.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        xl, wl = (v.detach().requires_grad_(True) for v in (xc, wc))
        yl = F.conv3d(xl, wl, None, 1, 1)
        gl = torch.randn(yl.shape, generator=gen, device="cuda").to(
            x.dtype).contiguous(memory_format=torch.channels_last_3d)
        lib = functools.partial(F.conv3d, xc, wc, None, 1, 1)
        lib_ms, lib_windows = kernel_ms(lib, TOEPLITZ_ITERS)
        case = {"kernel": "toeplitz_fwd", "dtype": dname,
                "route": ("tensor_core" if dname == "bfloat16" else "tf32x3"),
                "N": n, "C": c, "S": s, "T": t, "tol": TOL[dname],
                "library_ms": lib_ms, "library_ms_windows": lib_windows,
                "library_device_ms": device_ms(lib, iters=TOEPLITZ_ITERS,
                                               per_call=True),
                "library_fwdbwd_ms": cuda_ms(lambda: torch.autograd.grad(
                    F.conv3d(xl, wl, None, 1, 1), (xl, wl), gl),
                    TOEPLITZ_ITERS)}
        case["library_fwd_tflops"] = useful / case["library_ms"] / 1e9
        case["library_fwdbwd_tflops"] = (3 * useful / case["library_fwdbwd_ms"]
                                         / 1e9)
        del xl, wl, yl
        if t is not None:
            g = gl.permute(0, 2, 3, 4, 1).contiguous()
            got = _toeplitz_grads(tc, x, w, t, g, plain=False)
            want = _toeplitz_grads(tc, x, w, t, g, plain=True)
            torch.cuda.synchronize()
            errs = {k: rel_err(a, b) for k, a, b in zip(("fwd", "dx", "dw"),
                                                        got, want)}
            del got, want
            for k, (_, rel) in errs.items():
                if not rel <= TOL[dname]:
                    raise AssertionError(
                        f"toeplitz {c}ch@{s}^3 {dname} {k}: relative error "
                        f"{rel:.3e} > {TOL[dname]:.0e}")
            xr, wr = (v.detach().requires_grad_(True) for v in (x, w))
            b_ms, b_by = toeplitz_bound(dname, n, vol, c, c)
            kern = functools.partial(tc.toeplitz_conv3d, x, w, t)
            ms, windows = kernel_ms(kern, TOEPLITZ_ITERS)
            case.update({
                "max_err": max(e[1] for e in errs.values()),
                "max_abs_err": max(e[0] for e in errs.values()),
                "rel_err": {k: e[1] for k, e in errs.items()},
                "ms": ms, "ms_windows": windows,
                "device_ms": device_ms(kern, iters=TOEPLITZ_ITERS,
                                       per_call=True),
                "fwdbwd_ms": cuda_ms(lambda: torch.autograd.grad(
                    tc.toeplitz_conv3d(xr, wr, t), (xr, wr), g),
                    TOEPLITZ_ITERS),
                "plain_ms": cuda_ms(
                    lambda: tc.toeplitz_conv3d_plain(x, w, t), 3, 1),
                "bound_ms": b_ms, "bound_by": b_by})
            case["fwd_tflops"] = useful / case["ms"] / 1e9
            case["fwdbwd_tflops"] = 3 * useful / case["fwdbwd_ms"] / 1e9
            del xr, wr, g
        phase("toeplitz_case", **case)
        cases.append(case)
        del gl
        torch.cuda.empty_cache()
    for case in cases:
        if case["T"] is not None:
            case["launches"] = launches[case["dtype"]]
    return cases


def toeplitz_extra_checks(cc) -> dict:
    """K5 at TOEPLITZ_EXTRA against the plain version (forward, dx, dW); a
    repeated forward bit-identical; the f32 route's weight split bit-equal
    to its plain version; a bad tile and an f16 input refused; 1 launch
    per forward and 2 per forward+backward, on the dtype's route (bf16:
    the bf16 kernel; f32: the 3xTF32 kernel)."""
    import torch

    from gan3d_tpu_torch.ops import toeplitz_conv as tc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    worst = {}
    for shape, ci, co, t in TOEPLITZ_EXTRA:
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            x = torch.randn((*shape, ci), generator=gen, device="cuda").to(dt)
            w = (torch.randn((3, 3, 3, ci, co), generator=gen, device="cuda")
                 / math.sqrt(27 * ci)).to(dt)
            g = torch.randn((*shape, co), generator=gen, device="cuda").to(dt)
            # the launches on this dtype's route; the other route's stay
            mine, other = ("toeplitz_tc_launches", "toeplitz_launches")
            if dt == torch.float32:
                mine, other = other, mine
            before = (getattr(cc, mine), getattr(cc, other))
            if not torch.equal(tc.toeplitz_conv3d(x, w, t),
                               tc.toeplitz_conv3d(x, w, t)):
                raise AssertionError(f"toeplitz {shape} {ci}->{co} {dname}: "
                                     "a repeated forward is not "
                                     "bit-identical")
            fwd = (getattr(cc, mine) - before[0]) // 2
            got = _toeplitz_grads(tc, x, w, t, g, plain=False)
            both = getattr(cc, mine) - before[0] - 2 * fwd
            if (fwd, both) != (1, 2) or getattr(cc, other) != before[1]:
                raise AssertionError(f"toeplitz {dname} launches: {fwd} per "
                                     f"forward, {both} per forward+backward "
                                     f"on {mine}, or some on {other}")
            want = _toeplitz_grads(tc, x, w, t, g, plain=True)
            for name, a, b in zip(("fwd", "dx", "dw"), got, want):
                rel = rel_err(a, b)[1]
                key = f"{dname}/{name}"
                worst[key] = max(worst.get(key, 0.0), rel)
                if not rel <= TOL[dname]:
                    raise AssertionError(f"toeplitz {shape} {ci}->{co} "
                                         f"{dname} {name}: relative error "
                                         f"{rel:.3e}")
    for ci, co in ((24, 40), (128, 64)):
        w = torch.randn((3, 3, 3, ci, co), generator=gen, device="cuda")
        if not torch.equal(cc.repack_toeplitz_weight_x3_cuda(w),
                           cc.repack_toeplitz_weight_x3(w)):
            raise AssertionError(f"toeplitz weight split {ci}->{co} differs "
                                 "from its plain version")
    x = torch.zeros((1, 2, 2, 8, 8), device="cuda")
    w = torch.zeros((3, 3, 3, 8, 8), device="cuda")
    for what, call in (("tile 3 for W=8", lambda: tc.toeplitz_conv3d(x, w, 3)),
                       ("float16", lambda: tc.toeplitz_conv3d(
                           x.half(), w.half(), 4))):
        try:
            call()
        except ValueError:
            pass
        else:
            raise AssertionError(f"toeplitz conv took {what}")
    return {"shapes": TOEPLITZ_EXTRA, "worst_rel_err": worst,
            "repeated_forward": "bit-identical (bf16, f32)",
            "weight_split": "bit-equal to its plain version",
            "launches": "1 per forward, 2 per forward+backward",
            "refused": ["tile 3 for W=8", "float16"]}


def ladder_phase(ml) -> list:
    """The probe ladder on the card (the path: every rung, held against its
    plain version, launches counted around it), then every rung's times:
    ``ms`` by CUDA events over back-to-back calls (the wrapper's host work
    included: the kernels take microseconds), ``device_ms`` the kernel's
    own time in a profiler trace, and ``library_device_ms`` the device
    time per call of every kernel, copy and memset of the one PyTorch call
    that computes the same thing."""
    import torch

    inp = ml.inputs("cuda")
    ml.reset_counters()
    results = ml.run_all(inp)
    launches = dict(ml.launches)
    failed = [name for name, ok in results.items() if not ok]
    if failed or not all(launches.values()):
        raise AssertionError(f"ladder rungs failed: {failed}; launches "
                             f"{launches}")
    # the product's fixed-order sum, the double-buffered ring and the
    # im2col: two calls give the same bits
    repeats = (ml.t_fwd, ml.t_dma2, ml.t_concat)
    for rung in repeats:
        first, second = rung(inp), rung(inp)
        if not torch.equal(first.view(torch.int16), second.view(torch.int16)):
            raise AssertionError(f"{rung.__name__}: a repeat differs")
    phase("ladder_path", rungs=len(results), launches=launches,
          repeats_bit_identical=[r.__name__ for r in repeats])

    x27 = torch.stack([ml.views27(inp.x[s]) for s in range(ml.N)])
    gram_a = torch.cat([x27[s, :, :ml.C].T for s in range(ml.N)], 1)
    gram_b = x27.reshape(-1, 27 * ml.C)
    fwd_x27 = ml.x27_fwd(inp.xt)
    flat = {"x": inp.x.reshape(-1), "xt": inp.xt.reshape(-1)}

    def library(name):
        if name in WHOLE_COPIES:
            return inp.x.clone
        if name in ml.BOX_RUNGS:
            src, b = ml.BOX_RUNGS[name][:2]
            return lambda: torch.as_strided(
                flat[src], (b.n, b.a, b.b, b.length), (b.sn, b.sa, b.sb, 1),
                b.off).contiguous()
        if name == "lane_concat27":
            return lambda: inp.x[-1].unfold(0, 6, 1).unfold(1, 6, 1).unfold(
                2, 6, 1).permute(4, 5, 6, 0, 1, 2, 3).reshape(216, 864)
        if name in ("wide_dot_accum", "dw_skeleton"):
            return lambda: torch.matmul(gram_a, gram_b)
        return lambda: torch.matmul(inp.w2, fwd_x27)

    cases = []
    for name, rung, kernel in ml.RUNGS:
        got, want = rung(inp), rung(inp, plain=True)
        abs_err, rel = ml.rel_err(got, want)
        out_bytes = got.numel() * got.element_size()
        if kernel == "box_copy":
            nbytes, flops = 2 * out_bytes, 0
        elif kernel == "im2col27":
            nbytes, flops = ml.SAMPLE * 2 + out_bytes, 0
        elif kernel == "gram27":
            nbytes = inp.x.numel() * 2 + out_bytes
            flops = 2 * ml.C * 27 * ml.C * ml.V ** 3 * ml.N
        else:
            nbytes = (inp.w2.numel() + inp.xt.numel()) * 2 + out_bytes
            flops = 2 * 8 * 27 * ml.CI * ml.DD * ml.H * ml.W * ml.N
        t_bytes, t_ops = nbytes / HBM_BPS, flops / PRODUCT_FLOPS["bfloat16"]
        case = {"rung": name, "kernel": kernel,
                "replaces": LADDER_SITES[name],
                "shape": list(got.shape), "dtype": str(got.dtype)[6:],
                "max_err": rel, "max_abs_err": abs_err, "tol": ml.TOL[kernel],
                "ms": cuda_ms(lambda rung=rung: rung(inp), 200, 5),
                "device_ms": device_ms(lambda rung=rung: rung(inp),
                                       f"{kernel}_kernel"),
                "plain_ms": cuda_ms(lambda rung=rung: rung(inp, plain=True),
                                    50, 2),
                "library_ms": cuda_ms(library(name), 200, 5),
                "library_device_ms": device_ms(library(name),
                                               per_call=True),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "launches": launches[kernel]}
        phase("ladder_case", **case)
        cases.append(case)
    return cases


def ladder_breakdown(ml) -> dict:
    """Device µs of the bulk box rungs by variants of their plan: the
    kernel ended at entry (the launch alone), after the barrier init, and
    with the copies landed but not written out, beside the whole kernel;
    then each bulk rung with its samples split over other numbers of
    blocks (``parts`` 1, 2, 3 or 4, where they divide the box). An entry
    is None where no trace held the kernel (``device_ms``)."""
    import torch

    inp = ml.inputs("cuda")

    def us(src, box, plan):
        want = ml.box_plain(src, box)
        if plan.stop == 0 and not torch.equal(ml.box_copy_on(src, box, plan),
                                              want):
            raise AssertionError(f"box_copy on {plan} differs")
        ms = device_ms(lambda: ml.box_copy_on(src, box, plan),
                       "box_copy_kernel")
        # None: the profiler dropped the kernel from all three traces
        return None if ms is None else ms * 1e3

    out = {}
    for name, (src, box, walk, slots, bulk) in ml.BOX_RUNGS.items():
        if not bulk:
            continue
        plan = ml.box_plan(box, walk, slots, True)
        out[name] = {stage: us(getattr(inp, src), box,
                               plan._replace(stop=stop))
                     for stop, stage in ((1, "launch"), (2, "init"),
                                         (3, "copies"), (0, "whole"))}
        for parts in (1, 2, 3, 4):
            if plan.dims[plan.rank - 2] % parts == 0 and parts != plan.parts:
                out[name][f"parts_{parts}"] = us(
                    getattr(inp, src), box,
                    ml.box_plan(box, walk, slots, True, parts))
    return out


def kernel_ptxas(lines: list) -> dict:
    """{"<kernel>[<template args>]": {"registers", "spill_stores",
    "spill_loads"}} for each instance of a REPORTED kernel, from the ptxas
    lines (entry function, then its spill line, then its register line)."""
    out, name = {}, None
    for ln in lines:
        entry = re.search(r"entry function '(\S+)'", ln)
        if entry:
            m = re.search(rf"\D\d+({REPORTED})(?:I((?:L[ib]\d+E)+)E)?",
                          entry.group(1))
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "") if m else ()
            name = (m.group(1) + (f"<{','.join(args)}>" if args else "")
                    if m else None)
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
        if spill:
            out[name].update(spill_stores=int(spill.group(1)),
                             spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", ln)
        if regs:
            out[name]["registers"] = int(regs.group(1))
            name = None
    return out


# The f32 route's kernels of K1-K4 in the kernels line, by bf16 route.
F32_KERNELS = {"fwd_tc": "fwd_tf32x3_kernel",
               "bwd_tc": "bwd_dq_tf32x3_kernel + bwd_dkdv_tf32x3_kernel",
               "wide_tc": "wide_tf32x3_kernel",
               "dw_tc": "dw_tf32x3_kernel + sum_partials_kernel"}


def f32_fields(case: dict) -> dict:
    """An f32 case's kernel and library times, for the kernels line."""
    return {f"f32_{k}": case[k] for k in ("ms", "device_ms", "library_ms",
                                           "library_device_ms")}


def kernels_line(cases: list, conv_cases: list, paths: dict,
                 toeplitz_cases: list, ladder_cases: list, dp: dict) -> dict:
    """One entry per kernel; the top-level numbers are the main path's
    case (attention: G placement, bf16, N=16; convs: 32ch@64^3, bf16,
    N=16, the forward for the wide conv and K5; the ladder: the rung named
    in LADDER_MAIN); every case is listed under "cases". ``launches`` are
    the counts of each kernel's path: the first --wide_conv=on
    --fast_dw=on run for K1-K4 (bf16: K2, K3 and K4 on their tensor-core
    routes; ``paths`` holds each train run's counts by run name), the
    toeplitz_conv and probe_ladder phases' runs for K5 (its bf16 route's
    counter) and the ladder's kernels; K1 and K2 add ``launches_by_path``,
    their counts in the first part of each ATTENTION_PATHS run (the
    flagship's default, the DCGAN's --sagan, the hybrid), K3 and K4 their
    counts in the first part of each CONV_PATHS run (the flagship's and
    StyleGAN-1's knob runs), and K1 and K2 ``launches_per_rank``, each
    rank's count in the dp, tp and spatial phases' runs (``dp``: world 1
    over NCCL, bf16; two ranks on one card over gloo, f32, data-parallel,
    as ``tp_gloo_model2_f32`` model 2 and as ``sp_gloo_space2_f32`` space
    2, ``sp_gloo_space4_r256_f32`` 256^3 at space 4; NCCL across cards
    where there are several), and rank 0's counts of the 256^3 runs join
    ``launches_by_path``; K1's and K2's cases include the flagship's
    placements on a rank of a space group (``G_s2``, ``D_s2``, ``G_s4``,
    ``D_s4``, bf16) and the 256^3 flagship's on a rank of a space group
    of 4 (``G_r256_s4``, ``D_r256_s4``, f32 and bf16); each conv case lists
    the networks that run its shape ("paths": G, D, SG1, SG1_s2; K3 and
    K4 add ``launches_per_rank`` of the spatial phase's StyleGAN-1 knob
    run on the gloo ranks, f32 route). K1-K5 and the
    ladder add ``device_ms`` and ``library_device_ms`` (device time per
    call, profiler), and K1-K5 the f32 route's (the 3xTF32 kernels)
    numbers at the same case:
    ``f32_ms``, ``f32_device_ms``, ``f32_library_ms`` and
    ``f32_library_device_ms``, beside its kernels (``f32_kernel``) and
    route (``f32_route``). ``max_err`` is the largest error
    relative to max |plain| over the compared outputs, the number held
    against ``tol``; ``max_abs_err`` is the largest absolute difference."""
    launches = paths[KNOB_RUN]
    meta = (
        ("pooled_attention_fwd", "pooled_attention.cu",
         "gan3d_tpu/ops/pallas_attention.py:28", "fwd_tc", cases,
         lambda c: c["kernel"] == "fwd",
         lambda c: c["placement"] == "G" and c["dtype"] == "bfloat16",
         "G placement, bfloat16 (tensor cores), N=16, L=32768, M=4096, "
         "c=16"),
        ("pooled_attention_bwd", "pooled_attention.cu",
         "gan3d_tpu/ops/pallas_attention.py:67", "bwd_tc", cases,
         lambda c: c["kernel"] == "bwd",
         lambda c: c["placement"] == "G" and c["dtype"] == "bfloat16",
         "G placement, bfloat16 (tensor cores), N=16, L=32768, M=4096, "
         "c=16"),
        ("wide_conv3d", "conv3d_k3.cu", "gan3d_tpu/ops/wide_conv.py:102",
         "wide_tc", conv_cases, lambda c: c["kernel"] != "dw",
         lambda c: (c["kernel"] == "wide_fwd" and c["dtype"] == "bfloat16"
                    and c["Ci"] == 32 and c["D"] == 64),
         "forward, bfloat16 (tensor cores), N=16, Ci=Co=32, 64^3"),
        ("conv3d_dw", "conv3d_k3.cu", "gan3d_tpu/ops/dw_conv.py:133",
         "dw_tc", conv_cases, lambda c: c["kernel"] == "dw",
         lambda c: c["dtype"] == "bfloat16" and c["Ci"] == 32
         and c["D"] == 64,
         "bfloat16 (tensor cores), N=16, Ci=Co=32, 64^3"),
    )
    out = []
    for name, src, replaces, key, pool, mine_if, main_if, at in meta:
        mine = [c for c in pool if mine_if(c)]
        main = next(c for c in mine if main_if(c))
        out.append({
            "name": name, "route": "cuda",
            "source": f"gan3d_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[key],
            "max_err": main["max_err"], "tol": main["tol"],
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "device_ms": main["device_ms"],
            "library_device_ms": main["library_device_ms"], "at": at,
            "cases": mine,
        })
        by_path = (ATTENTION_PATHS + ATTENTION128_PATHS
                   if key in ("fwd_tc", "bwd_tc") else CONV_PATHS)
        out[-1]["launches_by_path"] = {p: paths[p][key] for p in by_path}
        if key == "fwd_tc":  # the tournament's no-grad forwards
            out[-1]["launches_by_path"]["tournament"] = \
                paths["tournament"][key]
        k = {"fwd_tc": "K1", "bwd_tc": "K2", "wide_tc": "K4",
             "dw_tc": "K3"}[key]
        out[-1]["launches_per_rank"] = {
            run: {r: v[k] for r, v in got["per_rank"].items()}
            for run, got in dp.items() if isinstance(got, dict)
            and "per_rank" in got
            and all(k in v for v in got["per_rank"].values())}
        # the 256^3 runs' rank 0 (its route: f32 over gloo, bf16 over NCCL)
        for run, got in out[-1]["launches_per_rank"].items():
            if "r256" in run:
                out[-1]["launches_by_path"][f"{run}_rank0"] = got["rank0"]
        # the same case's f32 route (the 3xTF32 kernels) beside it
        f32 = next(c for c in mine if c["dtype"] == "float32" and all(
            c[k] == main[k] for k in main
            if k in ("kernel", "placement", "Ci", "D")))
        out[-1].update(f32_fields(f32), f32_kernel=F32_KERNELS[key],
                       f32_route=f32["route"])
    k5 = next(c for c in toeplitz_cases
              if c["dtype"] == "bfloat16" and (c["C"], c["S"]) == (32, 64))
    k5_f32 = next(c for c in toeplitz_cases
                  if c["dtype"] == "float32" and (c["C"], c["S"]) == (32, 64))
    out.append({
        "name": "toeplitz_conv3d", "route": "cuda",
        "source": "gan3d_tpu_torch/csrc/conv3d_toeplitz.cu",
        "replaces": "gan3d_tpu/ops/pallas_conv.py:77",
        "launches": k5["launches"], "max_err": k5["max_err"],
        "tol": k5["tol"], "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], "library_ms": k5["library_ms"],
        "device_ms": k5["device_ms"],
        "library_device_ms": k5["library_device_ms"],
        **f32_fields(k5_f32), "f32_kernel": "toeplitz_tf32x3_kernel",
        "f32_route": k5_f32["route"],
        "at": "forward, bfloat16 (tensor cores), N=16, Ci=Co=32, 64^3, T=4",
        "cases": toeplitz_cases})
    for kernel, rung in LADDER_MAIN.items():
        mine = [c for c in ladder_cases if c["kernel"] == kernel]
        main = next(c for c in mine if c["rung"] == rung)
        out.append({
            "name": f"ladder_{kernel}", "route": "cuda",
            "source": "gan3d_tpu_torch/csrc/probe_ladder.cu",
            "replaces": main["replaces"],
            "replaces_all": [c["replaces"] for c in mine],
            "launches": main["launches"], "max_err": main["max_err"],
            "tol": main["tol"], "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "device_ms": main["device_ms"],
            "library_device_ms": main["library_device_ms"],
            "at": f"rung {rung}",
            "cases": mine})
    return {"kernels": out}


def run_cli(argv: list) -> str:
    """Run the train CLI in-process, on one card unless ``argv`` sets
    --num_devices (the CLI's default 0 takes every card); returns its
    stdout (also echoed)."""
    from gan3d_tpu_torch.cli import train as cli_train

    if not any(a.startswith("--num_devices=") for a in argv):
        argv = argv + ["--num_devices=1"]
    return tee(cli_train.main, argv)[1]


def tee(fn, *args) -> tuple:
    """(fn(*args), its stdout), the stdout also echoed."""
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            sys.__stdout__.write(s)
            return len(s)

        def flush(self):
            sys.__stdout__.flush()

    with contextlib.redirect_stdout(Tee()):
        out = fn(*args)
    return out, buf.getvalue()


def expected_launches(start: int, niters: int, iter_d: int,
                      img_every: int, attention: tuple) -> dict:
    """Attention launches a bf16 run of steps [start, niters) implies (the
    forward and the backward on the tensor-core route), with
    ``attention`` = (SelfAttention3d blocks in G, in D).

    Per step and block: G attention forward iter_d times (no-grad G in
    each D iteration) + once (G step); D attention forward 2 * iter_d
    times (real and fake per D iteration) + once (G step). Backward: every
    D forward that carries a gradient (all of them) and the G step's G
    forward. Each sample-grid log (every img_every steps and once at the
    end) adds a G forward.
    """
    g, d = attention
    steps = niters - start
    img_logs = sum(1 for i in range(start, niters) if i % img_every == 0) + 1
    return {"fwd_tc": (steps * (g * (iter_d + 1) + d * (2 * iter_d + 1))
                       + g * img_logs),
            "bwd_tc": steps * (d * (2 * iter_d + 1) + g)}


def expected_conv_launches(start: int, niters: int, iter_d: int,
                           img_every: int, n_g: int, n_d: int, wide: bool,
                           fast_dw: bool) -> dict:
    """Conv kernel launches a bf16 run of steps [start, niters) implies
    (the wide conv and dW on their tensor-core routes), with n_g / n_d
    eligible convs in each G / D forward.

    With wide_conv on, every eligible conv's forward is a wide launch: G
    forwards iter_d times (no-grad, in the D iterations) and once (G step)
    per step, and once per sample-grid log; D forwards 2 * iter_d + 1
    times per step. Each backward through such a conv adds a wide launch
    for dx (every conv input on the path needs a gradient): the D-step D
    forwards and the G step's D and G forwards. dW (wide_conv or fast_dw
    on): the D-step D forwards' convs and the G step's G convs; D's
    parameters are frozen in the G update, so its D forward asks none.
    StyleGAN-1's fused step has the same G forwards (iter_d no-grad ones
    for the D updates, one with a backward for the G update) and its D no
    eligible conv (n_d = 0).
    """
    steps = niters - start
    img_logs = sum(1 for i in range(start, niters) if i % img_every == 0) + 1
    dw = steps * (2 * iter_d * n_d + n_g) if (wide or fast_dw) else 0
    if not wide:
        return {"wide_tc": 0, "dw_tc": dw}
    fwd = ((steps * (iter_d + 1) + img_logs) * n_g
           + steps * (2 * iter_d + 1) * n_d)
    dx = steps * ((2 * iter_d + 1) * n_d + n_g)
    return {"wide_tc": fwd + dx, "dw_tc": dw}


def train_run(ca, cc, name: str, flags: list, base: list, niters: int,
              start: int, attention: tuple, n_conv: tuple = (0, 0)) -> dict:
    """One run of the train CLI (``base`` + ``--niters``), counters set to
    0 just before it and read just after: the launches its steps imply,
    its log lines, checkpoint (losses; StyleGAN's pl_mean); returns the
    '...Done' numbers, the launches, the peak device memory allocated and
    reserved, and the allocator's retries (a cudaMalloc that failed, the
    cache freed and the call repeated: the run is at the card's
    capacity)."""
    import torch

    wide, fast_dw = "--wide_conv=on" in flags, "--fast_dw=on" in flags
    sg1, sg2 = "--stylegan=True" in flags, "--stylegan2=True" in flags
    ca.reset_counters()
    cc.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    out = run_cli(base + [f"--niters={niters}"])
    got = _counters(ca, cc)
    # bf16 runs: the f32 routes of K1-K4 launch nothing, and K5 is on no
    # train path
    want = {"fwd": 0, "bwd": 0, "wide": 0, "dw": 0, "toeplitz": 0,
            "toeplitz_tc": 0,
            **expected_launches(start, niters, 2, 50, attention),
            **expected_conv_launches(start, niters, 2, 50, *n_conv, wide,
                                     fast_dw)}
    if got != want or (any(attention) and not (got["fwd_tc"]
                                               and got["bwd_tc"])):
        raise AssertionError(f"{name}: launches {got} != expected {want}")
    if (wide or fast_dw) and not got["dw_tc"]:
        raise AssertionError(f"{name}: the dW kernel never launched")
    if wide and not got["wide_tc"]:
        raise AssertionError(f"{name}: the wide kernel never launched")
    if out.count(NO_WEIGHTS_LINE) != 1 or "\tFID nan" not in out:
        raise AssertionError(f"{name}: not one '{NO_WEIGHTS_LINE}' line, or "
                             "no FID logged as nan")
    if start and f"starting from step {start}" not in out:
        raise AssertionError(f"resume did not print 'starting from step "
                             f"{start}'")
    if f"[{niters - 1}|{niters}]\tD(x): " not in out:
        raise AssertionError(f"no log line for step {niters - 1}")
    log_dir = next(f.split("=", 1)[1] for f in base
                   if f.startswith("--log_dir="))
    ckpt = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      map_location="cpu", weights_only=True)
    vals = ckpt["lossG"] + [x for pair in ckpt["lossD"] for x in pair]
    if (len(ckpt["lossG"]) != niters
            or not all(math.isfinite(x) for x in vals)):
        raise AssertionError(f"{len(ckpt['lossG'])} G losses for {niters} "
                             "steps, or a non-finite loss")
    pl_mean = float(ckpt["pl_mean"]) if sg2 or sg1 else None
    if sg2 and not (math.isfinite(pl_mean) and pl_mean != 0.0):
        raise AssertionError(f"{name}: pl_mean {pl_mean} after the lazy "
                             "step 0")
    if sg1 and pl_mean != 0.0:
        raise AssertionError(f"{name}: StyleGAN-1's pl_mean {pl_mean}, "
                             "not 0")
    return {**_done(out), "launches": got,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "max_memory_reserved": torch.cuda.max_memory_reserved(),
            "alloc_retries": torch.cuda.memory_stats().get(
                "num_alloc_retries", 0) - retries,
            "pl_mean": pl_mean, "loss_d0": ckpt["lossD"][0],
            "loss_g0": ckpt["lossG"][0]}


def check_outputs(name: str, log_dir: str, last: int) -> None:
    for f in ("params.json", "models/checkpoint.pt", f"images/{last}.png"):
        if not os.path.isfile(os.path.join(log_dir, f)):
            raise AssertionError(f"{name}: missing {f}")


def train_phase(ca, cc, tmp: str, shapes: dict) -> dict:
    """Every run of TRAIN_RUNS through the CLI, with its launch counts, and
    the model check after each run but UNCHECKED_RUNS; then the gradient
    penalty refused for a D with attention."""
    import numpy as np

    data = os.path.join(tmp, "train.npz")
    rng = np.random.default_rng(0)
    np.savez(data, X=np.tanh(rng.standard_normal((48, 64, 64, 64),
                                                 np.float32)))
    results = {}
    for name, flags, runs, attention in TRAIN_RUNS:
        log_dir = os.path.join(tmp, name)
        flags = [f.format(tmp=tmp) for f in flags]
        base = flags + [f"--data_path={data}", f"--log_dir={log_dir}"]
        # eligible convs a G and a D forward: StyleGAN-1's D has none
        n_conv = ((len(shapes["SG1"]), 0) if "--stylegan=True" in flags
                  else (len(shapes["G"]), len(shapes["D"])))
        for niters, start in runs:
            key = f"{name}/run_{start}_{niters}"
            results[key] = train_run(ca, cc, name, flags, base, niters,
                                     start, attention, n_conv)
            phase("train_run", run=name, niters=niters, **results[key])
        check_outputs(name, log_dir, runs[-1][0] - 1)
        if name not in UNCHECKED_RUNS:
            phase("model_check", run=name, **model_check(log_dir, cc))
    phase("gp_refusal", **gp_refusal(data, tmp))
    return results


def train128_phase(ca, cc, tmp: str) -> dict:
    """The 128^3 runs of TRAIN128_RUNS through the CLI (train_run's checks
    and counts), each but one held against the CPU at batch 1; then the
    reference widths' peak per stage against per block (a stage group
    nests a group per block, so it must not need more), and the remat
    run against the run without it at the flagship's widths (step-0
    losses, K1/K2 launches) and both peaks."""
    import numpy as np
    import torch

    torch.cuda.empty_cache()
    data = os.path.join(tmp, "train128.npz")
    rng = np.random.default_rng(0)
    np.savez(data, X=np.tanh(rng.standard_normal((32, 128, 128, 128),
                                                 np.float32)))
    results = {}
    for name, flags, runs, attention, check in TRAIN128_RUNS:
        log_dir = os.path.join(tmp, name)
        base = flags + [f"--data_path={data}", f"--log_dir={log_dir}"]
        for niters, start in runs:
            key = f"{name}/run_{start}_{niters}"
            results[key] = train_run(ca, cc, name, flags, base, niters, start,
                                     attention)
            phase("train128_run", run=name, niters=niters, **results[key])
        check_outputs(name, log_dir, runs[-1][0] - 1)
        if check:
            phase("model_check", run=name, **model_check(log_dir, cc))
        torch.cuda.empty_cache()
    stage = results["ref128/run_0_2"]["max_memory_allocated"]
    block = results["ref128_block/run_0_1"]["max_memory_allocated"]
    if stage > block:
        raise AssertionError(f"remat per stage peaks at {stage} B, above "
                             f"per block's {block} B")
    phase("remat_scopes", peak_stage=stage, peak_block=block)
    a = results["flagship128/run_0_1"]
    b = results["flagship128_remat/run_0_1"]
    # the same seed, weights and data: the forward math is unchanged, so
    # step 0's losses agree to bf16 rounding (2^-7 of the larger |loss|,
    # at least 2^-7: the gradients may take other cuDNN algorithms)
    pairs = list(zip(a["loss_d0"] + [a["loss_g0"]],
                     b["loss_d0"] + [b["loss_g0"]]))
    err = max(abs(x - y) / max(1.0, abs(x)) for x, y in pairs)
    if not err <= 2 ** -7 or a["launches"] != b["launches"]:
        raise AssertionError(f"remat vs none at 128^3: step-0 losses "
                             f"{pairs} (rel err {err:.3e}), launches "
                             f"{a['launches']} vs {b['launches']}")
    phase("remat_vs_none", losses_step0=pairs, rel_err=err, tol=2 ** -7,
          launches_equal=True, peak_no_remat=a["max_memory_allocated"],
          peak_remat=b["max_memory_allocated"])
    return results


def eval_test_set(tmp: str) -> str:
    """The eval phases' test set: EVAL_N volumes tanh(N(0, 1)) of 64^3
    (seed EVAL_SEED) in an npz in ``tmp``, written once."""
    import numpy as np

    path = os.path.join(tmp, "eval_test.npz")
    if not os.path.exists(path):
        rng = np.random.default_rng(EVAL_SEED)
        np.savez(path, X=np.tanh(rng.standard_normal((EVAL_N, 64, 64, 64),
                                                     np.float32)))
    return path


def eval_phase(tmp: str, run_dir: str) -> dict:
    """The generate and eval CLIs on the card, on a trained StyleGAN-1 run
    (``run_dir``) and a synthetic test set; then the metric and feature
    checks against the CPU. The eval CLI reads run dirs as ``path + seed``:
    ``path + "0"`` links to ``run_dir``."""
    import numpy as np
    import torch

    from gan3d_tpu_torch.cli import eval as cli_eval
    from gan3d_tpu_torch.cli import generate as cli_generate
    from gan3d_tpu_torch.eval.fid_resnet import get_fid_model
    from gan3d_tpu_torch.eval.metrics import ms_ssim_3d
    from gan3d_tpu_torch.eval.slice_fid import SliceFID, volumes_to_slices

    t0 = time.time()
    r = 64
    data = eval_test_set(tmp)
    out = os.path.join(tmp, "generated.npz")
    t = time.time()
    cli_generate.main(["-l", run_dir, f"--num={EVAL_N}",
                       f"--batch={EVAL_BATCH}", f"--out={out}"])
    gen_s = time.time() - t
    fakes = np.load(out)["X"]
    if (fakes.shape != (EVAL_N, r, r, r) or not np.isfinite(fakes).all()
            or np.abs(fakes).max() > 1):
        raise AssertionError(f"generate: {fakes.shape}, or values outside "
                             "[-1, 1]")
    model = os.path.join(tmp, "stylegan_eval")
    os.symlink(run_dir, model + "0")
    stats_dir = os.path.join(tmp, "eval_stats")
    t = time.time()
    per_batch = cli_eval.main([
        "-l", model, f"--data_path={data}", f"--batch_size={EVAL_BATCH}",
        "--n_seeds=1", f"--log_dir={stats_dir}", f"--seed={EVAL_SEED}"])
    eval_s = time.time() - t
    stats = np.load(os.path.join(stats_dir, "stylegan_eval_stats.npz"))
    keys = {"ssim", "mmds", "fid", "fid_ax", "fid_cor", "fid_sag"}
    n_batches = EVAL_N // EVAL_BATCH
    if set(stats.files) != keys or not all(
            stats[k].shape == (n_batches,) and np.isfinite(stats[k]).all()
            for k in keys):
        raise AssertionError(f"eval stats {dict(stats)}")

    x = torch.from_numpy(np.load(data)["X"][:EVAL_CHECK_N, None])
    xc = x.cuda()
    ssim_self = ms_ssim_3d(xc, xc)
    if abs(ssim_self - 1.0) > 1e-5:
        raise AssertionError(f"ms_ssim_3d(x, x) = {ssim_self}")
    errs = {}
    feats = {"fid_3d": (get_fid_model(None, torch.device("cuda")),
                        get_fid_model(None, torch.device("cpu")))}
    card = SliceFID(device=torch.device("cuda"))
    host = SliceFID(device=torch.device("cpu"))
    for axis in ("axial", "coronal", "sagittal"):
        feats[f"slice_{axis}"] = (
            lambda v, a=axis: torch.from_numpy(card._acts(
                volumes_to_slices(v, a))),
            lambda v, a=axis: torch.from_numpy(host._acts(
                volumes_to_slices(v, a))))
    for name, (on_card, on_host) in feats.items():
        got, want = on_card(xc).cpu().float(), on_host(x).float()
        if got.shape != want.shape:
            raise AssertionError(f"{name}: {tuple(got.shape)} on the card, "
                                 f"{tuple(want.shape)} on the CPU")
        _, errs[name] = rel_err(got, want)
        if not errs[name] <= 1e-3:
            raise AssertionError(f"{name} features, card vs CPU: relative "
                                 f"error {errs[name]:.3e} > 1e-3")
    return {"run": run_dir, "test_volumes": EVAL_N, "batch": EVAL_BATCH,
            "stats": {k: stats[k].tolist() for k in sorted(keys)},
            "seconds_a_batch": per_batch, "generate_s": gen_s,
            "eval_s": eval_s, "ms_ssim_self": ssim_self,
            "features_rel_err": errs, "tol": 1e-3,
            "seconds": time.time() - t0}


def _counters(ca, cc) -> dict:
    return {"fwd": ca.fwd_launches, "fwd_tc": ca.fwd_tc_launches,
            "bwd": ca.bwd_launches, "bwd_tc": ca.bwd_tc_launches,
            "wide": cc.wide_launches, "wide_tc": cc.wide_tc_launches,
            "dw": cc.dw_launches, "dw_tc": cc.dw_tc_launches,
            "toeplitz": cc.toeplitz_launches,
            "toeplitz_tc": cc.toeplitz_tc_launches}


def _done(out: str) -> dict:
    """The numbers of the trainer's '...Done' line (steady: None for a
    one-step run)."""
    done = re.search(r"\.\.\.Done \((\d+) steps in ([\d.]+)s, "
                     r"([\d.]+) steps/s(?:; steady ([\d.]+) steps/s "
                     r"= ([\d.]+) vol/s)?\)", out)
    if done is None:
        raise AssertionError("no '...Done' line")
    steady = done.group(4) is not None
    return {"steps": int(done.group(1)), "seconds": float(done.group(2)),
            "steps_per_s": float(done.group(3)),
            "steady_steps_per_s": float(done.group(4)) if steady else None,
            "steady_vol_per_s": float(done.group(5)) if steady else None}


def inloop_fid_phase(ca, cc, tmp: str, default_vol_s: float) -> dict:
    """The flagship with in-loop FID (INLOOP_RUNS) through the train CLI:
    the log lines' count and finite FIDs, the checkpoint's FID history
    (the mean of the logged FIDs up to the checkpoint step), K1/K2
    launches as expected_launches says and no other kernel's, the steady
    rate; each in-loop FID's seconds (SliceFID.axial, synced) split into
    the host's Fréchet distance and the rest (the card's feature pass and
    the slices' copy)."""
    import numpy as np
    import torch

    from gan3d_tpu_torch.eval import slice_fid
    from gan3d_tpu_torch.eval.inception import InceptionV3

    data = os.path.join(tmp, "train.npz")
    weights = os.path.join(tmp, "pt_inception_random.pth")
    # He-normal convs: under torch's default init each layer shrinks the
    # activations and the pooled features come out near 1e-7 (FIDs ~0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(INCEPTION_SEED)
        model = InceptionV3()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5)
        torch.save(model.state_dict(), weights)
    axial, frechet = slice_fid.SliceFID.axial, slice_fid.frechet_distance
    calls = []

    def timed_axial(self, fake, real):
        torch.cuda.synchronize()
        t0 = time.time()
        calls.append({"frechet_s": 0.0})
        out = axial(self, fake, real)
        calls[-1]["fid_s"] = time.time() - t0
        return out

    def timed_frechet(a, b):
        t0 = time.time()
        out = frechet(a, b)
        calls[-1]["frechet_s"] += time.time() - t0
        calls[-1]["features"] = a.shape[1]
        return out

    runs = {}
    slice_fid.SliceFID.axial = timed_axial
    slice_fid.frechet_distance = timed_frechet
    try:
        for name, flags, niters in INLOOP_RUNS:
            runs[name] = inloop_run(ca, cc, tmp, data, weights, name, flags,
                                    niters)
            runs[name]["fid_seconds"] = [
                {**c, "features_s": c["fid_s"] - c["frechet_s"]}
                for c in calls]
            calls.clear()
            phase("inloop_run", run=name, **runs[name])
    finally:
        slice_fid.SliceFID.axial = axial
        slice_fid.frechet_distance = frechet
    if len(runs["async"]["fids"]) != len(runs["stand_in"]["fids"]):
        raise AssertionError("async_log printed another number of lines")
    return {"runs": {k: {"steady_vol_per_s": v["steady_vol_per_s"],
                         "seconds": v["seconds"],
                         "mean_fid_s": float(np.mean(
                             [c["fid_s"] for c in v["fid_seconds"]])),
                         "mean_frechet_s": float(np.mean(
                             [c["frechet_s"] for c in v["fid_seconds"]]))}
                     for k, v in runs.items()},
            "default_steady_vol_per_s": default_vol_s}


def inloop_run(ca, cc, tmp: str, data: str, weights: str, name: str,
               flags: list, niters: int) -> dict:
    """One INLOOP_RUNS run through the train CLI, with its checks."""
    import numpy as np
    import torch

    log_dir = os.path.join(tmp, f"inloop_{name}")
    spl = int(next((f.split("=")[1] for f in flags
                    if f.startswith("--steps_per_log=")), 10))
    ca.reset_counters()
    cc.reset_counters()
    out = run_cli(FLAGSHIP + [f.format(weights=weights) for f in flags]
                  + [f"--data_path={data}", f"--log_dir={log_dir}",
                     f"--niters={niters}"])
    got = _counters(ca, cc)
    want = {k: 0 for k in got}
    want.update(expected_launches(0, niters, 2, 50, (1, 1)))
    if got != want:
        raise AssertionError(f"inloop {name}: launches {got} != {want}")
    lines = re.findall(r"^\[(\d+)\|\d+\]\tD\(x\): .*\tFID (\S+)$", out,
                       re.M)
    steps = [int(s) for s, _ in lines]
    fids = [float(f) for _, f in lines]
    want_steps = [i for i in range(niters) if i % spl == 0] + [niters - 1]
    if steps != want_steps or not all(math.isfinite(f) for f in fids):
        raise AssertionError(f"inloop {name}: log lines {lines}, want "
                             f"steps {want_steps} with finite FIDs")
    hist = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      map_location="cpu", weights_only=True)["fid"]
    if "--steps_per_ckpt=2" in flags:
        # one checkpoint step (2): the mean of steps 0 and 2's FIDs,
        # printed to 4 decimals
        want_hist = float(np.mean(fids[:2]))
        if len(hist) != 1 or abs(hist[0] - want_hist) > 1e-4:
            raise AssertionError(f"inloop {name}: FID history {hist}, "
                                 f"want [{want_hist}]")
    return {"niters": niters, "steps_per_log": spl, "fids": fids,
            "fid_history": hist, "launches": got, **_done(out)}


def tournament_phase(ca, cc, tmp: str) -> dict:
    """cli/tournament.main on the card over TOURNAMENT_RUNS (one seed
    each) and the eval phase's test set, by default and with
    --compat_last_batch: the results block, three win rates in [0, 1],
    K1 forward launches (bf16) as the loop implies and no other kernel;
    the seconds of each judge (its bound and its rivals' rounds, from one
    judge's bound to the next). Then the flagship's D in f32 scores the
    same real volumes on the card and on the CPU."""
    import numpy as np
    import torch

    from gan3d_tpu_torch.cli import tournament as cli_tournament
    from gan3d_tpu_torch.eval.load import load_run, make_discriminator_fn

    attention = {name: att for name, _, _, att in TRAIN_RUNS}
    names = []
    for run in TOURNAMENT_RUNS:
        prefix = os.path.join(tmp, f"tournament_{run}")
        os.symlink(os.path.join(tmp, run), prefix + "0")
        names.append(prefix)
    data = os.path.join(tmp, "eval_test.npz")
    n_batches = -(-EVAL_N // EVAL_BATCH)
    # per judge batch: D(real), D(G_own(z)) and G_own; per rival round:
    # the rival's G and the judge's D; each network once per call
    want_fwd = 0
    for judge in TOURNAMENT_RUNS:
        g, d = attention[judge]
        want_fwd += n_batches * (2 * d + g) + sum(
            TOURNAMENT_ROUNDS * (attention[r][0] + d)
            for r in TOURNAMENT_RUNS if r != judge)
    result = {"runs": list(TOURNAMENT_RUNS), "batches": n_batches}
    bound_fn = cli_tournament.get_decision_bound
    for compat in (False, True):
        marks = []

        def timed_bound(*a, **kw):
            torch.cuda.synchronize()
            marks.append(time.time())
            return bound_fn(*a, **kw)

        argv = ["--data_path", data, f"--batch_size={EVAL_BATCH}",
                "--n_seeds=1", f"--seed={EVAL_SEED}"]
        for n in names:
            argv += ["-l", n]
        if compat:
            argv.append("--compat_last_batch")
        ca.reset_counters()
        cc.reset_counters()
        cli_tournament.get_decision_bound = timed_bound
        try:
            means, out = tee(cli_tournament.main, argv)
        finally:
            cli_tournament.get_decision_bound = bound_fn
        torch.cuda.synchronize()
        marks.append(time.time())
        got = _counters(ca, cc)
        want = {k: 0 for k in got}
        want["fwd_tc"] = want_fwd
        rates = [float(r) for r in re.findall(r"Mean Win Rate of ([\d.]+)",
                                               out)]
        if got != want:
            raise AssertionError(f"tournament: launches {got} != {want}")
        if ("------------- Tournament Results -------------" not in out
                or len(rates) != 3 or sorted(means) != sorted(names)
                or not all(0.0 <= v <= 1.0 for v in means.values())):
            raise AssertionError(f"tournament: {out!r}")
        result["compat_last_batch" if compat else "default"] = {
            "win_rates": {os.path.basename(k)[len("tournament_"):]: v
                          for k, v in means.items()},
            "launches": got,
            "seconds_per_judge": dict(zip(TOURNAMENT_RUNS,
                                          np.diff(marks).tolist()))}

    x = torch.from_numpy(np.load(data)["X"][:EVAL_CHECK_N, None])
    scores = {}
    for dev in ("cuda", "cpu"):
        cfg, _, D = load_run(os.path.join(tmp, "default"), "float32",
                             torch.device(dev))
        scores[dev] = make_discriminator_fn(cfg, D)(x).cpu()
    _, err = rel_err(scores["cuda"], scores["cpu"])
    if not err <= 1e-3:
        raise AssertionError(f"flagship D (f32), card vs CPU: relative "
                             f"error {err:.3e} > 1e-3")
    result.update(judge_f32_rel_err=err, tol=1e-3)
    return result


def export_phase(tmp: str) -> dict:
    """cli/export_torch on the card's runs EXPORT_RUNS: params.pkl holds
    the run's config as a Namespace, the checkpoint the reference's keys;
    torch.optim.Adam of G and D loads the exported optimizer states; the
    exported dir (params.pkl, no params.json) samples through load_run and
    make_sampler bit-identically to its source on the card, when the
    source's sampler repeats bit-identically (else within 1e-6)."""
    import argparse
    import pickle

    import torch

    from gan3d_tpu_torch.cli import export_torch
    from gan3d_tpu_torch.config import Config
    from gan3d_tpu_torch.eval.load import load_run, make_sampler

    cuda = torch.device("cuda")
    result = {}
    for run in EXPORT_RUNS:
        src, out = os.path.join(tmp, run), os.path.join(tmp, f"export_{run}")
        path = export_torch.main(["--log_dir", src, "--out", out])
        with open(os.path.join(out, "params.pkl"), "rb") as f:
            ns = pickle.load(f)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if (not isinstance(ns, argparse.Namespace)
                or vars(ns) != Config.load(src).to_dict()
                or list(ckpt) != CKPT_KEYS
                or os.path.exists(os.path.join(out, "params.json"))):
            raise AssertionError(f"export {run}: params.pkl or checkpoint "
                                 f"keys {list(ckpt)}")
        cfg, G, D = load_run(src, device=cuda)
        torch.optim.Adam(G.parameters()).load_state_dict(
            ckpt["optimizerG_state_dict"])
        torch.optim.Adam(D.parameters()).load_state_dict(
            ckpt["optimizerD_state_dict"])
        ecfg, eG, _ = load_run(out, device=cuda)
        gen = torch.Generator(device=cuda).manual_seed(EVAL_SEED)
        z = torch.randn((EVAL_BATCH, cfg.z_size), generator=gen, device=cuda)
        a, again = make_sampler(cfg, G)(z), make_sampler(cfg, G)(z)
        b = make_sampler(ecfg, eG)(z)
        control = (a - again).abs().max().item()
        diff = (a - b).abs().max().item()
        if diff > (0.0 if control == 0.0 else 1e-6):
            raise AssertionError(f"export {run}: exported sampler differs by "
                                 f"{diff:.3e} (source repeat {control:.3e})")
        result[run] = {"step": ckpt["step"], "max_abs_diff": diff,
                       "source_repeat_diff": control,
                       "optimizer_params": [
                           len(ckpt[k]["param_groups"][0]["params"])
                           for k in ("optimizerG_state_dict",
                                     "optimizerD_state_dict")]}
    return result


def eval_metrics_phase() -> dict:
    """calibrate(reps=1) on the card at 64^3, batch 16: the random ResNet-50
    and the slice-FID stand-in; randn vs randn must score below randn vs
    uniform in 3D-FID, axial FID and MMD. No data batches: the test set is
    one batch, so its control compared the batch with itself (every FID 0)
    at the cost of a host sqrtm of 2048^2, the phase's longest step. It
    launches none of the kernels, so main() runs it in a thread while they
    build."""
    import torch

    from gan3d_tpu_torch.cli.eval_metrics import calibrate
    from gan3d_tpu_torch.eval.fid_resnet import get_fid_model
    from gan3d_tpu_torch.eval.slice_fid import SliceFID

    cuda = torch.device("cuda")
    t0 = time.time()
    res = calibrate(reps=1, size=64, batch=EVAL_BATCH,
                    fid_features=get_fid_model(None, cuda),
                    sfid=SliceFID(device=cuda), seed=EVAL_SEED, device=cuda)
    secs = time.time() - t0
    bad = [k for k in ("3dFID", "FIDax", "MMD")
           if not res["randn_vs_randn"][k] < res["randn_vs_rand"][k]]
    if bad:
        raise AssertionError(f"calibration: randn vs randn not below randn "
                             f"vs uniform in {bad}: {res}")
    return {"results": res, "seconds": secs}


def gp_refusal(data: str, tmp: str) -> dict:
    """The gradient penalty with a D that has attention (--dcgan --sagan):
    the attention kernels' backward is first-order, so the trainer must
    refuse it on the card before a step runs."""
    try:
        run_cli(DCGAN + ["--sagan=True", "--gp_weight=10", "--niters=1",
                         f"--data_path={data}",
                         f"--log_dir={os.path.join(tmp, 'gp_sagan')}"])
    except NotImplementedError as e:
        if "first-order" not in str(e):
            raise
        return {"flags": "--dcgan=True --sagan=True --gp_weight=10",
                "raised": str(e)}
    raise AssertionError("the gradient penalty ran through the first-order "
                         "attention kernels")


def trace_phase(trace_dir: str, steps: int, kernels: dict) -> dict:
    """A profiled run's Chrome trace (its one file in ``trace_dir``) of
    ``steps`` steps: every device op's time (kernels, copies, memsets) by
    name, the top 15 by total; the share of the summed device time of each
    group of ``kernels`` (TRACE_KERNELS: K1's and K2's), which must be
    there; the device's busy time (the union of the ops' intervals) per
    step and its idle share, 1 - busy / the span from the first op's start
    to the last one's end."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"want one trace in {trace_dir}, got {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    ops = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda t: t[0])
    if not ops:
        raise AssertionError(f"{files[0]}: no device op in the trace")
    by_name = {}
    for t0, t1, name in ops:
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += t1 - t0
        tot[1] += 1
    total = sum(v[0] for v in by_name.values())
    busy, end = 0.0, ops[0][0]
    for t0, t1, _ in ops:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    span = end - ops[0][0]
    attention = {k: sum(v[0] for n, v in by_name.items()
                        if any(w in n for w in names))
                 for k, names in kernels.items()}
    share = {k: t / total for k, t in attention.items()}
    if not all(share.values()):
        raise AssertionError(f"attention kernels missing in the trace: "
                             f"{share}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {"trace": files[0], "steps": steps, "device_ops": len(ops),
            "device_ms_per_step": total / steps / 1e3,
            "busy_ms_per_step": busy / steps / 1e3,
            "span_ms_per_step": span / steps / 1e3,
            "idle_share": 1.0 - busy / span,
            "attention_ms_per_step": {k: t / steps / 1e3
                                      for k, t in attention.items()},
            "share_of_device_time": share,
            "top_ops": [{"name": n[:160], "ms_per_step": v[0] / steps / 1e3,
                         "calls_per_step": v[1] / steps,
                         "share": v[0] / total} for n, v in top]}


# ---------------------------------------------------------------------------
# the dp phase: data parallelism (slice 8)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def recorded_grads(updates: int, world: int = 1, fault: bool = False):
    """Adam.step keeps, on the CPU, the gradients it is given (all-reduced,
    as it applies them) in its first ``updates`` calls: step 0's iterD D
    updates and its G update. With ``fault``, the planted fault of the
    control: Adam gets the gradients summed over the ``world`` ranks, not
    their mean. Yields the list of kept updates."""
    from gan3d_tpu_torch.train.state import Adam

    seen, step = [], Adam.step

    def recording(self, grads):
        if fault:
            grads = [g * world for g in grads]
        if len(seen) < updates:
            seen.append([g.detach().float().cpu() for g in grads])
        return step(self, grads)

    Adam.step = recording
    try:
        yield seen
    finally:
        Adam.step = step


def dp_rank(rp, runs: list, out_dir: str, tag: str, halves: int = -1,
            record: tuple = (), fault: int = -1) -> None:
    """One rank of a dp run: ``cli.train.train_rank`` for each argv of
    ``runs`` (cuDNN deterministic, so that two runs of the same flags may
    be compared bit for bit), the launch counters set to 0 before each and
    read after it; then the BN halves check's G forward in the config of
    run ``halves`` (if one is given: an index of ``runs``). Writes
    ``{tag}_rank{r}.json`` in ``out_dir``: each run's counters, stdout and
    peak memory; for the runs whose index is in ``record``, rank 0 writes
    step 0's gradients (``recorded_grads``) to ``{tag}_grads{i}.pt``. Run
    ``fault`` has the control's planted fault."""
    import torch

    from gan3d_tpu_torch.cli import train as cli_train
    from gan3d_tpu_torch.config import config_from_args
    from gan3d_tpu_torch.ops import cuda_attention as ca
    from gan3d_tpu_torch.ops import cuda_conv as cc

    torch.backends.cudnn.deterministic = True
    res = {"rank": rp.rank, "world": rp.world, "device": str(rp.device),
           "runs": []}
    for i, argv in enumerate(runs):
        cfg = config_from_args(argv)
        ca.reset_counters()
        cc.reset_counters()
        torch.cuda.reset_peak_memory_stats(rp.device)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), recorded_grads(
                cfg.iterD + 1 if i in record else 0, rp.world,
                i == fault) as seen:
            cli_train.train_rank(rp, cfg)
        torch.cuda.synchronize(rp.device)
        res["runs"].append({
            "launches": _counters(ca, cc), "stdout": buf.getvalue(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(
                rp.device)})
        if seen and rp.rank == 0:
            torch.save(seen, os.path.join(out_dir, f"{tag}_grads{i}.pt"))
    if halves >= 0:
        res["bn_halves"] = bn_stats(runs[halves], *rp.span(DP_HALVES_N), rp)
    with open(os.path.join(out_dir, f"{tag}_rank{rp.rank}.json"), "w") as f:
        json.dump(res, f)


def bn_stats(argv: list, lo: int, hi: int, replicas=None) -> dict:
    """G's BN running stats after one train-mode forward, from the seed's
    weights in ``argv``'s config (f32), of rows [lo, hi) of DP_HALVES_N
    noise vectors (seed DP_Z_SEED): on a rank of ``replicas``, or in one
    process. Each BN module's (mean, var) as lists."""
    import torch

    from gan3d_tpu_torch.config import config_from_args
    from gan3d_tpu_torch.models import build_models
    from gan3d_tpu_torch.nn.norm import BatchNorm3d

    cfg = config_from_args(argv).replace(compute_dtype="float32")
    G, _ = build_models(cfg, replicas)
    G = G.to(replicas.device if replicas else "cuda").train()
    z = torch.randn((DP_HALVES_N, cfg.z_size),
                    generator=torch.Generator().manual_seed(DP_Z_SEED))
    with torch.no_grad():
        G(z[lo:hi].to(replicas.device if replicas else "cuda"))
    return {name: [m.running_mean.cpu().tolist(), m.running_var.cpu().tolist()]
            for name, m in G.named_modules() if isinstance(m, BatchNorm3d)}


def dp_gloo_rank(local_rank: int, world: int, init_file: str, runs: list,
                 out_dir: str, tag: str, halves: int, record: tuple,
                 fault: int) -> None:
    """A rank of ``world`` sharing card 0 through a gloo group this script
    makes (NCCL refuses two ranks on one card), passed to the trainer as
    its replicas; ``dp_rank``'s runs."""
    import torch
    import torch.distributed as tdist

    from gan3d_tpu_torch.parallel import dist

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tdist.init_process_group("gloo", init_method="file://" + init_file,
                             rank=local_rank, world_size=world,
                             timeout=dist.TIMEOUT)
    rp = dist.Replicas(rank=local_rank, world=world, local_rank=local_rank,
                       local_world=world, device=device,
                       group=tdist.group.WORLD)
    try:
        dp_rank(rp, runs, out_dir, tag, halves=halves, record=record,
                fault=fault)
        rp.barrier()
    finally:
        tdist.destroy_process_group()


def _dp_read(out_dir: str, tag: str, world: int) -> list:
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{tag}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _ckpt_losses(log_dir: str, step: int = 0) -> list:
    import torch

    ckpt = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      map_location="cpu", weights_only=True)
    return [*ckpt["lossD"][step], ckpt["lossG"][step]]


def _rel(a: list, b: list) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def dp_outputs(log_dir: str) -> tuple:
    """The trained G's and D's outputs (f32, eval mode, on the card) on
    fixed inputs: G(z) for DP_OUT_N noise vectors, D of DP_OUT_N fixed
    volumes."""
    import torch

    from gan3d_tpu_torch.config import Config
    from gan3d_tpu_torch.models import build_models

    cfg = Config.load(log_dir).replace(compute_dtype="float32")
    payload = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                         map_location="cpu", weights_only=True)
    G, D = build_models(cfg)
    G.load_state_dict(payload["modelG_state_dict"])
    D.load_state_dict(payload["modelD_state_dict"])
    G, D = G.cuda().eval(), D.cuda().eval()
    r = cfg.resolution
    z = torch.randn((DP_OUT_N, cfg.z_size),
                    generator=torch.Generator().manual_seed(1)).cuda()
    x = torch.tanh(torch.randn((DP_OUT_N, 1, r, r, r),
                               generator=torch.Generator().manual_seed(2)))
    with torch.no_grad():
        return G(z).float().cpu(), D(x.cuda()).float().cpu()


def _dp_compare(a: str, b: str) -> dict:
    """The run in log dir ``a`` against the one in ``b`` after the same
    steps (f32): D's outputs on fixed volumes relative to their largest
    (within DP_TOL), G's outputs on fixed noise, max error in the tanh
    range (within DP_G_TOL). G's tolerance is wider: its conv biases that
    feed a BN have a gradient that is zero but for rounding (1e-10-1e-8
    of G's largest in both runs), so Adam's b1 = 0 update moves each by
    +-lr at random, and in eval mode that shift meets the running means
    (2.6e-3 measured between two ranks and one process after 2 steps;
    in train mode BN cancels it, but a channel whose batch variance is
    near zero amplifies any rounding by up to 1 / sqrt(eps))."""
    ga, da = dp_outputs(a)
    gb, db = dp_outputs(b)
    return {"g_max_abs_err": (ga - gb).abs().max().item(),
            "d_rel_err": ((da - db).abs().max()
                          / db.abs().max().clamp_min(1e-30)).item()}


def _dp_within(cmp: dict) -> bool:
    return cmp["d_rel_err"] <= DP_TOL and cmp["g_max_abs_err"] <= DP_G_TOL


def _dp_one_process(ca, cc, argv: list, tag: str, record: int = 0
                    ) -> dict:
    """A one-process run of ``argv`` (cuDNN deterministic): its launches,
    rates, step-0 losses and peak memory, and the gradients of its first
    ``record`` updates (``recorded_grads``)."""
    import torch

    torch.backends.cudnn.deterministic = True
    ca.reset_counters()
    cc.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    try:
        with recorded_grads(record) as grads:
            out = run_cli(argv)
    finally:
        torch.backends.cudnn.deterministic = False
    log_dir = next(f.split("=", 1)[1] for f in argv
                   if f.startswith("--log_dir="))
    return {"launches": _counters(ca, cc), **_done(out),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "losses_step0": _ckpt_losses(log_dir), "log_dir": log_dir,
            "tag": tag, "grads": grads}


def param_names(argv: list, device: str = "meta") -> dict:
    """G's and D's parameter names in their optimizers' order ("G.x",
    "D.y"), keyed by how many there are; the networks built on
    ``device`` (the meta device's spectral-norm init costs seconds at
    256^3, where narrow networks build faster on the CPU)."""
    import torch

    from gan3d_tpu_torch.config import config_from_args
    from gan3d_tpu_torch.models import build_models

    with torch.device(device):
        nets = build_models(config_from_args(argv))
    return {len(ns): ns for ns in (
        [f"{tag}.{n}" for n, _ in net.named_parameters()]
        for tag, net in zip("GD", nets))}


def grad_check(got, want: list, names: dict) -> dict:
    """Step 0's gradients ``got`` (a list, or the path where a rank wrote
    it) against the one-process run's ``want``, update by update. The
    checked reading (``grad_err``): each update's largest error as a share
    of its largest gradient. Beside it, each tensor's error of its own
    largest entry (``grad_own_err``), over the tensors above DP_GRAD_ZERO
    of their update's largest, and the largest entry of those below it
    (zero up to rounding in the one-process run: the conv biases that
    feed a BN), of that update's largest. ``per_update`` names each
    update's worst tensors (``names``: ``param_names``)."""
    import torch

    if isinstance(got, str):
        got = torch.load(got, weights_only=True)
    if [len(u) for u in got] != [len(u) for u in want]:
        raise AssertionError(f"{len(got)} updates of {[len(u) for u in got]}"
                             f" tensors, one process {[len(u) for u in want]}")
    zero_worst, n_zero, per_update = 0.0, 0, []
    for u, (gs, ws) in enumerate(zip(got, want)):
        largest = max(w.abs().max().item() for w in ws)
        row = {"update": u, "largest": largest, "of_largest": 0.0,
               "own": 0.0, "own_over_1e-4": 0, "own_over_1e-3": 0}
        for name, g, w in zip(names[len(ws)], gs, ws):
            top = w.abs().max().item()
            diff = (g - w).abs().max().item()
            if diff / largest >= row["of_largest"]:
                row.update(of_largest=diff / largest, of_largest_at=name)
            if top <= DP_GRAD_ZERO * largest:
                n_zero += 1
                zero_worst = max(zero_worst, g.abs().max().item() / largest)
                continue
            row["own_over_1e-4"] += diff > 1e-4 * top
            row["own_over_1e-3"] += diff > 1e-3 * top
            if diff / top >= row["own"]:
                row.update(own=diff / top, own_at=name,
                           own_at_share=top / largest)
        per_update.append(row)
    return {"grad_err": max(r["of_largest"] for r in per_update),
            "grad_tol": DP_GRAD_TOL,
            "grad_own_err": max(r["own"] for r in per_update),
            "grad_zero_tensors": n_zero,
            "grad_zero_tensors_max": zero_worst, "per_update": per_update}


def _grads_within(chk: dict, tol: float = DP_GRAD_TOL) -> bool:
    return (chk["grad_err"] <= tol
            and chk["grad_zero_tensors_max"] <= DP_GRAD_ZERO)


@contextlib.contextmanager
def bn_formula():
    """BatchNorm3d's one-process train-mode statistics through the
    explicit two-pass formula (its cross-replica path's, over one rank)
    instead of cuDNN's kernel: the same function in another reduction
    order, whose run is the gradient check's floor."""
    import torch

    from gan3d_tpu_torch.nn.norm import BatchNorm3d

    forward = BatchNorm3d.forward

    def formula(self, x):
        if not self.training:
            return forward(self, x)
        sdt = torch.promote_types(x.dtype, torch.float32)
        n, c = x.shape[:2]
        xc = x.to(sdt).reshape(n, c, -1)
        cnt = n * xc.shape[-1]
        mean = xc.mean(dim=(0, 2))
        var = (xc - mean[:, None]).square().sum(dim=(0, 2)) / cnt
        y = (xc - mean[:, None]) * torch.rsqrt(var + self.eps)[:, None]
        y = y * self.weight.to(sdt)[:, None] + self.bias.to(sdt)[:, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean * m)
            self.running_var.mul_(1 - m).add_(var * (cnt / (cnt - 1)) * m)
            self.num_batches_tracked.add_(1)
        return y.reshape(x.shape).to(x.dtype)

    BatchNorm3d.forward = formula
    try:
        yield
    finally:
        BatchNorm3d.forward = forward


def _dp_rank_checks(name: str, ranks: list, route: str, steps: int,
                    log_dir: str, attention: tuple = (1, 1),
                    run: int = 0, iter_d: int = 2) -> dict:
    """Each rank's K1/K2 launches (``route``: "_tc" for bf16, "" for f32)
    in its run ``run`` as the step (``iter_d`` D updates) implies on its
    rows (``attention``: the attention blocks in G and D), rank 0 alone
    printing, the replica check passed; returns the per-rank numbers."""
    want = expected_launches(0, steps, iter_d, 50, attention)
    per_rank = {}
    for r in ranks:
        got = r["runs"][run]["launches"]
        if (got[f"fwd{route}"], got[f"bwd{route}"]) != (want["fwd_tc"],
                                                        want["bwd_tc"]):
            raise AssertionError(f"{name} rank {r['rank']}: K1/K2 launches "
                                 f"{got} != {want} a rank")
        per_rank[f"rank{r['rank']}"] = {
            "K1": got[f"fwd{route}"], "K2": got[f"bwd{route}"],
            "max_memory_allocated": r["runs"][run]["max_memory_allocated"]}
    out0 = ranks[0]["runs"][run]["stdout"]
    world = len(ranks)
    if world > 1 and f"on all {world} ranks" not in out0:
        raise AssertionError(f"{name}: no passed replica check in rank 0's "
                             "output")
    if any(r["runs"][run]["stdout"] for r in ranks[1:]):
        raise AssertionError(f"{name}: a rank other than 0 printed")
    return {"per_rank": per_rank, **_done(out0),
            "losses_step0": _ckpt_losses(log_dir)}


def dp_phase(ca, cc, tmp: str, data: str, power_limit_w: float) -> dict:
    """The flagship (64^3, filters 64, batch 16, iterD 2, hinge) through
    the train CLI's data-parallel entry point, DP_STEPS steps a run:

    1. world 1 over NCCL (``parallel.launch``, one spawned process) against
       the one-process run, DP_RATE_STEPS steps each: step-0 losses, the
       outputs, gradient magnitudes and parameters after the steps
       bit-equal, K1 8 and K2 6 launches a step, vol/s;
    2. two ranks sharing the card over a gloo group, f32, against one
       process on the global batch 16 (f32): step-0 losses within 1e-4
       relative, step 1's within DP_TOL, step 0's all-reduced gradients
       by ``grad_check`` (beside them its floor: a second one-process run
       with ``bn_formula``), the networks after the steps by
       ``_dp_compare``, the replica check on both ranks,
       K1/K2 on each rank as the step implies, with --track_energy
       (energy.json: 2 chips, the card's power limit); then, in the same
       processes, one step with --sync_bn=False (the replica check: the
       running stats identical on both ranks) and G's BN running stats
       after a forward of each rank's half against the mean of the two
       halves' (1e-5 of the largest); then the control: 2 steps with the
       gradients summed over the ranks (``recorded_grads``' planted
       fault), which ``grad_check`` must fail, with the readings of the
       other limits beside it;
    3. NCCL over 4 cards where there are 4 or more, else 2 where there
       are 2 or 3 (a world that divides the batch), with item 2's checks
       (f32, the gradients too) and vol/s; on one card noted as not run.
    """
    import torch
    import torch.multiprocessing as mp

    from gan3d_tpu_torch.parallel import dist

    t0 = time.time()
    out_dir = os.path.join(tmp, "dp")
    os.makedirs(out_dir, exist_ok=True)
    base = FLAGSHIP + [f"--data_path={data}", f"--niters={DP_STEPS}"]
    res = {}

    # 1. world 1 over NCCL against one process, bf16
    rate = base + [f"--niters={DP_RATE_STEPS}"]
    one = _dp_one_process(ca, cc, rate + [f"--log_dir={tmp}/dp_one"], "one")
    argv1 = rate + [f"--log_dir={tmp}/dp_nccl1", "--num_devices=1"]
    dist.launch(dp_rank, ([argv1], out_dir, "nccl1"),
                dist.Plan(world=1, local=1, first=0, device="cuda"))
    w1 = _dp_rank_checks("nccl1", _dp_read(out_dir, "nccl1", 1), "_tc",
                         DP_RATE_STEPS, f"{tmp}/dp_nccl1")
    if w1["losses_step0"] != one["losses_step0"]:
        raise AssertionError(f"world 1 step-0 losses {w1['losses_step0']} "
                             f"!= one process {one['losses_step0']}")
    cmp1 = _dp_compare(one["log_dir"], f"{tmp}/dp_nccl1")
    if any(v != 0 for v in cmp1.values()):
        raise AssertionError(f"world 1 vs one process after "
                             f"{DP_RATE_STEPS} steps: {cmp1} (bit-equal "
                             "expected)")
    res["nccl_world1"] = {**w1, **cmp1, "losses_bit_equal": True,
                          "one_process_vol_per_s": one["steady_vol_per_s"],
                          "one_process_max_memory_allocated":
                              one["max_memory_allocated"]}
    phase("dp_world1", **res["nccl_world1"])

    # 2. two ranks on one card over gloo, f32
    f32 = base + ["--compute_dtype=float32"]
    iter_d = int(next(f for f in WIDTHS if f.startswith("--iterD="))[8:])
    one32 = _dp_one_process(ca, cc, f32 + [f"--log_dir={tmp}/dp_one32"],
                            "one32", record=iter_d + 1)
    # the floor: one process again, BN's statistics in another order
    with bn_formula():
        floor32 = _dp_one_process(
            ca, cc, f32 + [f"--log_dir={tmp}/dp_floor32"], "floor32",
            record=iter_d + 1)
    names = param_names(f32)
    floor = {**grad_check(floor32.pop("grads"), one32["grads"], names),
             **_dp_compare(one32["log_dir"], floor32["log_dir"]),
             "losses_step1_rel_err": _rel(
                 _ckpt_losses(floor32["log_dir"], 1),
                 _ckpt_losses(one32["log_dir"], 1))}
    runs = [f32 + [f"--log_dir={tmp}/dp_gloo2", "--num_devices=2",
                   "--track_energy=True"],
            f32 + [f"--log_dir={tmp}/dp_gloo2_local_bn", "--num_devices=2",
                   "--sync_bn=False", "--niters=1"],
            f32 + [f"--log_dir={tmp}/dp_gloo2_fault", "--num_devices=2"]]
    init_file = os.path.join(out_dir, "gloo_rendezvous")
    mp.start_processes(dp_gloo_rank, args=(2, init_file, runs, out_dir,
                                           "gloo2", 1, (0, 2), 2),
                       nprocs=2, join=True, start_method="spawn")
    ranks = _dp_read(out_dir, "gloo2", 2)
    w2 = _dp_rank_checks("gloo2", ranks, "", DP_STEPS, f"{tmp}/dp_gloo2")
    rel = _rel(w2["losses_step0"], one32["losses_step0"])
    rel1 = _rel(_ckpt_losses(f"{tmp}/dp_gloo2", 1),
                _ckpt_losses(one32["log_dir"], 1))
    cmp2 = _dp_compare(one32["log_dir"], f"{tmp}/dp_gloo2")
    grads2 = grad_check(os.path.join(out_dir, "gloo2_grads0.pt"),
                        one32["grads"], names)
    if not (rel <= 1e-4 and rel1 <= DP_TOL and _dp_within(cmp2)
            and _grads_within(grads2)):
        raise AssertionError(f"2 ranks vs one process (f32): step-0 loss rel "
                             f"err {rel:.3e} (tol 1e-4), step 1 {rel1:.3e} "
                             f"(tol {DP_TOL}), {cmp2} (tols: _dp_compare), "
                             f"{grads2}")
    # the control: the same run with the gradients summed over the ranks;
    # the gradient check must fail it, the other limits are read beside it
    fault = {**grad_check(os.path.join(out_dir, "gloo2_grads2.pt"),
                          one32["grads"], names),
             **_dp_compare(one32["log_dir"], f"{tmp}/dp_gloo2_fault"),
             "losses_step0_rel_err": _rel(
                 _ckpt_losses(f"{tmp}/dp_gloo2_fault"),
                 one32["losses_step0"]),
             "losses_step1_rel_err": _rel(
                 _ckpt_losses(f"{tmp}/dp_gloo2_fault", 1),
                 _ckpt_losses(one32["log_dir"], 1))}
    fault["caught_by"] = [name for name, bad in (
        ("gradients", not _grads_within(fault)),
        ("losses_step0", fault["losses_step0_rel_err"] > 1e-4),
        ("losses_step1", fault["losses_step1_rel_err"] > DP_TOL),
        ("outputs", not _dp_within(fault))) if bad]
    if "gradients" not in fault["caught_by"]:
        raise AssertionError(f"the gradient check passed the control's "
                             f"planted fault (gradients summed over ranks): "
                             f"{fault}")
    with open(os.path.join(tmp, "dp_gloo2", "energy.json")) as f:
        energy = json.load(f)
    if energy["chips"] != 2 or energy["watts_per_chip_estimate"] != \
            power_limit_w:
        raise AssertionError(f"energy.json {energy}: not 2 chips at the "
                             f"card's {power_limit_w} W")
    local = [r["runs"][1]["stdout"] for r in ranks]
    if "on all 2 ranks" not in local[0] or local[1]:
        raise AssertionError("--sync_bn=False at 2 ranks: no passed replica "
                             "check, or rank 1 printed")
    # the mean of what each half of the batch gives (one process a half)
    want = {}
    for lo in (0, DP_HALVES_N // 2):
        got = bn_stats(runs[1], lo, lo + DP_HALVES_N // 2)
        for k, (m, v) in got.items():
            wm, wv = want.get(k, ([0.0] * len(m), [0.0] * len(v)))
            want[k] = ([a + b / 2 for a, b in zip(wm, m)],
                       [a + b / 2 for a, b in zip(wv, v)])
    err = 0.0
    for r in ranks:
        if r["bn_halves"] != ranks[0]["bn_halves"]:
            raise AssertionError("--sync_bn=False: ranks' BN running stats "
                                 "differ")
    for k, (m, v) in want.items():
        gm, gv = ranks[0]["bn_halves"][k]
        scale = max(max(map(abs, m + v)), 1e-30)
        err = max(err, max(abs(a - b) for a, b in zip(gm + gv, m + v))
                  / scale)
    if not err <= 1e-5:
        raise AssertionError(f"--sync_bn=False: running stats vs the mean of "
                             f"the halves' rel err {err:.3e} (tol 1e-5)")
    res["gloo_world2_f32"] = {
        **w2, **cmp2, **grads2, "losses_step0_rel_err": rel, "tol": 1e-4,
        "losses_step1_rel_err": rel1, "grad_floor": floor,
        "planted_fault_control": fault,
        "one_process_f32_vol_per_s": one32["steady_vol_per_s"],
        "one_process_f32_max_memory_allocated":
            one32["max_memory_allocated"],
        "one_process_f32_launches": {"K1": one32["launches"]["fwd"],
                                     "K2": one32["launches"]["bwd"]},
        "energy": energy, "local_bn_rel_err": err,
        "local_bn_modules": len(want)}
    phase("dp_gloo2", **res["gloo_world2_f32"])

    # 3. NCCL across cards
    # a world that divides the batch of 16
    n = max([w for w in (2, 4) if w <= min(torch.cuda.device_count(),
                                           DP_MAX_CARDS)], default=1)
    if n >= 2:
        argvn = f32 + [f"--log_dir={tmp}/dp_nccl{n}", f"--num_devices={n}"]
        dist.launch(dp_rank, ([argvn], out_dir, f"nccl{n}", -1, (0,)),
                    dist.Plan(world=n, local=n, first=0, device="cuda"))
        wn = _dp_rank_checks(f"nccl{n}", _dp_read(out_dir, f"nccl{n}", n),
                             "", DP_STEPS, f"{tmp}/dp_nccl{n}")
        rel = _rel(wn["losses_step0"], one32["losses_step0"])
        cmpn = _dp_compare(one32["log_dir"], f"{tmp}/dp_nccl{n}")
        gradsn = grad_check(os.path.join(out_dir, f"nccl{n}_grads0.pt"),
                            one32["grads"], names)
        if not (rel <= 1e-4 and _dp_within(cmpn) and _grads_within(gradsn)):
            raise AssertionError(f"{n} cards vs one process (f32): step-0 "
                                 f"loss rel err {rel:.3e} (tol 1e-4), {cmpn} "
                                 f"(tols: _dp_compare), {gradsn}")
        res[f"nccl_world{n}_f32"] = {
            **wn, **cmpn, **gradsn, "losses_step0_rel_err": rel,
            "one_process_f32_vol_per_s": one32["steady_vol_per_s"]}
        phase(f"dp_nccl{n}", **res[f"nccl_world{n}_f32"])
    else:
        res["nccl_multi_card"] = (f"not run: {torch.cuda.device_count()} "
                                  "card(s) visible")
        phase("dp_nccl_multi_card", not_run=res["nccl_multi_card"])
    res["seconds"] = time.time() - t0
    # the one-process bf16 run the tp phase's NCCL runs are read beside
    res["_one"] = one
    return res


# ---------------------------------------------------------------------------
# the tp phase: tensor parallelism (slice 11)
# ---------------------------------------------------------------------------
def _sigma_on_the_slice(u_rows, w, v, rp):
    """The control's planted fault: a sharded spectral norm's sigma taken
    on this rank's rows alone, with no sum over the model group."""
    import torch

    return torch.vdot(u_rows, torch.mv(w, v))


@contextlib.contextmanager
def recorded_full_grads(updates: int, rp):
    """Adam.step keeps, on the CPU, the gradients it is given in its first
    ``updates`` calls, each shard gathered whole over the model group
    (every rank calls it in the same order). Yields the list."""
    from gan3d_tpu_torch.parallel import tp
    from gan3d_tpu_torch.train.state import Adam

    seen, step = [], Adam.step

    def recording(self, grads):
        if len(seen) < updates:
            seen.append([g.detach().float().cpu() for g in
                         tp.full_moments(self.params, grads, rp)])
        return step(self, grads)

    Adam.step = recording
    try:
        yield seen
    finally:
        Adam.step = step


def _halo_of_zeros(x, before, after, rp):
    """The spatial control's planted fault: a halo whose neighbours' planes
    are zeros (no exchange)."""
    import torch

    if not before and not after:
        return x
    shape = list(x.shape)
    shape[2] = before
    head = x.new_zeros(shape)
    shape[2] = after
    return torch.cat([head, x, x.new_zeros(shape)], 2)


# the planted faults of the tp and spatial controls: (module, attribute,
# replacement)
PLANTED = {"sigma": ("tp", "sigma", _sigma_on_the_slice),
           "halo": ("sp", "halo", _halo_of_zeros)}


def tp_rank(rp, runs: list, out_dir: str, tag: str, record: tuple = (),
            fault=-1, planted: str = "sigma",
            copies: dict = None) -> None:
    """One rank of a tp or spatial run: ``cli.train.train_rank`` for each
    argv of ``runs`` (cuDNN deterministic), the launch counters set to 0
    before each and read after it; every rank writes step 0's gradients,
    gathered whole, of the runs whose index is in ``record`` to
    ``{tag}_grads{i}_rank{r}.pt``; run ``fault`` (an index, or a tuple
    of them) has the planted fault
    ``PLANTED[planted]``; before run i, rank 0 copies the directory
    ``copies[i][0]`` to ``copies[i][1]`` (a resume's start). Writes
    ``{tag}_rank{r}.json``: each run's counters, stdout, peak memory
    allocated and reserved and the allocator's retries."""
    import torch

    from gan3d_tpu_torch.cli import train as cli_train
    from gan3d_tpu_torch.config import config_from_args
    from gan3d_tpu_torch.ops import cuda_attention as ca
    from gan3d_tpu_torch.ops import cuda_conv as cc
    from gan3d_tpu_torch.parallel import sp, tp

    torch.backends.cudnn.deterministic = True
    res = {"rank": rp.rank, "world": rp.world, "model": rp.model,
           "space": rp.space, "device": str(rp.device), "runs": []}
    where, attr, bad = PLANTED[planted]
    where = {"tp": tp, "sp": sp}[where]
    good = getattr(where, attr)
    faults = fault if isinstance(fault, tuple) else (fault,)
    for i, argv in enumerate(runs):
        if copies and i in copies:
            if rp.main:
                shutil.copytree(*copies[i])
            rp.barrier()
        cfg = config_from_args(argv)
        ca.reset_counters()
        cc.reset_counters()
        torch.cuda.reset_peak_memory_stats(rp.device)
        retries = torch.cuda.memory_stats(rp.device).get(
            "num_alloc_retries", 0)
        buf = io.StringIO()
        if i in faults:
            setattr(where, attr, bad)
        try:
            with contextlib.redirect_stdout(buf), recorded_full_grads(
                    cfg.iterD + 1 if i in record else 0, rp) as seen:
                cli_train.train_rank(rp, cfg)
        finally:
            setattr(where, attr, good)
        torch.cuda.synchronize(rp.device)
        res["runs"].append({
            "launches": _counters(ca, cc), "stdout": buf.getvalue(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(
                rp.device),
            "max_memory_reserved": torch.cuda.max_memory_reserved(
                rp.device),
            "alloc_retries": torch.cuda.memory_stats(rp.device).get(
                "num_alloc_retries", 0) - retries})
        if seen:
            torch.save(seen, os.path.join(
                out_dir, f"{tag}_grads{i}_rank{rp.rank}.pt"))
    with open(os.path.join(out_dir, f"{tag}_rank{rp.rank}.json"), "w") as f:
        json.dump(res, f)


def tp_memory_probe(rp=None, batch: int = TP_PROBE_BATCH) -> dict:
    """One G update's forward and backward (G, then D, the G loss; G's
    gradients) of the flagship at ``batch``, f32, on a rank of ``rp`` (a
    model or space grid) or in one process: the bytes the networks hold,
    the bytes alive after the forward (what autograd saved), and the peak
    over both passes, each above what the networks held before."""
    import torch

    from gan3d_tpu_torch.config import config_from_args
    from gan3d_tpu_torch.models import build_models
    from gan3d_tpu_torch.train import losses

    dev = rp.device if rp is not None else torch.device("cuda", 0)
    argv = FLAGSHIP + ["--compute_dtype=float32", f"--batch_size={batch}"]
    if rp is not None:
        argv += [f"--model_devices={rp.model}", f"--num_devices={rp.world}",
                 f"--spatial_devices={rp.space}"]
    cfg = config_from_args(argv)
    G, D = build_models(cfg, rp)
    G, D = G.to(dev).train(), D.to(dev).train()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    z = torch.randn((batch, cfg.z_size),
                    generator=torch.Generator().manual_seed(DP_Z_SEED))
    t0 = time.time()
    loss = losses.g_adversarial(D(G(z.to(dev))).float())
    torch.cuda.synchronize(dev)
    alive = torch.cuda.memory_allocated(dev) - base
    torch.autograd.grad(loss, list(G.parameters()))
    torch.cuda.synchronize(dev)
    return {"batch": batch, "networks_bytes": base,
            "after_forward_bytes": alive,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
            "seconds": time.time() - t0, "loss": loss.item()}


def tp_gloo_rank(local_rank: int, world: int, init_file: str, runs: list,
                 out_dir: str, tag: str, record: tuple, fault,
                 model: int = TP_MODEL, space: int = 1,
                 probe_batch: int = TP_PROBE_BATCH,
                 planted: str = "sigma", copies: dict = None) -> None:
    """A rank of ``world`` sharing card 0 through a gloo group this script
    makes, on a data x model or data x space grid (parallel/dist.py
    ``grid``); ``tp_rank``'s runs, then ``tp_memory_probe`` at
    ``probe_batch`` (none at 0), written to
    ``{tag}_probe_rank{r}.json``."""
    import torch
    import torch.distributed as tdist

    from gan3d_tpu_torch.parallel import dist

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tdist.init_process_group("gloo", init_method="file://" + init_file,
                             rank=local_rank, world_size=world,
                             timeout=dist.TIMEOUT)
    rp = dist.grid(local_rank, world, local_rank, world, device, model,
                   space)
    try:
        tp_rank(rp, runs, out_dir, tag, record=record, fault=fault,
                planted=planted, copies=copies)
        if probe_batch:
            probe = tp_memory_probe(rp, probe_batch)
            with open(os.path.join(out_dir,
                                   f"{tag}_probe_rank{rp.rank}.json"),
                      "w") as f:
                json.dump(probe, f)
        rp.barrier()
    finally:
        tdist.destroy_process_group()


def _tp_grads(out_dir: str, tag: str, i: int, world: int) -> tuple:
    """(rank 0's gathered gradients of run ``i``, whether every rank's are
    bit-equal to them: the replicated leaves' made alike over the model
    group, the shards gathered)."""
    import torch

    got = [torch.load(os.path.join(out_dir, f"{tag}_grads{i}_rank{r}.pt"),
                      weights_only=True) for r in range(world)]
    equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for other in got[1:] for ua, ub in zip(got[0], other)
                for a, b in zip(ua, ub))
    return got[0], equal


def _tp_memory(ranks: list, one_peak: int) -> dict:
    """Each rank's peak memory beside one process's."""
    peaks = {f"rank{r['rank']}": r["runs"][0]["max_memory_allocated"]
             for r in ranks}
    return {"per_rank_max_memory_allocated": peaks,
            "one_process_max_memory_allocated": one_peak,
            "per_rank_over_one_process": {k: v / one_peak
                                          for k, v in peaks.items()}}


def tp_phase(ca, cc, tmp: str, data: str, dp: dict) -> dict:
    """The flagship (64^3, filters 64, iterD 2, hinge) through the train
    CLI's entry point with --model_devices=2, TP_STEPS steps a run:

    1. two ranks sharing the card over a gloo group the script makes
       (NCCL refuses two ranks on one card), f32, data 1 x model 2, at
       batch TP_GLOO_BATCH (gloo stages every gather through the host),
       against the one-process f32 run on the same batch: step-0 losses
       within 1e-4 relative, step 1's within DP_TOL or 3x the floor's,
       step 0's gradients before Adam gathered whole by ``grad_check``
       (each update's largest error within 5e-4 of its largest gradient
       or 3x the floor's: one process again with BN's statistics by the
       formula the sharded BN runs, ``bn_formula``; the dp phase's 5e-4
       is 3x that floor at batch 16) and bit-equal on both ranks, G's
       and D's outputs after the steps (``_dp_compare``), the replica
       check, K1 8 / K2 6 launches a step on each rank, energy.json with
       2 chips, each rank's peak memory beside one process's, vol/s;
       ``tp_memory_probe`` at batch TP_PROBE_BATCH (one G update's
       forward and backward: the bytes alive after the forward and the
       peak, each rank beside one process; G's loss 1e-4); then the
       control:
       a sharded spectral norm's sigma taken on the rank's slice
       (``_sigma_on_the_slice``; iterD 1, one step), whose first D
       update's gradients the gradient check must fail;
    2. NCCL across cards in bf16 at batch 16 where there are several:
       model 2 over 2 cards, and data 2 x model 2 over 4 where there are
       4; K1/K2 launches a step on each rank, the replica check, each
       rank's peak memory, vol/s and the step-0 losses beside the
       one-process bf16 run's (the dp phase's); on one card a line says
       it was not run.
    """
    import torch
    import torch.multiprocessing as mp

    t0 = time.time()
    out_dir = os.path.join(tmp, "tp")
    os.makedirs(out_dir, exist_ok=True)
    base = FLAGSHIP + [f"--data_path={data}", f"--niters={TP_STEPS}"]
    tp_flags = [f"--model_devices={TP_MODEL}"]
    res = {}

    # 1. two ranks on one card over gloo, f32, against one process
    f32 = base + ["--compute_dtype=float32", f"--batch_size={TP_GLOO_BATCH}"]
    iter_d = int(next(f for f in WIDTHS if f.startswith("--iterD="))[8:])
    one32 = _dp_one_process(ca, cc, f32 + [f"--log_dir={tmp}/tp_one32"],
                            "tp_one32", record=iter_d + 1)
    with bn_formula():
        floor32 = _dp_one_process(
            ca, cc, f32 + [f"--log_dir={tmp}/tp_floor32"], "tp_floor32",
            record=iter_d + 1)
    names = param_names(f32)
    floor = {**grad_check(floor32.pop("grads"), one32["grads"], names),
             **_dp_compare(one32["log_dir"], floor32["log_dir"]),
             "losses_step1_rel_err": _rel(
                 _ckpt_losses(floor32["log_dir"], 1),
                 _ckpt_losses(one32["log_dir"], 1))}
    # DP_GRAD_TOL is 3x the floor at batch 16; at a smaller batch the
    # floor is higher (G's BN backward cancels more), and the same 3x holds
    grad_tol = max(DP_GRAD_TOL, 3 * floor["grad_err"])
    one_probe = tp_memory_probe()
    torch.cuda.empty_cache()  # the ranks' processes share the card
    tp_argv = f32 + tp_flags + [f"--num_devices={TP_MODEL}"]
    runs = [tp_argv + [f"--log_dir={tmp}/tp_gloo2", "--track_energy=True"],
            tp_argv + [f"--log_dir={tmp}/tp_gloo2_fault", "--niters=1",
                       "--iterD=1"]]
    init_file = os.path.join(out_dir, "gloo_rendezvous")
    mp.start_processes(tp_gloo_rank, args=(TP_MODEL, init_file, runs,
                                           out_dir, "gloo2", (0, 1), 1),
                       nprocs=TP_MODEL, join=True, start_method="spawn")
    ranks = _dp_read(out_dir, "gloo2", TP_MODEL)
    w2 = _dp_rank_checks("tp_gloo2", ranks, "", TP_STEPS,
                         f"{tmp}/tp_gloo2")
    rel = _rel(w2["losses_step0"], one32["losses_step0"])
    rel1 = _rel(_ckpt_losses(f"{tmp}/tp_gloo2", 1),
                _ckpt_losses(one32["log_dir"], 1))
    tol1 = max(DP_TOL, 3 * floor["losses_step1_rel_err"])
    cmp2 = _dp_compare(one32["log_dir"], f"{tmp}/tp_gloo2")
    got, equal = _tp_grads(out_dir, "gloo2", 0, TP_MODEL)
    grads2 = grad_check(got, one32["grads"], names)
    if not (rel <= 1e-4 and rel1 <= tol1 and _dp_within(cmp2)
            and _grads_within(grads2, grad_tol) and equal):
        raise AssertionError(f"model 2 vs one process (f32): step-0 loss rel "
                             f"err {rel:.3e} (tol 1e-4), step 1 {rel1:.3e} "
                             f"(tol {tol1:.3e}), {cmp2} (tols: _dp_compare), "
                             f"gradients bit-equal on the ranks: {equal}, "
                             f"{grads2} (tol {grad_tol:.3e}); the floor: "
                             f"{floor}")
    with open(os.path.join(tmp, "tp_gloo2", "energy.json")) as f:
        energy = json.load(f)
    if energy["chips"] != TP_MODEL:
        raise AssertionError(f"energy.json {energy}: not {TP_MODEL} chips")
    # the control: sigma on the slice, one D update and the G update; its
    # first D update's gradients against one process's, which the
    # gradient check must fail
    fault_got, _ = _tp_grads(out_dir, "gloo2", 1, TP_MODEL)
    fault = grad_check(fault_got[:1], one32["grads"][:1], names)
    fault["caught_by"] = ["gradients"] if not _grads_within(
        fault, grad_tol) else []
    if not fault["caught_by"]:
        raise AssertionError(f"the checks passed the control's planted "
                             f"fault (sigma on the slice): {fault}")
    probes = []
    for r in range(TP_MODEL):
        with open(os.path.join(out_dir, f"gloo2_probe_rank{r}.json")) as f:
            probes.append(json.load(f))
    memory = {"one_process": one_probe,
              **{f"rank{r}": p for r, p in enumerate(probes)},
              "after_forward_over_one_process": [
                  p["after_forward_bytes"] / one_probe["after_forward_bytes"]
                  for p in probes],
              "peak_over_one_process": [
                  p["peak_bytes"] / one_probe["peak_bytes"] for p in probes],
              "loss_rel_err": max(abs(p["loss"] - one_probe["loss"])
                                  / abs(one_probe["loss"]) for p in probes)}
    if not memory["loss_rel_err"] <= 1e-4:
        raise AssertionError(f"memory probe: G loss at model 2 vs one "
                             f"process {memory['loss_rel_err']:.3e} (tol "
                             "1e-4)")
    res["gloo_model2_f32"] = {
        **w2, **cmp2, **grads2, "grad_tol": grad_tol,
        "batch": TP_GLOO_BATCH,
        "losses_step0_rel_err": rel, "tol": 1e-4,
        "losses_step1_rel_err": rel1, "losses_step1_tol": tol1,
        "grad_floor": floor, "grads_bit_equal_on_ranks": equal,
        "planted_fault_control": fault, "energy": energy,
        **_tp_memory(ranks, one32["max_memory_allocated"]),
        "one_process_f32_vol_per_s": one32["steady_vol_per_s"],
        "memory_probe": memory, "seconds": time.time() - t0}
    phase("tp_gloo2", **res["gloo_model2_f32"])
    # the one-process f32 control, which the spatial phase reads beside
    # its own ranks (same flags and batch)
    res["_one32"] = one32
    res.update(tp_nccl(tmp, data, dp["_one"]))
    res["seconds"] = time.time() - t0
    return res


def tp_nccl(tmp: str, data: str, one: dict) -> dict:
    """The tp phase's NCCL part (``tp_phase`` item 2), beside ``one``, the
    dp phase's one-process bf16 run at batch 16."""
    import torch

    from gan3d_tpu_torch.parallel import dist

    out_dir = os.path.join(tmp, "tp")
    os.makedirs(out_dir, exist_ok=True)
    base = FLAGSHIP + [f"--data_path={data}", f"--niters={TP_STEPS}",
                       f"--model_devices={TP_MODEL}"]
    res = {}
    worlds = [w for w in (2, 4) if w <= min(torch.cuda.device_count(),
                                            DP_MAX_CARDS)]
    for n in worlds:
        argvn = base + [f"--log_dir={tmp}/tp_nccl{n}", f"--num_devices={n}"]
        dist.launch(tp_rank, ([argvn], out_dir, f"nccl{n}"),
                    dist.Plan(world=n, local=n, first=0, device="cuda",
                              model=TP_MODEL))
        ranks = _dp_read(out_dir, f"nccl{n}", n)
        wn = _dp_rank_checks(f"tp_nccl{n}", ranks, "_tc", TP_STEPS,
                             f"{tmp}/tp_nccl{n}")
        res[f"nccl_world{n}_bf16"] = {
            **wn, "data": n // TP_MODEL, "model": TP_MODEL,
            "losses_step0_rel_err_vs_one_process_bf16": _rel(
                wn["losses_step0"], one["losses_step0"]),
            **_tp_memory(ranks, one["max_memory_allocated"]),
            "one_process_bf16_vol_per_s": one["steady_vol_per_s"]}
        phase(f"tp_nccl{n}", **res[f"nccl_world{n}_bf16"])
    if not worlds:
        res["nccl_multi_card"] = (f"not run: {torch.cuda.device_count()} "
                                  "card(s) visible")
        phase("tp_nccl_multi_card", not_run=res["nccl_multi_card"])
    return res


# ---------------------------------------------------------------------------
# the spatial phase: depth slabs over a space axis (slice 12)
# ---------------------------------------------------------------------------
def sp_phase(ca, cc, tmp: str, data: str, dp: dict, tp_res: dict) -> dict:
    """The flagship (64^3, filters 64, iterD 2, hinge) through the train
    CLI's entry point with --spatial_devices=2:

    1. two ranks sharing the card over a gloo group the script makes
       (data 1 x space 2), f32 at batch TP_GLOO_BATCH, SP_STEPS steps,
       against the tp phase's one-process f32 run of the same flags and
       batch: step-0 losses within SP_LOSS_TOL relative, step 0's
       gradients before Adam by ``grad_check`` within the tp phase's
       limit (5e-4 of each update's largest or 3x its ``bn_formula``
       floor) and bit-equal on both ranks, G's and D's outputs after the
       steps (``_dp_compare``), the replica check, K1 8 / K2 6 launches a
       step on each rank (each rank's queries are its slab), energy.json
       with 2 chips, each rank's peak; step 1's losses are read beside
       the tp floor's, not held to it: Adam's first update moves every
       noise-level gradient component by its full step, so step 1
       follows the rounding of step 0 (PERF.md); instead the run's
       checkpoint after the steps is resumed for one more step at space 2
       and in one process, whose losses must agree within SP_LOSS_TOL
       (the second step from one state: Adam's moments, the SN vectors
       and the running stats as trained); then the control: the halo of
       every conv taken as zeros (``_halo_of_zeros``; iterD 1, one step),
       whose first D update's gradients the gradient check must fail;
       then --dcgan (LayerNorm D) and --msl, one step each, the step-0
       losses against one process's within SP_FAMILY_TOL; then StyleGAN2
       and StyleGAN-1 with the conv knobs (SP_SG_RUNS, one step each at
       their widths) against one-process f32 runs of the same flags:
       step-0 losses within SP_FAMILY_TOL, step 0's gradients within the
       same limit and bit-equal on both ranks, the replica check, and on
       each rank K4 / K3 (f32 routes) launched as the StyleGAN-1 step
       implies on its halo'd slabs; then StyleGAN2 with halos of zeros,
       whose first D update the gradient check must fail; then
       ``tp_memory_probe`` at SP_PROBE_BATCH on each rank beside one
       process;
    2. NCCL across cards (``sp_nccl``, after the train128 phase).
    """
    import torch
    import torch.multiprocessing as mp

    t0 = time.time()
    out_dir = os.path.join(tmp, "sp")
    os.makedirs(out_dir, exist_ok=True)
    tpg = tp_res["gloo_model2_f32"]
    one32 = tp_res["_one32"]
    base = FLAGSHIP + [f"--data_path={data}", f"--niters={SP_STEPS}",
                       "--compute_dtype=float32",
                       f"--batch_size={TP_GLOO_BATCH}"]
    names = param_names(base)
    grad_tol = tpg["grad_tol"]
    iter_d = int(next(f for f in WIDTHS if f.startswith("--iterD="))[8:])
    # the DCGAN family's one-process controls (one step, f32)
    dcgan = {}
    for name, flags in SP_DCGAN_RUNS:
        argv = flags + [f"--data_path={data}", "--niters=1",
                        "--compute_dtype=float32",
                        f"--batch_size={TP_GLOO_BATCH}"]
        dcgan[name] = (argv, _dp_one_process(
            ca, cc, argv + [f"--log_dir={tmp}/sp_one_{name}"], name))
    # StyleGAN2 and StyleGAN-1's one-process controls (one step, f32),
    # their step-0 gradients recorded
    sg = {}
    for name, flags in SP_SG_RUNS:
        argv = flags + [f"--data_path={data}", "--niters=1",
                        "--compute_dtype=float32",
                        f"--batch_size={TP_GLOO_BATCH}"]
        sg[name] = (argv, _dp_one_process(
            ca, cc, argv + [f"--log_dir={tmp}/sp_one_{name}"], name,
            record=iter_d + 1))
    one_probe = tp_memory_probe(batch=SP_PROBE_BATCH)
    torch.cuda.empty_cache()  # the ranks' processes share the card
    sp_flags = [f"--spatial_devices={SP_SPACE}", f"--num_devices={SP_SPACE}"]
    runs = ([base + sp_flags + [f"--log_dir={tmp}/sp_gloo2",
                                "--track_energy=True"],
             base + sp_flags + [f"--log_dir={tmp}/sp_gloo2_fault",
                                "--niters=1", "--iterD=1"]]
            + [argv + sp_flags + [f"--log_dir={tmp}/sp_gloo2_{name}"]
               for name, (argv, _) in dcgan.items()]
            + [base + sp_flags + [f"--log_dir={tmp}/sp_gloo2_resume",
                                  f"--niters={SP_STEPS + 1}"]])
    copies = {len(runs) - 1: (f"{tmp}/sp_gloo2", f"{tmp}/sp_gloo2_resume")}
    first_sg = len(runs)
    runs += [argv + sp_flags + [f"--log_dir={tmp}/sp_gloo2_{name}"]
             for name, (argv, _) in sg.items()]
    sg2_argv = sg["stylegan2"][0]
    runs.append(sg2_argv + sp_flags + [f"--log_dir={tmp}/sp_gloo2_sg_fault",
                                       "--iterD=1"])
    sg_fault = len(runs) - 1
    record = (0, 1) + tuple(range(first_sg, len(runs)))
    init_file = os.path.join(out_dir, "gloo_rendezvous")
    mp.start_processes(tp_gloo_rank, args=(SP_SPACE, init_file, runs,
                                           out_dir, "gloo2", record,
                                           (1, sg_fault), 1, SP_SPACE,
                                           SP_PROBE_BATCH, "halo", copies),
                       nprocs=SP_SPACE, join=True, start_method="spawn")
    # the same resume in one process, from the same checkpoint
    shutil.copytree(f"{tmp}/sp_gloo2", f"{tmp}/sp_one_resume")
    _dp_one_process(ca, cc, base + [f"--log_dir={tmp}/sp_one_resume",
                                    f"--niters={SP_STEPS + 1}"],
                    "sp_one_resume")
    resume = {"losses": _ckpt_losses(f"{tmp}/sp_gloo2_resume", SP_STEPS),
              "one_process_losses": _ckpt_losses(f"{tmp}/sp_one_resume",
                                                 SP_STEPS)}
    resume["rel_err"] = _rel(resume["losses"], resume["one_process_losses"])
    ranks = _dp_read(out_dir, "gloo2", SP_SPACE)
    w2 = _dp_rank_checks("sp_gloo2", ranks, "", SP_STEPS, f"{tmp}/sp_gloo2")
    rel = _rel(w2["losses_step0"], one32["losses_step0"])
    rel1 = _rel(_ckpt_losses(f"{tmp}/sp_gloo2", 1),
                _ckpt_losses(one32["log_dir"], 1))
    cmp2 = _dp_compare(one32["log_dir"], f"{tmp}/sp_gloo2")
    got, equal = _tp_grads(out_dir, "gloo2", 0, SP_SPACE)
    grads2 = grad_check(got, one32["grads"], names)
    if not (rel <= SP_LOSS_TOL and resume["rel_err"] <= SP_LOSS_TOL
            and _dp_within(cmp2) and _grads_within(grads2, grad_tol)
            and equal):
        raise AssertionError(
            f"space 2 vs one process (f32): step-0 loss rel err {rel:.3e} "
            f"(tol {SP_LOSS_TOL}), the resumed step {resume} (tol "
            f"{SP_LOSS_TOL}), {cmp2} (tols: _dp_compare), gradients "
            f"bit-equal on the ranks: {equal}, {grads2} (tol "
            f"{grad_tol:.3e}); step 1 (read, not held) {rel1:.3e}, the "
            f"tp floor's {tpg['grad_floor']['losses_step1_rel_err']:.3e}")
    with open(os.path.join(tmp, "sp_gloo2", "energy.json")) as f:
        energy = json.load(f)
    if energy["chips"] != SP_SPACE:
        raise AssertionError(f"energy.json {energy}: not {SP_SPACE} chips")
    # the control: every halo zeros, one D update and the G update; its
    # first D update's gradients against one process's
    fault_got, _ = _tp_grads(out_dir, "gloo2", 1, SP_SPACE)
    fault = grad_check(fault_got[:1], one32["grads"][:1], names)
    fault["caught_by"] = ["gradients"] if not _grads_within(
        fault, grad_tol) else []
    if not fault["caught_by"]:
        raise AssertionError(f"the checks passed the control's planted "
                             f"fault (halos of zeros): {fault}")
    families = {}
    for i, (name, (_, one)) in enumerate(dcgan.items(), start=2):
        log_dir = f"{tmp}/sp_gloo2_{name}"
        out0 = ranks[0]["runs"][i]["stdout"]
        if f"on all {SP_SPACE} ranks" not in out0 or ranks[1]["runs"][i][
                "stdout"]:
            raise AssertionError(f"sp {name}: no passed replica check, or "
                                 "rank 1 printed")
        families[name] = {"losses_step0": _ckpt_losses(log_dir),
                          "one_process_losses_step0": one["losses_step0"],
                          "losses_step0_rel_err": _rel(
                              _ckpt_losses(log_dir), one["losses_step0"]),
                          "launches": ranks[0]["runs"][i]["launches"]}
        if not families[name]["losses_step0_rel_err"] <= SP_FAMILY_TOL:
            raise AssertionError(f"sp {name} vs one process (f32): "
                                 f"{families[name]} (tol {SP_FAMILY_TOL})")
    stylegan = sp_stylegan_checks(ranks, sg, first_sg, sg_fault, out_dir,
                                  grad_tol, tmp)
    probes = []
    for r in range(SP_SPACE):
        with open(os.path.join(out_dir, f"gloo2_probe_rank{r}.json")) as f:
            probes.append(json.load(f))
    memory = {"one_process": one_probe,
              **{f"rank{r}": p for r, p in enumerate(probes)},
              "after_forward_over_one_process": [
                  p["after_forward_bytes"] / one_probe["after_forward_bytes"]
                  for p in probes],
              "peak_over_one_process": [
                  p["peak_bytes"] / one_probe["peak_bytes"] for p in probes],
              "loss_rel_err": max(abs(p["loss"] - one_probe["loss"])
                                  / abs(one_probe["loss"]) for p in probes)}
    if not memory["loss_rel_err"] <= 1e-4:
        raise AssertionError(f"memory probe: G loss at space 2 vs one "
                             f"process {memory['loss_rel_err']:.3e} (tol "
                             "1e-4)")
    res = {"gloo_space2_f32": {
        **w2, **cmp2, **grads2, "grad_tol": grad_tol,
        "batch": TP_GLOO_BATCH, "losses_step0_rel_err": rel,
        "tol": SP_LOSS_TOL, "losses_step1_rel_err": rel1,
        "losses_step1": _ckpt_losses(f"{tmp}/sp_gloo2", 1),
        "resumed_step": resume, "grads_bit_equal_on_ranks": equal,
        "losses_step1_floor_rel_err": tpg["grad_floor"][
            "losses_step1_rel_err"], "planted_fault_control": fault,
        "energy": energy, "families": families,
        **_tp_memory(ranks, one32["max_memory_allocated"]),
        "one_process_f32_vol_per_s": one32["steady_vol_per_s"],
        "memory_probe": memory, "seconds": time.time() - t0}}
    phase("sp_gloo2", **res["gloo_space2_f32"])
    for name, got in stylegan.items():
        res[f"gloo_space2_f32_{name}"] = got
        phase(f"sp_gloo2_{name}", **got)
    res["seconds"] = time.time() - t0
    return res


def sp_stylegan_checks(ranks: list, sg: dict, first: int, fault: int,
                       out_dir: str, grad_tol: float, tmp: str) -> dict:
    """The spatial phase's StyleGAN runs on the gloo ranks (runs
    ``first``, ... in SP_SG_RUNS order, and the control ``fault``) against
    their one-process controls ``sg``: the replica check and rank 0 alone
    printing, step-0 losses within SP_FAMILY_TOL, step 0's gradients by
    ``grad_check`` within ``grad_tol`` and bit-equal on both ranks, K4 /
    K3 launches on each rank as the StyleGAN-1 knob step implies (f32
    routes; none in StyleGAN2), and the control's first D update failing
    the gradient check."""
    out = {}
    for i, (name, (argv, one)) in enumerate(sg.items(), start=first):
        log_dir = f"{tmp}/sp_gloo2_{name}"
        out0 = ranks[0]["runs"][i]["stdout"]
        if f"on all {SP_SPACE} ranks" not in out0 or ranks[1]["runs"][i][
                "stdout"]:
            raise AssertionError(f"sp {name}: no passed replica check, or "
                                 "rank 1 printed")
        knobs = "--wide_conv=on" in argv
        want = expected_conv_launches(0, 1, 2, 50, len(CONV_SG1) if knobs
                                      else 0, 0, knobs, knobs)
        per_rank = {}
        for r in ranks:
            got = r["runs"][i]["launches"]
            if (got["wide"], got["dw"], got["wide_tc"], got["dw_tc"],
                    got["fwd"], got["bwd"]) != (want["wide_tc"],
                                                want["dw_tc"], 0, 0, 0, 0):
                raise AssertionError(f"sp {name} rank {r['rank']}: launches "
                                     f"{got}, want K4 {want['wide_tc']} and "
                                     f"K3 {want['dw_tc']} (f32 routes)")
            per_rank[f"rank{r['rank']}"] = {
                "K4": got["wide"], "K3": got["dw"],
                "max_memory_allocated": r["runs"][i]["max_memory_allocated"]}
        got, equal = _tp_grads(out_dir, "gloo2", i, SP_SPACE)
        grads = grad_check(got, one["grads"], param_names(argv))
        losses = _ckpt_losses(log_dir)
        rel = _rel(losses, one["losses_step0"])
        out[name] = {"per_rank": per_rank, "losses_step0": losses,
                     "one_process_losses_step0": one["losses_step0"],
                     "losses_step0_rel_err": rel, "tol": SP_FAMILY_TOL,
                     **grads, "grad_tol": grad_tol,
                     "grads_bit_equal_on_ranks": equal,
                     "launches_a_rank_want": want}
        if not (rel <= SP_FAMILY_TOL and _grads_within(grads, grad_tol)
                and equal):
            raise AssertionError(f"sp {name} vs one process (f32): "
                                 f"{out[name]}")
    # the control: halos of zeros in StyleGAN2, one D update and the G
    # update; its first D update's gradients against one process's
    argv, one = sg["stylegan2"]
    fault_got, _ = _tp_grads(out_dir, "gloo2", fault, SP_SPACE)
    chk = grad_check(fault_got[:1], one["grads"][:1], param_names(argv))
    chk["caught_by"] = ["gradients"] if not _grads_within(
        chk, grad_tol) else []
    if not chk["caught_by"]:
        raise AssertionError(f"the checks passed StyleGAN2's planted fault "
                             f"(halos of zeros): {chk}")
    out["stylegan2"]["planted_fault_control"] = chk
    return out


def sp_nccl(tmp: str, data: str, one: dict, one_sg: dict,
            one128: dict) -> dict:
    """The spatial phase's NCCL part, where there are several cards (on
    one card a line says it was not run), in bf16 at batch 16: the
    flagship at S = 2 over 2 cards and data 2 x space 2 over 4, beside
    ``one``, the dp phase's one-process bf16 run (step-0 losses, each
    rank's peak, vol/s); StyleGAN2 and StyleGAN-1 at S = 2 over 2 cards,
    beside ``one_sg``, the train phase's one-process runs of the same
    flags (vol/s, peak); the reference's 128^3 widths without remat at S
    = 2 over 2 cards (the run that hung before its BatchNorm statistics
    and halos shared one communicator: PERF.md's C4), its step-0 losses
    against ``one128``'s (the train128 phase's remat run of the same
    widths) to bf16 rounding (2^-7 of the larger |loss|, at least 2^-7),
    K1 8 / K2 6 launches a step on each rank."""
    import torch

    from gan3d_tpu_torch.parallel import dist

    out_dir = os.path.join(tmp, "sp")
    os.makedirs(out_dir, exist_ok=True)
    cards = min(torch.cuda.device_count(), DP_MAX_CARDS)
    res = {}
    sp_flags = [f"--niters={SP_STEPS}", f"--spatial_devices={SP_SPACE}"]

    def launch(tag, argv, n, attention):
        dist.launch(tp_rank, ([argv + [f"--log_dir={tmp}/sp_{tag}",
                                       f"--num_devices={n}"]],
                              out_dir, tag),
                    dist.Plan(world=n, local=n, first=0, device="cuda",
                              space=SP_SPACE))
        ranks = _dp_read(out_dir, tag, n)
        return ranks, _dp_rank_checks(f"sp_{tag}", ranks, "_tc", SP_STEPS,
                                      f"{tmp}/sp_{tag}", attention)

    base = FLAGSHIP + [f"--data_path={data}"] + sp_flags
    for n in [w for w in (2, 4) if w <= cards]:
        ranks, wn = launch(f"nccl{n}", base, n, (1, 1))
        res[f"nccl_world{n}_bf16"] = {
            **wn, "data": n // SP_SPACE, "space": SP_SPACE,
            "losses_step0_rel_err_vs_one_process_bf16": _rel(
                wn["losses_step0"], one["losses_step0"]),
            **_tp_memory(ranks, one["max_memory_allocated"]),
            "one_process_bf16_vol_per_s": one["steady_vol_per_s"]}
        phase(f"sp_nccl{n}", **res[f"nccl_world{n}_bf16"])
    if cards < 2:
        res["nccl_multi_card"] = f"not run: {cards} card(s) visible"
        phase("sp_nccl_multi_card", not_run=res["nccl_multi_card"])
        return res
    for name, flags in (("stylegan2", SG2), ("stylegan", SG1)):
        ranks, w2 = launch(f"nccl2_{name}", flags + [
            f"--data_path={data}"] + sp_flags, 2, (0, 0))
        res[f"nccl_world2_bf16_{name}"] = {
            **w2, "data": 1, "space": SP_SPACE,
            **_tp_memory(ranks, one_sg[name]["max_memory_allocated"]),
            "one_process_bf16_vol_per_s": one_sg[name]["steady_vol_per_s"]}
        phase(f"sp_nccl2_{name}", **res[f"nccl_world2_bf16_{name}"])
    data128 = os.path.join(tmp, "train128.npz")
    ranks, w2 = launch("nccl2_ref128", REF128 + [
        "--remat=False", f"--data_path={data128}"] + sp_flags, 2, (1, 1))
    want = one128["loss_d0"] + [one128["loss_g0"]]
    err = max(abs(x - y) / max(1.0, abs(y))
              for x, y in zip(w2["losses_step0"], want))
    res["nccl_world2_bf16_ref128"] = {
        **w2, "data": 1, "space": SP_SPACE,
        "one_process_losses_step0": want, "losses_step0_rel_err": err,
        "tol": 2 ** -7,
        **_tp_memory(ranks, one128["max_memory_allocated"]),
        "one_process_remat_bf16_vol_per_s": one128["steady_vol_per_s"]}
    phase("sp_nccl2_ref128", **res["nccl_world2_bf16_ref128"])
    if not err <= 2 ** -7:
        raise AssertionError(f"128^3 at space 2 over 2 cards vs one process: "
                             f"{res['nccl_world2_bf16_ref128']}")
    return res


def r256_data(tmp: str) -> str:
    """R256_VOLUMES volumes tanh(N(0, 1)) of 256^3 (seed 0) in an npz in
    ``tmp`` (1.07 GB), written once."""
    import numpy as np

    path = os.path.join(tmp, "train256.npz")
    if not os.path.exists(path):
        x = np.random.default_rng(0).standard_normal(
            (R256_VOLUMES, 256, 256, 256), np.float32)
        np.tanh(x, out=x)
        np.savez(path, X=x)
    return path


def sp_gloo4_r256(ca, cc, tmp: str, grad_tol: float = DP_GRAD_TOL) -> dict:
    """BigGAN-Deep at 256^3 (R256_GLOO: filters 8, batch 2, iterD 1, f32,
    remat per stage, the split step) through the train CLI's entry point
    on four ranks sharing the card over a gloo group the script makes
    (data 1 x space 4: 64 planes a rank; the 4^3 grid whole), one step,
    against one process on the card with the same flags and seed, run
    while the ranks run (``one_process_seconds`` and ``ranks_seconds``
    are read so; cuDNN
    deterministic, TF32 off as everywhere): step-0 losses within
    SP_LOSS_TOL relative, step 0's gradients before Adam by
    ``grad_check`` within ``grad_tol`` of each update's largest (the
    spatial phase's limit: 5e-4 or 3x the tp phase's ``bn_formula``
    floor; this run's own floor read 2.98e-4 of the G update's largest
    on an H100), and bit-equal on every rank; the replica check;
    K1 7 / K2 4 launches on each rank (f32 routes: G's attention in the
    D update's no-grad G, the G update's G and the two sample grids; D's
    in D(real), D(fake) and the G update's D; the backward of each but
    the no-grad and sample forwards), on its L / 4 queries; each rank's
    peak beside the control's; the seconds."""
    import torch.multiprocessing as mp

    t0 = time.time()
    out_dir = os.path.join(tmp, "r256")
    os.makedirs(out_dir, exist_ok=True)
    base = R256_GLOO + [f"--data_path={r256_data(tmp)}", "--niters=1"]
    iter_d = int(next(f for f in R256_GLOO if f.startswith("--iterD="))[8:])
    argv = base + [f"--spatial_devices={R256_SPACE}",
                   f"--num_devices={R256_SPACE}",
                   f"--log_dir={tmp}/r256_gloo4"]
    # the control runs here while the ranks start and run beside it
    t1 = time.time()
    ranks_run = mp.start_processes(tp_gloo_rank, args=(
        R256_SPACE, os.path.join(out_dir, "gloo_rendezvous"), [argv],
        out_dir, "gloo4", (0,), -1, 1, R256_SPACE, 0),
        nprocs=R256_SPACE, join=False, start_method="spawn")
    try:
        one = _dp_one_process(ca, cc, base + [f"--log_dir={tmp}/r256_one"],
                              "r256_one", record=iter_d + 1)
        names = param_names(base, device="cpu")
        while not ranks_run.join():
            pass
    finally:
        for proc in ranks_run.processes:
            if proc.is_alive():
                proc.terminate()
    ranks_s = time.time() - t1
    ranks = _dp_read(out_dir, "gloo4", R256_SPACE)
    w4 = _dp_rank_checks("sp_gloo4_r256", ranks, "", 1,
                         f"{tmp}/r256_gloo4", (1, 1), iter_d=iter_d)
    rel = _rel(w4["losses_step0"], one["losses_step0"])
    got, equal = _tp_grads(out_dir, "gloo4", 0, R256_SPACE)
    grads = grad_check(got, one["grads"], names)
    res = {**w4, "resolution": 256, "data": 1, "space": R256_SPACE,
           "flags": R256_GLOO, "one_process_losses_step0":
           one["losses_step0"], "losses_step0_rel_err": rel,
           "tol": SP_LOSS_TOL, **grads, "grad_tol": grad_tol,
           "grads_bit_equal_on_ranks": equal,
           **_tp_memory(ranks, one["max_memory_allocated"]),
           "one_process_seconds": one["seconds"],
           "ranks_seconds": ranks_s, "seconds": time.time() - t0}
    if not (rel <= SP_LOSS_TOL and _grads_within(grads, grad_tol)
            and equal):
        raise AssertionError(f"256^3 at space 4 vs one process (f32): {res}")
    return res


def _param_bytes(log_dir: str) -> int:
    """Bytes of the floating-point tensors of G's and D's state dicts in
    the run's checkpoint (read through a memory map)."""
    import torch

    ckpt = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                      map_location="cpu", weights_only=True, mmap=True)
    return sum(t.numel() * t.element_size()
               for key in ("modelG_state_dict", "modelD_state_dict")
               for t in ckpt[key].values() if t.is_floating_point())


def sp_nccl4_r256(ca, cc, tmp: str, control: bool = False) -> dict:
    """The 256^3 flagship's widths (R256_WIDTHS: filters 64, z 512, iterD
    2, bf16, remat and the split step) on data 1 x space 4 over 4 NCCL
    cards, where there are 4 (else a line says it was not run; with
    ``control`` the one-process control runs on one card all the same):

    1. the one-process control on one card at batch R256_CHECK_BATCH,
       one step with remat per R256_SCOPE: peak and reserved memory, the
       allocator's retries, the seconds;
    2. one launch of the 4 ranks: space 4 at batch R256_CHECK_BATCH (one
       step: step-0 losses against the control's to bf16 rounding, 2^-7
       of the larger |loss|, at least 2^-7, as sp_nccl2_ref128; K1 10 /
       K2 6 on each rank), then R256_STEPS steps at R256_BATCH: the
       trainer's steady vol/s (rank 0's clock from the end of step 0 to
       the end of the last step, every rank in step with it through the
       collectives), each rank's peak and reserved memory and allocator
       retries, K1 26 / K2 18 on each rank, the replica check; and
       the peak the unsharded step would need at that batch, reckoned
       from the control's: the networks' bytes x 3 (parameters,
       gradients, Adam's second moment; b1 = 0 keeps no first) plus the
       rest of the control's peak scaled by batch / R256_CHECK_BATCH."""
    import torch

    from gan3d_tpu_torch.parallel import dist

    cards = torch.cuda.device_count()
    not_run = (f"{cards} card(s) visible, space {R256_SPACE} over NCCL "
               f"needs {R256_SPACE}")
    if cards < R256_SPACE and not control:
        return {"not_run": not_run}
    t0 = time.time()
    data = r256_data(tmp)
    widths = R256_WIDTHS + [f"--data_path={data}",
                            f"--remat_scope={R256_SCOPE}"]
    flags = widths + [f"--batch_size={R256_CHECK_BATCH}"]
    log_dir = f"{tmp}/r256_one_{R256_SCOPE}"
    one = train_run(ca, cc, f"r256_one_{R256_SCOPE}", flags,
                    flags + [f"--log_dir={log_dir}"], 1, 0, (1, 1))
    one["losses_step0"] = one["loss_d0"] + [one["loss_g0"]]
    torch.cuda.empty_cache()
    res = {"one_process": one, "scope": R256_SCOPE}
    if cards < R256_SPACE:
        return {**res, "not_run": not_run, "seconds": time.time() - t0}
    out_dir = os.path.join(tmp, "r256")
    os.makedirs(out_dir, exist_ok=True)
    flags = widths + [f"--spatial_devices={R256_SPACE}",
                      f"--num_devices={R256_SPACE}"]
    plan = dist.Plan(world=R256_SPACE, local=R256_SPACE, first=0,
                     device="cuda", space=R256_SPACE)
    runs = [flags + [f"--batch_size={R256_CHECK_BATCH}", "--niters=1",
                     f"--log_dir={tmp}/r256_nccl4_check"],
            flags + [f"--batch_size={R256_BATCH}", f"--niters={R256_STEPS}",
                     f"--log_dir={tmp}/r256_nccl4"]]
    dist.launch(tp_rank, (runs, out_dir, "nccl4"), plan,
                timeout=R256_WALL_S)
    ranks = _dp_read(out_dir, "nccl4", R256_SPACE)
    # the check: space 4 at batch R256_CHECK_BATCH against one process
    check = _dp_rank_checks("sp_nccl4_r256_check", ranks, "_tc", 1,
                            f"{tmp}/r256_nccl4_check", (1, 1))
    err = max(abs(x - y) / max(1.0, abs(y))
              for x, y in zip(check["losses_step0"], one["losses_step0"]))
    res["check"] = {**check, "batch": R256_CHECK_BATCH,
                    "one_process_losses_step0": one["losses_step0"],
                    "losses_step0_rel_err": err, "tol": 2 ** -7,
                    **_tp_memory(ranks, one["max_memory_allocated"])}
    if not err <= 2 ** -7:
        raise AssertionError(f"256^3 at space 4 over 4 cards vs one process "
                             f"at batch {R256_CHECK_BATCH}: {res['check']}")
    main = _dp_rank_checks("sp_nccl4_r256", ranks, "_tc", R256_STEPS,
                           f"{tmp}/r256_nccl4", (1, 1), run=1)
    for r in ranks:
        got = r["runs"][1]
        main["per_rank"][f"rank{r['rank']}"].update(
            max_memory_reserved=got["max_memory_reserved"],
            alloc_retries=got["alloc_retries"])
    static = 3 * _param_bytes(log_dir)
    res.update(main, batch=R256_BATCH, networks_and_adam_bytes=static,
               unsharded_peak_reckoned=static + (
                   one["max_memory_allocated"] - static)
               * R256_BATCH / R256_CHECK_BATCH,
               seconds=time.time() - t0)
    return res


# ``--r256``'s slab_bn line: the slab BatchNorm at one rank, forward and
# backward, on a depth slab's activation: G's last block at 64^3 (64
# channels, N 16) on a rank of a space group of 2 and 4, and G's 256^3
# block on a rank of 4 (2^32 values: bf16 alone, where the formula's f32
# copies would not fit).
SLAB_BN_SHAPES = (("flagship64_s2", (16, 64, 32, 64, 64)),
                  ("flagship64_s4", (16, 64, 16, 64, 64)),
                  ("r256_s4", (16, 64, 64, 256, 256)))


def slab_bn_timing() -> dict:
    """The slab BatchNorm (nn/norm.py ``_SlabBatchNorm``) at one rank on
    the card, its collective the identity: forward and backward ms of
    torch's SyncBatchNorm kernels (the route of a bf16 slab on the card)
    against the explicit formula (the route of an f32 slab and of the
    CPU), each forced through ``norm._native``, and one cuDNN BatchNorm on
    the whole tensor as a yardstick (both but at the 2^32 shape), at
    SLAB_BN_SHAPES in bf16 and f32 (bf16 alone at 2^32);
    the two routes' outputs and input gradients must agree to the dtype's
    rounding (2^-6 of the largest value in bf16, 1e-4 in f32)."""
    import torch
    import torch.nn.functional as F

    from gan3d_tpu_torch.nn import norm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    reduce, native = norm.dist.all_reduce, norm._native
    norm.dist.all_reduce = lambda t, group=None: t
    out = {}
    try:
        for name, shape in SLAB_BN_SHAPES:
            big = shape[2] > 32
            for dname, dt in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
                if big and dt == torch.float32:
                    continue
                x = torch.randn(shape, generator=gen, device="cuda").to(dt)
                gy = torch.randn(shape, generator=gen, device="cuda").to(dt)
                w = torch.rand(shape[1], generator=gen, device="cuda") + 0.5
                b = torch.randn(shape[1], generator=gen, device="cuda")
                leaves = [t.requires_grad_(True) for t in (x, w, b)]

                def slab():
                    y = norm._SlabBatchNorm.apply(*leaves, 1, None, 1, 0,
                                                  1e-5)[0]
                    return (y, *torch.autograd.grad(y, leaves, gy))

                def cudnn():
                    y = F.batch_norm(leaves[0], None, None, w, b, True, 0.1,
                                     1e-5)
                    return (y, *torch.autograd.grad(y, leaves, gy))

                iters = 3 if big else 10
                norm._native = lambda t: True
                case = {"shape": list(shape), "dtype": dname,
                        "native_ms": cuda_ms(slab, iters, 1)}
                if not big:
                    case["library_ms"] = cuda_ms(cudnn, iters, 1)
                    got = slab()
                    norm._native = lambda t: False
                    case["formula_ms"] = cuda_ms(slab, iters, 1)
                    want = slab()
                    case["rel_err"] = {
                        k: rel_err(a, e)[1]
                        for k, a, e in zip(("y", "dx", "dw", "db"), got,
                                           want)}
                    tol = 2 ** -6 if dt == torch.bfloat16 else 1e-4
                    if not max(case["rel_err"].values()) <= tol:
                        raise AssertionError(f"slab BN {name} {dname}: the "
                                             f"routes differ {case}")
                norm._native = native
                out[f"{name}/{dname}"] = case
                del x, gy, leaves
                torch.cuda.empty_cache()
    finally:
        norm.dist.all_reduce, norm._native = reduce, native
    return out


def _two_communicators(rp, sync: bool) -> tuple:
    """The slab BatchNorm's scope as it was when C4 hung: with ``sync``
    the default group, a second communicator over the space group's ranks
    at data 1."""
    if sync:
        return rp.group, rp.world, rp.rank
    return rp.space_group, rp.space, rp.space_rank


def c4_rank(local_rank: int, world: int, init_file: str, argv: list,
            out_dir: str, tag: str, two: bool) -> None:
    """A rank of ``c4_diag``: NCCL with a collective timeout of
    C4_TIMEOUT_S, the slab BatchNorm on two communicators (``two``) or
    on the space group's, one ``cli.train.train_rank`` run; writes
    ``{tag}_rank{r}.json``."""
    import datetime

    import torch

    from gan3d_tpu_torch.cli import train as cli_train
    from gan3d_tpu_torch.config import config_from_args
    from gan3d_tpu_torch.nn import norm
    from gan3d_tpu_torch.parallel import dist

    rp = dist.init(local_rank, world, "file://" + init_file, local_rank,
                   world, torch.device("cuda", local_rank),
                   timeout=datetime.timedelta(seconds=C4_TIMEOUT_S),
                   space=world)
    if two:
        norm.slab_scope = _two_communicators
    try:
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_train.train_rank(rp, config_from_args(argv))
        torch.cuda.synchronize()
        with open(os.path.join(out_dir, f"{tag}_rank{rp.rank}.json"),
                  "w") as f:
            json.dump({"seconds": time.time() - t0, "stdout": buf.getvalue(),
                       "max_memory_allocated":
                       torch.cuda.max_memory_allocated()}, f)
        rp.barrier()
    finally:
        torch.distributed.destroy_process_group()


def c4_diag(filters: int, tmp: str, two: bool = True,
            trial: int = 0) -> dict:
    """The run that hung (C4): the reference's 128^3 flags at ``filters``
    without remat, space 2 over 2 cards, 2 steps, the slab BatchNorm's
    statistics on a second communicator (``two``; else the space
    group's), under the environment's TORCH_DISTRIBUTED_DEBUG; whether it
    finished, its seconds and each rank's peak, or how it failed."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(tmp, f"c4_{filters}_{int(two)}_{trial}")
    os.makedirs(out_dir, exist_ok=True)
    argv = (REF128 + ["--remat=False", f"--filterG={filters}",
                      f"--filterD={filters}",
                      f"--data_path={tmp}/train128.npz",
                      f"--log_dir={out_dir}/run", f"--niters={SP_STEPS}",
                      f"--spatial_devices={SP_SPACE}",
                      f"--num_devices={SP_SPACE}"])
    t0 = time.time()
    try:
        mp.start_processes(c4_rank, args=(SP_SPACE, f"{out_dir}/rdv", argv,
                                          out_dir, "c4", two),
                           nprocs=SP_SPACE, join=True, start_method="spawn")
    except Exception as e:  # noqa: BLE001 — a hang's timeout is a reading
        return {"filters": filters, "two_communicators": two,
                "trial": trial, "finished": False,
                "seconds": time.time() - t0, "error": repr(e)[-2000:]}
    ranks = _dp_read(out_dir, "c4", SP_SPACE)
    return {"filters": filters, "two_communicators": two, "trial": trial,
            "finished": True,
            "seconds": time.time() - t0,
            "losses_step0": _ckpt_losses(f"{out_dir}/run"),
            "max_memory_allocated": [r["max_memory_allocated"]
                                     for r in ranks],
            **_done(ranks[0]["stdout"])}


def _c4_pairs(tmp: str, jobs: tuple, trials: int, detail: bool) -> None:
    """``c4_diag`` ``trials`` times for each (filters, two communicators,
    cards) of ``jobs``, each job a process of its own on its pair of
    cards, all at once (DETAIL with ``detail``), each ended by a wall
    limit of trials x C4_WALL_S; a line a job's exit."""
    procs = []
    for filters, two, cards in jobs:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards)
        if detail:
            env["TORCH_DISTRIBUTED_DEBUG"] = "DETAIL"
        procs.append(((filters, two), subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             f"--c4-diag={filters}", tmp, str(int(two)), str(trials)],
            env=env)))
    for (filters, two), proc in procs:
        try:
            rc = proc.wait(timeout=trials * C4_WALL_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        phase("c4_exit", filters=filters, two_communicators=two, rc=rc)


def _c4_setup(tmp: str, *libs: str) -> bool:
    """The 4-card modes' kernels and 128^3 data; False with fewer cards."""
    import numpy as np
    import torch

    if torch.cuda.device_count() < 4:
        print(f"chip_smoke: {torch.cuda.device_count()} card(s), the C4 "
              "modes need 4", file=sys.stderr)
        return False
    sys.path.insert(0, REPO)
    from gan3d_tpu_torch.ops import cuda_build
    from gan3d_tpu_torch.utils.platform import configure_precision

    configure_precision(torch.device("cuda"))
    cuda_build.build(*libs)
    np.savez(os.path.join(tmp, "train128.npz"), X=np.tanh(
        np.random.default_rng(0).standard_normal((16, 128, 128, 128),
                                                 np.float32)))
    return True


def c4_repeat_main() -> int:
    """``python3 chip_smoke.py --c4-repeat`` on a machine with 4 cards:
    the run that hung, as it ran (no DETAIL), C4_TRIALS times with the
    slab BatchNorm on two communicators on cards 0-1 and as many with
    one communicator on cards 2-3, at once; a line a trial."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_c4_") as tmp:
        if not _c4_setup(tmp, "pooled_attention"):
            return 1
        _c4_pairs(tmp, ((128, True, "0,1"), (128, False, "2,3")),
                  C4_TRIALS, detail=False)
    return 0


def c4_main() -> int:
    """``python3 chip_smoke.py --c4`` on a machine with 4 cards: the run
    that hung as it was (``c4_diag``, TORCH_DISTRIBUTED_DEBUG=DETAIL) at
    filters 128 on cards 2-3 and 64 on cards 0-1 at once; then the
    one-process controls and the spatial phase's multi-card runs as the
    script runs them (``sp_nccl``: the 128^3 run with one
    communicator). Prints a line a reading; exits non-zero when a
    multi-card run fails."""
    import numpy as np
    import torch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_c4_") as tmp:
        if not _c4_setup(tmp, "pooled_attention", "conv3d_k3"):
            return 1
        from gan3d_tpu_torch.ops import cuda_attention as ca
        from gan3d_tpu_torch.ops import cuda_conv as cc

        np.savez(os.path.join(tmp, "train.npz"), X=np.tanh(
            np.random.default_rng(0).standard_normal((48, 64, 64, 64),
                                                     np.float32)))
        _c4_pairs(tmp, ((128, True, "2,3"), (64, True, "0,1")), 1,
                  detail=True)
        one = _dp_one_process(ca, cc, FLAGSHIP + [
            f"--data_path={tmp}/train.npz", f"--log_dir={tmp}/one",
            f"--niters={DP_RATE_STEPS}"], "one")
        one_sg = {}
        for name, flags in (("stylegan2", SG2), ("stylegan", SG1)):
            one_sg[name] = train_run(ca, cc, name, flags, flags + [
                f"--data_path={tmp}/train.npz",
                f"--log_dir={tmp}/one_{name}"], 4, 0, (0, 0))
        one128 = train_run(ca, cc, "ref128", TRAIN128_RUNS[0][1],
                           TRAIN128_RUNS[0][1] + [
                               f"--data_path={tmp}/train128.npz",
                               f"--log_dir={tmp}/one128"], 2, 0, (1, 1))
        torch.cuda.empty_cache()
        sp_nccl(tmp, f"{tmp}/train.npz", one, one_sg, one128)
    print(json.dumps({"ok": True, "c4": True}), flush=True)
    return 0


def model_check(log_dir: str, cc, n: int = 1) -> dict:
    """The trained G and D, in f32 and eval mode, at batch ``n``: on the
    card (kernels, the run's conv routes) against the same weights on the
    CPU (plain attention, F.conv3d); the msl D crops at the same fixed
    offsets on both; StyleGAN2 by ``sg2_model_check``."""
    import torch

    from gan3d_tpu_torch.config import Config
    from gan3d_tpu_torch.models import build_models
    from gan3d_tpu_torch.ops.conv3d import (set_fast_dw_mode,
                                            set_wide_conv_mode)

    cfg = Config.load(log_dir).replace(compute_dtype="float32")
    payload = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                         map_location="cpu", weights_only=True)
    G, D = build_models(cfg)
    G.load_state_dict(payload["modelG_state_dict"])
    D.load_state_dict(payload["modelD_state_dict"])
    G.eval()
    D.eval()
    if cfg.family() == "stylegan2":
        return sg2_model_check(G, D, cfg)
    z = torch.randn((n, cfg.z_size), generator=torch.Generator().manual_seed(1))
    crops = {}
    try:
        set_wide_conv_mode("off")
        set_fast_dw_mode("off")
        with torch.no_grad():
            x_cpu = G(z)
            if getattr(D, "msl", False):
                crops["offsets"] = D.draw_offsets(
                    x_cpu, torch.Generator().manual_seed(2))
            d_cpu = D(x_cpu, **crops)
        set_wide_conv_mode(cfg.wide_conv)
        set_fast_dw_mode(cfg.fast_dw)
        cc.reset_counters()
        with torch.no_grad():
            Gc, Dc = copy.deepcopy(G).cuda(), copy.deepcopy(D).cuda()
            x_gpu = Gc(z.cuda())
            d_gpu = Dc(x_cpu.cuda(), **crops)
        torch.cuda.synchronize()
    finally:
        set_wide_conv_mode("auto")
        set_fast_dw_mode("auto")
    r = cfg.resolution
    if x_gpu.shape != (n, 1, r, r, r) or not torch.isfinite(x_gpu).all():
        raise AssertionError(f"bad sample {tuple(x_gpu.shape)}")
    # the card and the CPU sum in different orders; 1e-3 of the tanh range
    ex = (x_gpu.cpu() - x_cpu).abs().max().item()
    ed = ((d_gpu.cpu() - d_cpu).abs().max()
          / d_cpu.abs().max().clamp_min(1e-30)).item()
    if not (ex <= 1e-3 and ed <= 1e-3):
        raise AssertionError(f"card vs CPU: G max err {ex:.3e}, D rel err "
                             f"{ed:.3e} (tol 1e-3)")
    return {"g_max_abs_err": ex, "d_rel_err": ed, "tol": 1e-3, "batch": n,
            "wide_launches": cc.wide_launches}


def sg2_model_check(G, D, cfg) -> dict:
    """The trained StyleGAN2 G and D (f32, eval mode) on the card against
    the CPU: the mapping's ws; the synthesis at the CPU's ws and fixed
    noise, its modulated convs unfused (the training path) and fused (one
    grouped conv); D on the CPU's image. Tolerances as model_check's."""
    import torch

    gen = torch.Generator().manual_seed(1)
    z = torch.randn((2, cfg.z_size), generator=gen)
    noise = [torch.randn(s, generator=gen)
             for s in G.synthesis.noise_shapes(2)]
    with torch.no_grad():
        ws = G.map_ws(z)
        x_cpu = G.synthesize(ws, noise)
        d_cpu = D(x_cpu)
        Gc, Dc = copy.deepcopy(G).cuda(), copy.deepcopy(D).cuda()
        ws_gpu = Gc.map_ws(z.cuda())
        noise_gpu = [n.cuda() for n in noise]
        x_gpu = Gc.synthesize(ws.cuda(), noise_gpu)
        x_fused = Gc.synthesize(ws.cuda(), noise_gpu, fused_modconv=True)
        d_gpu = Dc(x_cpu.cuda())
    torch.cuda.synchronize()
    r = cfg.resolution
    if x_gpu.shape != (2, 1, r, r, r) or not torch.isfinite(x_gpu).all():
        raise AssertionError(f"bad sample {tuple(x_gpu.shape)}")
    ew = ((ws_gpu.cpu() - ws).abs().max() / ws.abs().max()).item()
    ex = (x_gpu.cpu() - x_cpu).abs().max().item()
    ef = (x_fused.cpu() - x_cpu).abs().max().item()
    ed = ((d_gpu.cpu() - d_cpu).abs().max()
          / d_cpu.abs().max().clamp_min(1e-30)).item()
    if not max(ew, ex, ef, ed) <= 1e-3:
        raise AssertionError(f"card vs CPU: ws rel err {ew:.3e}, G max err "
                             f"{ex:.3e} (fused {ef:.3e}), D rel err "
                             f"{ed:.3e} (tol 1e-3)")
    return {"ws_rel_err": ew, "g_max_abs_err": ex,
            "g_fused_max_abs_err": ef, "d_rel_err": ed, "tol": 1e-3}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "gan3d_tpu_torch")):
        print("chip_smoke: gan3d_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gan3d_tpu_torch.utils.platform import configure_precision

    configure_precision(torch.device("cuda"))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    power_limit_w = float(card.rsplit(",", 1)[1].split()[0])
    phase("device", kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda,
          alloc_conf=os.environ.get("PYTORCH_CUDA_ALLOC_CONF"))

    from gan3d_tpu_torch.ops import cuda_attention as ca
    from gan3d_tpu_torch.ops import cuda_build
    from gan3d_tpu_torch.ops import cuda_conv as cc
    from gan3d_tpu_torch.ops.attention import attention_plain
    from gan3d_tpu_torch.probes import mosaic_ladder as ml
    from gan3d_tpu_torch.utils.profiling import PROFILE_STEPS

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    # the calibration launches none of the kernels: it runs while they
    # build, as does the writing of the 256^3 data
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        calibration = pool.submit(eval_metrics_phase)
        data256 = pool.submit(r256_data, work.name)
        t0 = time.time()
        libs = cuda_build.build("pooled_attention", "conv3d_k3",
                                "conv3d_toeplitz", "probe_ladder")
        build_s = time.time() - t0
        metrics = calibration.result()
        data256.result()
    ptxas = []
    for lib in libs:
        with open(os.path.join(os.path.dirname(lib), "ptxas.log")) as f:
            ptxas += [ln.strip() for ln in f
                      if any(w in ln for w in ("entry function", "registers",
                                               "spill"))]
    registers = kernel_ptxas(ptxas)
    phase("build", seconds=build_s,
          libraries=[os.path.relpath(lib, REPO) for lib in libs],
          ptxas=ptxas, registers=registers)
    phase("eval_metrics", **metrics)
    spills = [k for k, v in registers.items()
              if NO_SPILL.search(k) and (v["spill_stores"] or v["spill_loads"])]
    missing = [k for k in ("wide_fwd_kernel", "box_copy_kernel<0>",
                           "box_copy_kernel<1>", "im2col27_kernel",
                           *(f"{kern}_tf32x3_kernel<{c}>"
                             for kern in ("fwd", "bwd_dq", "bwd_dkdv")
                             for c in (16, 32, 64, 128)),
                           *X3_CONV_INSTANCES)
               if k not in registers]
    if spills or missing or not any("_tc_kernel" in k for k in registers):
        raise AssertionError(f"kernels spill: {spills}; not in ptxas.log: "
                             f"{missing} or no tensor-core kernel")

    cases = kernel_phase(ca, attention_plain)
    phase("kernel_extra", **extra_checks(ca, attention_plain))
    shapes = conv_shapes()
    phase("conv_shapes", **shapes)
    conv_cases = conv_kernel_phase(cc, shapes)
    phase("conv_extra", **conv_extra_checks(cc))
    with work as tmp:
        train = train_phase(ca, cc, tmp, shapes)
        dp = dp_phase(ca, cc, tmp, os.path.join(tmp, "train.npz"),
                      power_limit_w)
        tp = tp_phase(ca, cc, tmp, os.path.join(tmp, "train.npz"), dp)
        spatial = sp_phase(ca, cc, tmp, os.path.join(tmp, "train.npz"), dp,
                           tp)
        spatial["gloo_space4_r256_f32"] = sp_gloo4_r256(
            ca, cc, tmp, spatial["gloo_space2_f32"]["grad_tol"])
        phase("sp_gloo4_r256", **spatial["gloo_space4_r256_f32"])
        train128 = train128_phase(ca, cc, tmp)
        spatial.update(sp_nccl(
            tmp, os.path.join(tmp, "train.npz"), dp["_one"],
            {"stylegan2": train["stylegan2/run_0_18"],
             "stylegan": train["stylegan/run_0_8"]},
            train128["ref128/run_0_2"]))
        spatial["nccl4_r256"] = sp_nccl4_r256(ca, cc, tmp)
        phase("sp_nccl4_r256", **spatial["nccl4_r256"])
        phase("inloop_fid", **inloop_fid_phase(
            ca, cc, tmp, train["default/run_0_12"]["steady_vol_per_s"]))
        phase("eval", **eval_phase(tmp, os.path.join(tmp, EVAL_RUN)))
        tourn = tournament_phase(ca, cc, tmp)
        phase("tournament", **tourn)
        phase("export", **export_phase(tmp))
        for run, sub, kernels in TRACED:
            phase("step_trace", run=run, **trace_phase(
                os.path.join(tmp, sub), PROFILE_STEPS, kernels))
    # the op-level paths after the train runs, which then see the card as
    # the earlier phases leave it
    toeplitz_cases = toeplitz_phase(cc)
    phase("toeplitz_extra", **toeplitz_extra_checks(cc))
    ladder_cases = ladder_phase(ml)
    phase("ladder_breakdown", us=ladder_breakdown(ml))
    first = {name: runs[0] for name, _, runs, _ in TRAIN_RUNS}
    paths = {name: train["%s/run_%d_%d" % (name, first[name][1],
                                             first[name][0])]["launches"]
             for name in CONV_PATHS + ATTENTION_PATHS}
    paths["tournament"] = tourn["default"]["launches"]
    for name, _, runs, _, _ in TRAIN128_RUNS:
        if name in ATTENTION128_PATHS:
            paths[name] = train128["%s/run_%d_%d" % (
                name, runs[0][1], runs[0][0])]["launches"]
    per_rank_runs = {**{k: v for k, v in dp.items() if not k.startswith("_")},
                     **{f"tp_{k}": v for k, v in tp.items()
                        if not k.startswith("_")},
                     **{f"sp_{k}": v for k, v in spatial.items()
                        if not k.startswith("_")}}
    print(json.dumps(kernels_line(cases, conv_cases, paths, toeplitz_cases,
                                  ladder_cases, per_rank_runs)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def r256_main() -> int:
    """``python3 chip_smoke.py --r256``: the 256^3 runs alone, for a
    4-card machine: sp_gloo4_r256 on card 0, then sp_nccl4_r256 with its
    one-process control (on fewer cards the control alone), then the
    slab BatchNorm's routes timed (``slab_bn``). Prints the card line, a
    line a run, then ``{"ok": true, "r256": true}``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gan3d_tpu_torch.ops import cuda_attention as ca
    from gan3d_tpu_torch.ops import cuda_build
    from gan3d_tpu_torch.ops import cuda_conv as cc
    from gan3d_tpu_torch.utils.platform import configure_precision

    configure_precision(torch.device("cuda"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    cuda_build.build("pooled_attention")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_r256_") as tmp:
        phase("sp_gloo4_r256", **sp_gloo4_r256(ca, cc, tmp))
        phase("sp_nccl4_r256", **sp_nccl4_r256(ca, cc, tmp, control=True))
    phase("slab_bn", **slab_bn_timing())
    print(json.dumps({"ok": True, "r256": True}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--r256"]:
        sys.exit(r256_main())
    if sys.argv[1:2] == ["--c4"]:
        sys.exit(c4_main())
    if sys.argv[1:2] == ["--c4-repeat"]:
        sys.exit(c4_repeat_main())
    if sys.argv[1:2] and sys.argv[1].startswith("--c4-diag="):
        # --c4-diag=FILTERS TMP TWO TRIALS
        sys.path.insert(0, REPO)
        for trial in range(int(sys.argv[4])):
            phase("c4_diag", **c4_diag(int(sys.argv[1].split("=")[1]),
                                       sys.argv[2], sys.argv[3] == "1",
                                       trial))
        sys.exit(0)
    sys.exit(main())
