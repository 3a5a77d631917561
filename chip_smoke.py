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
             tensor-core kernel and of the ladder's wide_fwd, box_copy and
             im2col27 kernels, and fails if one of them spills (the
             attention kernels: at a flagship instance);
3. kernels — runs the pooled-attention forward and backward kernels at the
             two shapes of the 64^3 BigGAN-Deep flagship (G: L=32768,
             M=4096, c=16; D: L=4096, M=512, c=32) and the two of the 64^3
             DCGAN with --sagan (G: L=4096, M=512, c=16; D: L=512, M=64,
             c=32), N=16, in f32 and bf16
             (each pass has two routes: bf16 on the tensor-core kernels,
             f32 on the FMA kernels; the backward's check runs on the
             forward's o and lse),
             holds each against the plain PyTorch version, and times the
             kernel, the plain version and F.scaled_dot_product_attention
             (a yardstick the port never calls) with CUDA events, and the
             kernel's and the yardstick's device time in a profiler trace;
             then
             checks every c and ragged L/M tails at small shapes, that a
             repeated forward and backward are bit-identical and that a
             double backward through the kernels raises;
4. conv    — finds the eligible k3 convs of the flagship's G and D and of
             the StyleGAN-1 G (512 -> 32 channels at 4^3-64^3) with forward
             hooks on the port's models, and at each distinct shape (N=16,
             f32 and
             bf16: the wide conv's and dW's bf16 routes on the tensor
             cores, their f32 routes on the FMA kernels) holds the wide-N
             conv kernel (forward, and dx with the flipped weights) and the
             dW kernel against their plain
             versions, timing each beside its plain version and the one
             PyTorch call that computes the same function (F.conv3d;
             aten.convolution_backward for dW), yardsticks the port never
             calls (the kernels' and the yardsticks' time: the median of
             three windows, and the device time in a profiler trace);
             then ragged shapes, a repeated dW and a repeated bf16 wide
             conv bit-identical, the bf16 weight repack bit-equal to its
             plain version and an f16 input refused;
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
             CPU (plain path; the msl D at fixed crop offsets; StyleGAN2's
             G at fixed ws and noise, its modulated convs both unfused and
             fused); a StyleGAN2 checkpoint must hold a nonzero pl_mean,
             a StyleGAN-1 checkpoint a pl_mean of 0.
             Last, the gradient penalty with attention in D must be
             refused. Every run logs its FID as nan and says once that
             no Inception weights were found;
   inloop_fid — the flagship with in-loop FID: the random stand-in
             (--fid_in_loop=True, 4 steps, a log and a checkpoint every 2),
             a random-init Inception-V3 weights file the script writes in
             the pt_inception layout (--inception_weights, 2 steps, a log
             every step), the stand-in with --async_log=True, and the
             stand-in and the weights at the default steps_per_log=10 over
             20 steps; each run's log lines and finite FIDs, the
             checkpoint's FID history, K1/K2 launches as in training; the
             steady vol/s of each beside the default run's; each in-loop
             FID's seconds, split into the host's Fréchet distance and
             the card's feature pass;
   eval    — on the --stylegan run's directory: the generate CLI (32
             volumes), then the eval CLI with --n_seeds=1 on a synthetic
             test set (32 volumes tanh(N(0, 1)) at 64^3, seed 0; batch
             16) with random-init extractors; checks the stats file's
             keys and finite values, ms_ssim_3d(x, x) = 1, and the 3D-FID
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
             (random ResNet-50, slice-FID stand-in): randn vs randn below
             randn vs uniform in 3D-FID, axial FID and MMD; its seconds;
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
             skipped as the bench skips it), f32 (the FMA kernel) and bf16
             (the tensor-core kernel), drives the op's forward and
             forward+backward with each route's launch counter read around
             that run; holds the forward, dx and dW against autograd
             through the plain version; times the forward (the median of
             three windows, and the device time in a profiler trace) and
             forward+backward, the plain forward and F.conv3d on the same
             tensors viewed as NCDHW channels_last_3d (a yardstick the port
             never calls, timed the same way); then the tests' shapes and
             ragged Cin != Cout ones, a bad tile and an f16 input refused,
             and 1 launch per forward, 2 per forward+backward on the
             dtype's route;
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
   launches_by_path), then the result line.

Any failure raises and the script exits non-zero without the result line.
It needs no arguments and one card; it imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances, as max |kernel - plain| / max |plain|. f32: both sides
# accumulate in f32 in different orders over up to 32768 terms. bf16: both
# sides compute in f32 from the same bf16 inputs and round the result to
# bf16 (2^-8 relative); the kernel's backward also uses the bf16-rounded o
# in delta = sum(dO * o), where the plain autograd uses its f32 o.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32
# (non-tensor) and bf16 tensor-core FLOP/s; exponentials: 132 SMs x 16
# special-function ops per clock at the 1.98 GHz boost clock, the clock of
# the f32 figure (132 x 128 FMA x 2 x 1.98 GHz = 67 TF). The bf16 figure
# implies 1.83 GHz; the higher clock gives the least time.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
SFU_OPS = 132 * 16 * 1.98e9
# K1/K2 placements (name, L, M, c), N=16: the 64^3 BigGAN-Deep flagship's
# G (32^3) and D (16^3) attention, then the 64^3 DCGAN's with --sagan, G at
# 16^3 and D at 8^3.
PLACEMENTS = (("G", 32768, 4096, 16), ("D", 4096, 512, 32),
              ("dcgan_G", 4096, 512, 16), ("dcgan_D", 512, 64, 32))
# Kernel instances that must not spill (ptxas): every K3, K4 and K5 bf16
# instance, the K1 and K2 bf16 kernels at the flagship's c = 16 and 32,
# and the ladder's wide_fwd, box_copy (both modes) and im2col27.
NO_SPILL = re.compile(r"wide_tc_kernel|dw_tc_kernel|toeplitz_tc_kernel|"
                      r"(fwd|bwd_\w+)_tc_kernel<(16|32)>|wide_fwd_kernel|"
                      r"box_copy_kernel|im2col27_kernel")
# The kernels whose registers and spills the build phase reports: the
# tensor-core kernels, the ladder's wide_fwd, box_copy and im2col27.
REPORTED = (r"[a-z_]+_tc_kernel|wide_fwd_kernel|box_copy_kernel|"
            r"im2col27_kernel")
# Off the main path, checked but not timed: every template instance of c,
# and ragged L and M tails (neither a multiple of any tile).
EXTRA_SHAPES = ((2, 1000, 125, 8), (3, 300, 38, 16), (1, 4133, 517, 32),
                (2, 777, 97, 64))
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
KNOB_RUN = "wide_conv+fast_dw"
# The runs whose K3/K4 launches the kernels line lists by path (the first
# part of each): the flagship's and StyleGAN-1's knob runs.
CONV_PATHS = (KNOB_RUN, "stylegan_knobs")
# The run the eval phase reads, and its synthetic test set: volumes, batch
# and seed (the eval CLI's --seed default).
EVAL_RUN = "stylegan"
EVAL_N, EVAL_BATCH, EVAL_SEED = 32, 16, 0
# Volumes of the eval phase's card-against-CPU feature check.
EVAL_CHECK_N = 4
PROFILED_RUN = "profiled"
# The trainer's line when in-loop FID finds no Inception weights (every
# TRAIN_RUNS run: fid_in_loop unset, no weights on the machine).
NO_WEIGHTS_LINE = "in-loop FID: no Inception weights found"
# The inloop_fid phase's runs of the flagship (name, flags, niters):
# (a) the random stand-in (fid_in_loop=True) with a log and a checkpoint
# every 2 steps; (b) a random-init Inception-V3 weights file written in
# the pt_inception layout ({weights}), a log every step; (c) (a) with
# async_log; then the stand-in and the weights at the default
# steps_per_log=10 over 20 steps, for the steady rate (steps 1-19 hold
# the log of step 10 and the final one).
INLOOP_RUNS = (
    ("stand_in", ["--fid_in_loop=True", "--steps_per_log=2",
                  "--steps_per_ckpt=2"], 4),
    ("weights", ["--inception_weights={weights}", "--steps_per_log=1"], 2),
    ("async", ["--fid_in_loop=True", "--steps_per_log=2",
               "--steps_per_ckpt=2", "--async_log=True"], 4),
    ("stand_in_rate", ["--fid_in_loop=True"], 20),
    ("weights_rate", ["--inception_weights={weights}"], 20),
)
INCEPTION_SEED = 0
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
# run's: each run's first part.
ATTENTION_PATHS = ("default", "dcgan_sagan", "hybrid")
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
# non-cubic volumes, Ci != Co, the narrowest and widest channels.
CONV_RAGGED = ((1, 8, 256, 3, 5, 7), (2, 24, 8, 5, 9, 3),
               (1, 16, 40, 1, 1, 33), (3, 40, 16, 7, 6, 70),
               (1, 256, 8, 4, 4, 4))
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
    print(json.dumps({"phase": name, **kw}), flush=True)


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


def timings(kern, lib, iters: int) -> dict:
    """A K1-K4 case's times (ms) of the kernel's wrapper and of the one
    PyTorch call computing the same function (``lib``): each the median of
    three windows of ``iters`` calls (all three kept) and the device time
    per call in a profiler trace."""
    ms, windows = kernel_ms(kern, iters)
    lib_ms, lib_windows = kernel_ms(lib, iters)
    return {"ms": ms, "ms_windows": windows,
            "device_ms": device_ms(kern, iters=iters, per_call=True),
            "library_ms": lib_ms, "library_ms_windows": lib_windows,
            "library_device_ms": device_ms(lib, iters=iters, per_call=True)}


def bound(kind: str, dtype: str, n: int, L: int, m: int, c: int):
    """Least time for the work on an H100 SXM: (ms, "bytes"|"operations").

    Forward: 2 products (q k^T, p v) and one exp per score; reads q, k, v
    once, writes o and lse. Backward: 5 products (s, dp, dv, dk, dq) and one
    exp per score; reads q, k, v, o, dO, lse, writes dq, dk, dv.
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
    t_ops = max(flops / PEAK_FLOPS[dtype], scores / SFU_OPS)
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
    for place, L, m, c in PLACEMENTS:
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            n = N_FLAGSHIP
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
            times = {kind: {**timings(kern, lib, fwd_iters),
                            "plain_ms": cuda_ms(plain, fwd_iters)}
                     for kind, (kern, plain, lib) in calls.items()}
            del calls, o_ref, grads_ref, sdpa_out
            for kind in ("fwd", "bwd"):
                b_ms, b_by = bound(kind, dname, n, L, m, c)
                errs_k = ({"o": errs["o"], "lse": errs["lse"]}
                          if kind == "fwd" else
                          {x: errs[x] for x in ("dq", "dk", "dv")})
                case = {
                    "kernel": kind, "placement": place, "dtype": dname,
                    "route": ("tensor_core" if dname == "bfloat16"
                              else "fma"),
                    "N": n, "L": L, "M": m, "c": c,
                    "max_err": max(e[1] for e in errs_k.values()),
                    "max_abs_err": max(e[0] for e in errs_k.values()),
                    "rel_err": {x: e[1] for x, e in errs_k.items()},
                    "tol": tol, **times[kind],
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                phase("kernel_case", **case)
                cases.append(case)
            torch.cuda.empty_cache()
    return cases


def extra_checks(ca, attention_plain) -> dict:
    """The kernels against the plain version at EXTRA_SHAPES, a repeated
    forward and backward bit-identical, and the backward refusing a second
    differentiation."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst = {}
    for n, L, m, c in EXTRA_SHAPES:
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
                worst[key] = max(worst.get(key, 0.0), rel)
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
            "repeated_forward_backward": "bit-identical",
            "double_backward": "raises"}


def conv_bound(kind: str, dtype: str, n: int, ci: int, co: int, s: int):
    """Least time for one k3 conv call on an H100 SXM: (ms, "bytes" |
    "operations"). 2 * N * S * Ci * 27 * Co operations at the type's peak;
    bytes: each input read once, each output written once — the conv reads
    x [N,Ci,S] and w [Co,Ci,27] and writes out [N,Co,S] in one dtype; dW
    reads x and g [N,Co,S] and writes f32 dW [Co,Ci,27]."""
    es = 4 if dtype == "float32" else 2
    flops = 2 * n * s * ci * 27 * co
    if kind == "dw":
        nbytes = n * s * (ci + co) * es + co * ci * 27 * 4
    else:
        nbytes = (n * s * (ci + co) + co * ci * 27) * es
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def conv_shapes() -> dict:
    """(Ci, Co, D, H, W) of every conv the port's rule admits, per network
    in call order, from forward pre-hooks on the flagship's G and D and on
    StyleGAN-1's G and D (on the card, N=1, the default route); checked
    against CONV_G / CONV_D / CONV_SG1 (StyleGAN-1's D: none)."""
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
    error against the plain version, and times of the kernel, the plain
    version and the PyTorch call. Each case names the networks that run
    its shape ("paths": G, D, SG1)."""
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
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
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
                              else "fma"),
                    "N": n, "Ci": cin, "Co": cout, "D": d, "H": h, "W": w,
                    "max_err": rel, "max_abs_err": abs_err, "tol": tol,
                    **timings(kern, lib, iters),
                    "plain_ms": cuda_ms(plain, max(2, iters // 4), 1),
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                phase("conv_case", **case)
                cases.append(case)
            del x, wt, g, wr, runs
            torch.cuda.empty_cache()
    return cases


def conv_extra_checks(cc) -> dict:
    """The conv kernels against the plain versions at CONV_RAGGED; a
    repeated dW and a repeated bf16 wide conv bit-identical (there and at
    the flagship's largest shape); the bf16 weight repack bit-equal to its
    plain version;
    an f16 CUDA input refused by both wrappers."""
    import torch

    from gan3d_tpu_torch.ops.conv3d import conv3d_dw_plain, conv3d_k3_plain

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
            if dt == torch.bfloat16 and not torch.equal(
                    cc.wide_conv3d_cuda(x, wt), cc.wide_conv3d_cuda(x, wt)):
                raise AssertionError(f"{shape}: a repeated bf16 wide conv is "
                                     "not bit-identical")
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
    # the bf16 route's weight repack on the card, bit for bit against its
    # plain version, for a forward and a dx weight
    for co, ci in ((40, 24), (256, 128)):
        w = torch.randn((co, ci, 3, 3, 3), generator=gen,
                        device="cuda").bfloat16()
        for wt in (w, w.flip(2, 3, 4).transpose(0, 1).contiguous()):
            if not torch.equal(cc.repack_weight_cuda(wt),
                               cc.repack_weight(wt)):
                raise AssertionError(f"weight repack {tuple(wt.shape)} "
                                     "differs from its plain version")
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
            "repeated_dw": "bit-identical",
            "repeated_wide_bf16": "bit-identical",
            "weight_repack": "bit-equal to its plain version",
            "float16": "refused"}


def toeplitz_bound(dtype: str, n: int, s: int, ci: int, co: int):
    """Least time for one K5 forward on an H100 SXM: (ms, "bytes" |
    "operations"). 2 * N * S * Ci * Co * 27 operations at the type's peak;
    bytes: x [N,S,Ci] and w [27,Ci,Co] read once, out [N,S,Co] written
    once, in one dtype."""
    es = 4 if dtype == "float32" else 2
    flops = 2 * n * s * ci * co * 27
    nbytes = (n * s * (ci + co) + 27 * ci * co) * es
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
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
    # each route's counter: the f32 FMA kernel, the bf16 tensor-core kernel
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
                "route": ("tensor_core" if dname == "bfloat16" else "fma"),
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
    bad tile and an f16 input refused; 1 launch per forward and 2 per
    forward+backward, on the dtype's route (bf16: the tensor-core kernel;
    f32: the FMA kernel)."""
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
            tc.toeplitz_conv3d(x, w, t)
            fwd = getattr(cc, mine) - before[0]
            got = _toeplitz_grads(tc, x, w, t, g, plain=False)
            both = getattr(cc, mine) - before[0] - fwd
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
        t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS["bfloat16"]
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
    blocks (``parts`` 1, 2, 3 or 4, where they divide the box)."""
    import torch

    inp = ml.inputs("cuda")

    def us(src, box, plan):
        want = ml.box_plain(src, box)
        if plan.stop == 0 and not torch.equal(ml.box_copy_on(src, box, plan),
                                              want):
            raise AssertionError(f"box_copy on {plan} differs")
        return device_ms(lambda: ml.box_copy_on(src, box, plan),
                         "box_copy_kernel") * 1e3

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


def f32_fields(case: dict) -> dict:
    """An f32 case's kernel and library times, for the kernels line."""
    return {f"f32_{k}": case[k] for k in ("ms", "device_ms", "library_ms",
                                           "library_device_ms")}


def kernels_line(cases: list, conv_cases: list, paths: dict,
                 toeplitz_cases: list, ladder_cases: list) -> dict:
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
    StyleGAN-1's knob runs); each conv case lists the networks that run
    its shape ("paths": G, D, SG1). K1-K5 and the
    ladder add ``device_ms`` and ``library_device_ms`` (device time per
    call, profiler), and K1-K5 the f32 route's (the FMA kernels') numbers
    at the same case: ``f32_ms``, ``f32_device_ms``, ``f32_library_ms``
    and ``f32_library_device_ms``. ``max_err`` is the largest error
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
        by_path = (ATTENTION_PATHS if key in ("fwd_tc", "bwd_tc")
                   else CONV_PATHS)
        out[-1]["launches_by_path"] = {p: paths[p][key] for p in by_path}
        if key == "fwd_tc":  # the tournament's no-grad forwards
            out[-1]["launches_by_path"]["tournament"] = \
                paths["tournament"][key]
        # the same case's f32 route (FMA kernels) beside it
        f32 = next(c for c in mine if c["dtype"] == "float32" and all(
            c[k] == main[k] for k in main
            if k in ("kernel", "placement", "Ci", "D")))
        out[-1].update(f32_fields(f32))
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
        **f32_fields(k5_f32),
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
    """Run the train CLI in-process; returns its stdout (also echoed)."""
    from gan3d_tpu_torch.cli import train as cli_train

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


def train_phase(ca, cc, tmp: str, shapes: dict) -> dict:
    """Every run of TRAIN_RUNS through the CLI, with its launch counts, and
    the model check after each run but UNCHECKED_RUNS; then the gradient
    penalty refused for a D with attention."""
    import numpy as np
    import torch

    data = os.path.join(tmp, "train.npz")
    rng = np.random.default_rng(0)
    np.savez(data, X=np.tanh(rng.standard_normal((48, 64, 64, 64),
                                                 np.float32)))
    results = {}
    for name, flags, runs, attention in TRAIN_RUNS:
        log_dir = os.path.join(tmp, name)
        flags = [f.format(tmp=tmp) for f in flags]
        base = flags + [f"--data_path={data}", f"--log_dir={log_dir}"]
        wide, fast_dw = "--wide_conv=on" in flags, "--fast_dw=on" in flags
        sg1 = "--stylegan=True" in flags
        # eligible convs a G and a D forward: StyleGAN-1's D has none
        n_g, n_d = ((len(shapes["SG1"]), 0) if sg1
                    else (len(shapes["G"]), len(shapes["D"])))
        for niters, start in runs:
            ca.reset_counters()
            cc.reset_counters()
            torch.cuda.reset_peak_memory_stats()
            out = run_cli(base + [f"--niters={niters}"])
            got = _counters(ca, cc)
            # bf16 runs: the f32 routes of K1-K4 launch nothing, and K5
            # is on no train path
            want = {"fwd": 0, "bwd": 0, "wide": 0, "dw": 0, "toeplitz": 0,
                    "toeplitz_tc": 0,
                    **expected_launches(start, niters, 2, 50, attention),
                    **expected_conv_launches(start, niters, 2, 50, n_g, n_d,
                                             wide, fast_dw)}
            if got != want or (any(attention) and not (got["fwd_tc"]
                                                       and got["bwd_tc"])):
                raise AssertionError(f"{name}: launches {got} != expected "
                                     f"{want}")
            if (wide or fast_dw) and not got["dw_tc"]:
                raise AssertionError(f"{name}: the dW kernel never launched")
            if wide and not got["wide_tc"]:
                raise AssertionError(f"{name}: the wide kernel never "
                                     "launched")
            if out.count(NO_WEIGHTS_LINE) != 1 or "\tFID nan" not in out:
                raise AssertionError(f"{name}: not one '{NO_WEIGHTS_LINE}' "
                                     "line, or no FID logged as nan")
            if start and f"starting from step {start}" not in out:
                raise AssertionError(f"resume did not print 'starting from "
                                     f"step {start}'")
            if f"[{niters - 1}|{niters}]\tD(x): " not in out:
                raise AssertionError(f"no log line for step {niters - 1}")
            ckpt = torch.load(os.path.join(log_dir, "models",
                                           "checkpoint.pt"),
                              map_location="cpu", weights_only=True)
            vals = ckpt["lossG"] + [x for pair in ckpt["lossD"] for x in pair]
            if (len(ckpt["lossG"]) != niters
                    or not all(math.isfinite(x) for x in vals)):
                raise AssertionError(f"{len(ckpt['lossG'])} G losses for "
                                     f"{niters} steps, or a non-finite loss")
            sg2 = "--stylegan2=True" in flags
            pl_mean = float(ckpt["pl_mean"]) if sg2 or sg1 else None
            if sg2 and not (math.isfinite(pl_mean) and pl_mean != 0.0):
                raise AssertionError(f"{name}: pl_mean {pl_mean} after the "
                                     "lazy step 0")
            if sg1 and pl_mean != 0.0:
                raise AssertionError(f"{name}: StyleGAN-1's pl_mean "
                                     f"{pl_mean}, not 0")
            key = f"{name}/run_{start}_{niters}"
            results[key] = {
                **_done(out), "launches": got, "max_memory_allocated":
                    torch.cuda.max_memory_allocated(), "pl_mean": pl_mean}
            phase("train_run", run=name, niters=niters, **results[key])
        last = runs[-1][0] - 1
        for f in ("params.json", "models/checkpoint.pt", f"images/{last}.png"):
            if not os.path.isfile(os.path.join(log_dir, f)):
                raise AssertionError(f"{name}: missing {f}")
        if name not in UNCHECKED_RUNS:
            phase("model_check", run=name, **model_check(log_dir, cc))
    phase("gp_refusal", **gp_refusal(data, tmp))
    return results


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
    data = os.path.join(tmp, "eval_test.npz")
    rng = np.random.default_rng(EVAL_SEED)
    np.savez(data, X=np.tanh(rng.standard_normal((EVAL_N, r, r, r),
                                                  np.float32)))
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


def eval_metrics_phase(tmp: str) -> dict:
    """calibrate(reps=1) on the card at 64^3, batch 16: the eval phase's
    test set as the data batches, the random ResNet-50 and the slice-FID
    stand-in; randn vs randn must score below randn vs uniform in 3D-FID,
    axial FID and MMD."""
    import torch

    from gan3d_tpu_torch.cli.eval_metrics import calibrate
    from gan3d_tpu_torch.data import Loader, open_dataset
    from gan3d_tpu_torch.eval.fid_resnet import get_fid_model
    from gan3d_tpu_torch.eval.slice_fid import SliceFID

    cuda = torch.device("cuda")
    loader = Loader(open_dataset(os.path.join(tmp, "eval_test.npz")),
                    EVAL_BATCH, seed=EVAL_SEED, drop_last=False)
    batches = [torch.from_numpy(b)[:, None]
               for _, b in zip(range(6), loader)]
    t0 = time.time()
    res = calibrate(data_batches=batches, reps=1, size=64, batch=EVAL_BATCH,
                    fid_features=get_fid_model(None, cuda),
                    sfid=SliceFID(device=cuda), seed=EVAL_SEED, device=cuda)
    secs = time.time() - t0
    bad = [k for k in ("3dFID", "FIDax", "MMD")
           if not res["randn_vs_randn"][k] < res["randn_vs_rand"][k]]
    if bad:
        raise AssertionError(f"calibration: randn vs randn not below randn "
                             f"vs uniform in {bad}: {res}")
    return {"results": res, "data_batches": len(batches), "seconds": secs}


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


def model_check(log_dir: str, cc) -> dict:
    """The trained G and D, in f32 and eval mode: on the card (kernels, the
    run's conv routes) against the same weights on the CPU (plain
    attention, F.conv3d); the msl D crops at the same fixed offsets on
    both; StyleGAN2 by ``sg2_model_check``."""
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
    z = torch.randn((2, cfg.z_size), generator=torch.Generator().manual_seed(1))
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
    if x_gpu.shape != (2, 1, r, r, r) or not torch.isfinite(x_gpu).all():
        raise AssertionError(f"bad sample {tuple(x_gpu.shape)}")
    # the card and the CPU sum in different orders; 1e-3 of the tanh range
    ex = (x_gpu.cpu() - x_cpu).abs().max().item()
    ed = ((d_gpu.cpu() - d_cpu).abs().max()
          / d_cpu.abs().max().clamp_min(1e-30)).item()
    if not (ex <= 1e-3 and ed <= 1e-3):
        raise AssertionError(f"card vs CPU: G max err {ex:.3e}, D rel err "
                             f"{ed:.3e} (tol 1e-3)")
    return {"g_max_abs_err": ex, "d_rel_err": ed, "tol": 1e-3,
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
    print(smi.stdout.strip().splitlines()[0], flush=True)
    phase("device", kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    from gan3d_tpu_torch.ops import cuda_attention as ca
    from gan3d_tpu_torch.ops import cuda_build
    from gan3d_tpu_torch.ops import cuda_conv as cc
    from gan3d_tpu_torch.ops.attention import attention_plain
    from gan3d_tpu_torch.probes import mosaic_ladder as ml
    from gan3d_tpu_torch.utils.profiling import PROFILE_STEPS

    t0 = time.time()
    libs = cuda_build.build("pooled_attention", "conv3d_k3",
                            "conv3d_toeplitz", "probe_ladder")
    ptxas = []
    for lib in libs:
        with open(os.path.join(os.path.dirname(lib), "ptxas.log")) as f:
            ptxas += [ln.strip() for ln in f
                      if any(w in ln for w in ("entry function", "registers",
                                               "spill"))]
    registers = kernel_ptxas(ptxas)
    phase("build", seconds=time.time() - t0,
          libraries=[os.path.relpath(lib, REPO) for lib in libs],
          ptxas=ptxas, registers=registers)
    spills = [k for k, v in registers.items()
              if NO_SPILL.search(k) and (v["spill_stores"] or v["spill_loads"])]
    missing = [k for k in ("wide_fwd_kernel", "box_copy_kernel<0>",
                           "box_copy_kernel<1>", "im2col27_kernel")
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train = train_phase(ca, cc, tmp, shapes)
        phase("inloop_fid", **inloop_fid_phase(
            ca, cc, tmp, train["default/run_0_12"]["steady_vol_per_s"]))
        phase("eval", **eval_phase(tmp, os.path.join(tmp, EVAL_RUN)))
        tourn = tournament_phase(ca, cc, tmp)
        phase("tournament", **tourn)
        phase("export", **export_phase(tmp))
        phase("eval_metrics", **eval_metrics_phase(tmp))
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
    print(json.dumps(kernels_line(cases, conv_cases, paths, toeplitz_cases,
                                  ladder_cases)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
