"""The f32 routes of the k3 conv kernels on the card, alone and quickly.

``python -m gan3d_tpu_torch.probes.conv_f32`` builds ``csrc/conv3d_k3.cu``
and ``csrc/conv3d_toeplitz.cu``, prints the card's name and power limit
and ptxas's registers and spills of ``wide_tf32x3_kernel``,
``dw_tf32x3_kernel`` and ``toeplitz_tf32x3_kernel``, then prints one JSON
line a case:

- K4 (``wide_conv3d_cuda``) forward and dx and K3 (``conv3d_dw_cuda``) at
  every shape of ``SHAPES`` (chip_smoke.py's conv shapes: the 64^3
  flagship's G and D, StyleGAN-1's G whole and on a space-2 rank's halo'd
  slab, and the ragged ones), f32, against ``conv3d_k3_plain`` and
  ``conv3d_dw_plain`` (error relative to the largest value), repeats
  bit-identical, the split weight bit-equal to ``repack_weight_x3``;
- K5 (``toeplitz_conv3d_cuda``) at ``scripts/bench_lane_conv.py``'s
  shapes (batch 16) and ragged ones against ``toeplitz_conv3d_plain``;
- at the ``TIMED`` shapes, each kernel's time (CUDA events, the median of
  three windows of calls) and its device time (a torch.profiler trace)
  beside cuDNN's f32 conv, or its f32 weight gradient for K3 (``wgrad_``),
  on the same tensors (TF32 off, as
  ``utils/platform.configure_precision`` sets it), a yardstick the port
  never calls.

It exits 1 if a case is outside 1e-4 (the f32 route's tolerance), a
repeat differs, or an instance spills; it raises without a card. It
launches nothing the trainer counts on: run it in its own process.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
from typing import Callable, List

import torch

# (N, Ci, Co, D, H, W)
_FLAGSHIP = [(128, 4), (128, 8), (128, 16), (64, 16), (64, 32), (32, 32),
             (32, 64), (256, 8), (256, 4)]
_SG1 = [(512, 512, 4), (512, 256, 8), (256, 256, 8), (256, 128, 16),
        (128, 128, 16), (128, 64, 32), (64, 64, 32), (64, 32, 64)]
SHAPES = sorted(set(
    [(16, c, c, r, r, r) for c, r in _FLAGSHIP]
    + [(16, ci, co, r, r, r) for ci, co, r in _SG1]
    + [(16, ci, co, r // 2 + 2, r, r) for ci, co, r in _SG1]
    + [(1, 8, 256, 3, 5, 7), (2, 24, 8, 5, 9, 3), (1, 16, 40, 1, 1, 33),
       (3, 40, 16, 7, 6, 70), (1, 256, 8, 4, 4, 4),
       (1, 200, 72, 20, 18, 36)]))
TIMED = {(16, 32, 32, 64, 64, 64), (16, 64, 64, 32, 32, 32),
         (16, 128, 128, 16, 16, 16), (16, 128, 128, 8, 8, 8),
         (16, 256, 256, 8, 8, 8), (16, 256, 256, 4, 4, 4),
         (16, 512, 512, 4, 4, 4)}
# K5: (channels, side) at batch 16, timed; ((N, D, H, W), Ci, Co),
# checked
TOEPLITZ = [(16, 64), (32, 64), (32, 32), (64, 32), (128, 16)]
TOEPLITZ_EXTRA = [((2, 4, 4, 8), 32, 32), ((1, 3, 5, 8), 16, 16),
                  ((1, 4, 4, 8), 8, 64), ((3, 5, 7, 12), 24, 40),
                  ((2, 3, 37, 70), 20, 40), ((1, 2, 4000, 1), 8, 8),
                  ((2, 3, 5, 8), 128, 24), ((2, 3, 5, 8), 13, 21)]
TOL = 1e-4


def _ms(fn: Callable, iters: int = 5) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[1]


def _device_ms(fn: Callable, iters: int = 5) -> float:
    """Device time (ms) a call: every kernel of ``iters`` calls in a
    profiler trace, after a warm-up outside it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == cuda) / iters / 1e3


def _times(kern: Callable, lib: Callable) -> dict:
    return {"ms": _ms(kern), "device_ms": _device_ms(kern),
            "cudnn_ms": _ms(lib), "cudnn_device_ms": _device_ms(lib)}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def _registers(libs: List[str]) -> dict:
    """{kernel<template args>: (registers, spill stores)} of the f32 conv
    kernels, from each library's ptxas.log."""
    out, name = {}, None
    for lib in libs:
        with open(os.path.join(os.path.dirname(lib), "ptxas.log")) as f:
            for ln in f:
                m = re.search(r"((?:wide|dw|toeplitz)_tf32x3_kernel)I((?:L[ib]"
                              r"\d+E)+)E", ln)
                if "entry function" in ln:
                    name = (m.group(1) + "<" + ",".join(re.findall(
                        r"L[ib](\d+)E", m.group(2))) + ">") if m else None
                    if name:
                        out[name] = [None, None]
                elif name and "spill stores" in ln:
                    out[name][1] = int(re.search(r"(\d+) bytes spill stores",
                                                 ln).group(1))
                elif name and "registers" in ln:
                    out[name][0] = int(re.search(r"Used (\d+) registers",
                                                 ln).group(1))
                    name = None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("conv_f32: no CUDA device")
    import torch.nn.functional as F

    from gan3d_tpu_torch.ops import cuda_build
    from gan3d_tpu_torch.ops import cuda_conv as cc
    from gan3d_tpu_torch.ops import toeplitz_conv as tc
    from gan3d_tpu_torch.ops.conv3d import conv3d_dw_plain, conv3d_k3_plain
    from gan3d_tpu_torch.utils.platform import configure_precision

    configure_precision(torch.device("cuda"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    regs = _registers(cuda_build.build("conv3d_k3", "conv3d_toeplitz"))
    print(json.dumps({"registers": regs}), flush=True)
    bad = [k for k, (_, spill) in regs.items() if spill]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for shape in SHAPES:
        n, ci, co, d, h, w = shape
        x = torch.randn((n, ci, d, h, w), generator=gen, device="cuda")
        wt = (torch.randn((co, ci, 3, 3, 3), generator=gen, device="cuda")
              / math.sqrt(27 * ci))
        g = torch.randn((n, co, d, h, w), generator=gen, device="cuda")
        wr = wt.flip(2, 3, 4).transpose(0, 1).contiguous()
        got = cc.wide_conv3d_cuda(x, wt)
        case = {"kernel": "wide", "shape": shape,
                "plan": cc.wide_x3_plan(*shape),
                "fwd_err": _rel(got, conv3d_k3_plain(x, wt)),
                "dx_err": _rel(cc.wide_conv3d_cuda(g, wr),
                               conv3d_k3_plain(g, wr)),
                "repeat": bool(torch.equal(got, cc.wide_conv3d_cuda(x, wt))),
                "split": bool(torch.equal(cc.repack_weight_x3_cuda(wt),
                                          cc.repack_weight_x3(wt)))}
        if shape in TIMED:
            case.update(_times(lambda: cc.wide_conv3d_cuda(x, wt),
                               lambda: F.conv3d(x, wt, None, 1, 1)))
        print(json.dumps(case), flush=True)
        if not (max(case["fwd_err"], case["dx_err"]) <= TOL
                and case["repeat"] and case["split"]):
            bad.append(case)
        del got
        dw = cc.conv3d_dw_cuda(x, g)
        case = {"kernel": "dw", "shape": shape, "plan": cc.dw_x3_plan(*shape),
                "err": _rel(dw, conv3d_dw_plain(x, g)),
                "repeat": bool(torch.equal(dw, cc.conv3d_dw_cuda(x, g)))}
        if shape in TIMED:
            one = [1, 1, 1]
            times = _times(lambda: cc.conv3d_dw_cuda(x, g),
                           lambda: torch.ops.aten.convolution_backward(
                               g, x, wt, None, one, one, one, False,
                               [0, 0, 0], 1, [False, True, False])[1])
            case.update({k.replace("cudnn", "wgrad"): v
                         for k, v in times.items()})
        print(json.dumps(case), flush=True)
        if not (case["err"] <= TOL and case["repeat"]):
            bad.append(case)
        del x, wt, g, wr, dw
        torch.cuda.empty_cache()
    for shape, ci, co in ([((16, s, s, s), c, c) for c, s in TOEPLITZ]
                          + TOEPLITZ_EXTRA):
        timed = shape[0] == 16
        x = torch.randn((*shape, ci), generator=gen, device="cuda")
        w = (torch.randn((3, 3, 3, ci, co), generator=gen, device="cuda")
             / math.sqrt(27 * ci))
        got = cc.toeplitz_conv3d_cuda(x, w)
        case = {"kernel": "toeplitz", "shape": shape, "Ci": ci, "Co": co,
                "plan": cc.toeplitz_x3_plan(*shape, ci, co),
                "fwd_err": _rel(got, tc.toeplitz_conv3d_plain(x, w,
                                                              shape[3])),
                "repeat": bool(torch.equal(got,
                                           cc.toeplitz_conv3d_cuda(x, w)))}
        if timed:
            xc = x.permute(0, 4, 1, 2, 3)
            wc = w.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            case.update(_times(lambda: cc.toeplitz_conv3d_cuda(x, w),
                               lambda: F.conv3d(xc, wc, None, 1, 1)))
        print(json.dumps(case), flush=True)
        if not (case["fwd_err"] <= TOL and case["repeat"]):
            bad.append(case)
        del x, w, got
        torch.cuda.empty_cache()
    print(json.dumps({"ok": not bad, "failed": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
