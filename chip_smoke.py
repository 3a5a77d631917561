#!/usr/bin/env python3
"""Drive the PyTorch port (gan3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line:
1. device  — requires torch.cuda.is_available(); prints the nvidia-smi
             name and power limit;
2. build   — compiles csrc/pooled_attention.cu with nvcc for sm_90a;
3. kernels — runs the pooled-attention forward and backward kernels at the
             two shapes of the 64^3 BigGAN-Deep flagship (G: L=32768,
             M=4096, c=16; D: L=4096, M=512, c=32; N=16) in f32 and bf16,
             holds each against the plain PyTorch version, and times the
             kernel, the plain version and F.scaled_dot_product_attention
             (a yardstick the port never calls) with CUDA events; then
             checks every c and ragged L/M tails at small shapes, that a
             repeated backward is bit-identical and that a double
             backward through the kernels raises;
4. train   — trains the flagship (64^3, filters 64, z 512, batch 16,
             iterD 2, biggan, hinge) through gan3d_tpu_torch.cli.train for
             a few steps, resumes it, checks the kernel launch counts the
             step implies, and holds the trained G and D on the card
             (kernels) against the same networks on the CPU (plain path);
5. the kernels JSON line, then the result line.

Any failure raises and the script exits non-zero without the result line.
It needs no arguments and one card; it imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
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
PLACEMENTS = (("G", 32768, 4096, 16), ("D", 4096, 512, 32))
# Off the main path, checked but not timed: every template instance of c,
# and ragged L and M tails (neither a multiple of any tile).
EXTRA_SHAPES = ((2, 1000, 125, 8), (3, 300, 38, 16), (1, 4133, 517, 32),
                (2, 777, 97, 64))
N_FLAGSHIP = 16
# The CLI's defaults otherwise (steps_per_log=10, steps_per_img_log=50).
FLAGSHIP = ["--biggan=True", "--hinge=True", "--resolution=64",
            "--filterG=64", "--filterD=64", "--z_size=512",
            "--batch_size=16", "--iterD=2"]
# (niters, step it resumes from): a 12-step run, then a 2-step resume.
TRAIN_RUNS = ((12, 0), (14, 12))


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
            times = {
                "fwd": (cuda_ms(lambda: ca.attention_fwd(q, k, v), fwd_iters),
                        cuda_ms(lambda: attention_plain(q, k, v), fwd_iters),
                        cuda_ms(lambda: F.scaled_dot_product_attention(
                            q[:, None], k[:, None], v[:, None], scale=1.0),
                            fwd_iters)),
                "bwd": (cuda_ms(lambda: ca.attention_bwd(q, k, v, o, lse, do),
                                fwd_iters),
                        cuda_ms(lambda: torch.autograd.grad(
                            o_ref, leaves, do, retain_graph=True), fwd_iters),
                        cuda_ms(lambda: torch.autograd.grad(
                            sdpa_out, sdpa_in, do[:, None],
                            retain_graph=True), fwd_iters)),
            }
            del o_ref, grads_ref, sdpa_out
            for kind in ("fwd", "bwd"):
                ms, plain_ms, lib_ms = times[kind]
                b_ms, b_by = bound(kind, dname, n, L, m, c)
                errs_k = ({"o": errs["o"], "lse": errs["lse"]}
                          if kind == "fwd" else
                          {x: errs[x] for x in ("dq", "dk", "dv")})
                case = {
                    "kernel": kind, "placement": place, "dtype": dname,
                    "N": n, "L": L, "M": m, "c": c,
                    "max_err": max(e[1] for e in errs_k.values()),
                    "max_abs_err": max(e[0] for e in errs_k.values()),
                    "rel_err": {x: e[1] for x, e in errs_k.items()},
                    "tol": tol, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                }
                phase("kernel_case", **case)
                cases.append(case)
            torch.cuda.empty_cache()
    return cases


def extra_checks(ca, attention_plain) -> dict:
    """The kernels against the plain version at EXTRA_SHAPES, a repeated
    backward bit-identical, and the backward refusing a second
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
            again = ca.attention_bwd(q, k, v, o, lse, do)
            if not all(torch.equal(a, b) for a, b in zip(got[1:], again)):
                raise AssertionError(f"{(n, L, m, c)} {dname}: a repeated "
                                     "backward is not bit-identical")
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
            "repeated_backward": "bit-identical",
            "double_backward": "raises"}


def kernels_line(cases: list, launches: dict) -> dict:
    """One entry per kernel; the top-level numbers are the main path's
    case (G placement, bf16, N=16); every case is listed under "cases".
    ``max_err`` is the largest error relative to max |plain| over the
    compared outputs, the number held against ``tol``; ``max_abs_err`` is
    the largest absolute difference."""
    src = "gan3d_tpu_torch/csrc/pooled_attention.cu"
    meta = {
        "fwd": ("pooled_attention_fwd",
                "gan3d_tpu/ops/pallas_attention.py:28"),
        "bwd": ("pooled_attention_bwd",
                "gan3d_tpu/ops/pallas_attention.py:67"),
    }
    out = []
    for kind, (name, replaces) in meta.items():
        mine = [c for c in cases if c["kernel"] == kind]
        main = next(c for c in mine
                    if c["placement"] == "G" and c["dtype"] == "bfloat16")
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kind],
            "max_err": main["max_err"], "tol": main["tol"],
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "at": "G placement, bfloat16, N=16, L=32768, M=4096, c=16",
            "cases": mine,
        })
    return {"kernels": out}


def run_cli(argv: list) -> str:
    """Run the train CLI in-process; returns its stdout (also echoed)."""
    from gan3d_tpu_torch.cli import train as cli_train

    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            sys.__stdout__.write(s)
            return len(s)

        def flush(self):
            sys.__stdout__.flush()

    with contextlib.redirect_stdout(Tee()):
        cli_train.main(argv)
    return buf.getvalue()


def expected_launches(start: int, niters: int, iter_d: int,
                      img_every: int) -> dict:
    """Attention launches a run of steps [start, niters) implies.

    Per step: G attention forward iter_d times (no-grad G in each D
    iteration) + once (G step); D attention forward 2 * iter_d times (real
    and fake per D iteration) + once (G step). Backward: every D forward
    that carries a gradient (all of them) and the G step's G forward.
    Each sample-grid log (every img_every steps and once at the end) adds a
    G forward.
    """
    steps = niters - start
    img_logs = sum(1 for i in range(start, niters) if i % img_every == 0) + 1
    return {"fwd": steps * (iter_d + 1 + 2 * iter_d + 1) + img_logs,
            "bwd": steps * (1 + 2 * iter_d + 1)}


def train_phase(ca, tmp: str) -> dict:
    import numpy as np
    import torch

    data = os.path.join(tmp, "train.npz")
    rng = np.random.default_rng(0)
    np.savez(data, X=np.tanh(rng.standard_normal((48, 64, 64, 64),
                                                 np.float32)))
    log_dir = os.path.join(tmp, "run")
    base = FLAGSHIP + [f"--data_path={data}", f"--log_dir={log_dir}"]
    results = {}
    for niters, start in TRAIN_RUNS:
        ca.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        out = run_cli(base + [f"--niters={niters}"])
        got = {"fwd": ca.fwd_launches, "bwd": ca.bwd_launches}
        want = expected_launches(start, niters, 2, 50)
        if got != want or not got["fwd"] or not got["bwd"]:
            raise AssertionError(f"launches {got} != expected {want}")
        if start and f"starting from step {start}" not in out:
            raise AssertionError(f"resume did not print 'starting from step "
                                 f"{start}'")
        if f"[{niters - 1}|{niters}]\tD(x): " not in out:
            raise AssertionError(f"no log line for step {niters - 1}")
        ckpt = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                          map_location="cpu", weights_only=True)
        vals = ckpt["lossG"] + [x for pair in ckpt["lossD"] for x in pair]
        if (len(ckpt["lossG"]) != niters
                or not all(math.isfinite(x) for x in vals)):
            raise AssertionError(f"{len(ckpt['lossG'])} G losses for "
                                 f"{niters} steps, or a non-finite loss")
        done = re.search(r"\.\.\.Done \((\d+) steps in ([\d.]+)s, ([\d.]+) "
                         r"steps/s(?:; steady ([\d.]+) steps/s = ([\d.]+) "
                         r"vol/s)?\)", out)
        if done is None:
            raise AssertionError("no '...Done' line")
        results[f"run_{start}_{niters}"] = {
            "steps": int(done.group(1)), "seconds": float(done.group(2)),
            "steps_per_s": float(done.group(3)),
            "steady_steps_per_s": (float(done.group(4)) if done.group(4)
                                   else None),
            "steady_vol_per_s": (float(done.group(5)) if done.group(5)
                                 else None),
            "launches": got, "max_memory_allocated":
                torch.cuda.max_memory_allocated()}
        phase("train_run", niters=niters, **results[f"run_{start}_{niters}"])
    last = TRAIN_RUNS[-1][0] - 1
    for f in ("params.json", "models/checkpoint.pt", f"images/{last}.png"):
        if not os.path.isfile(os.path.join(log_dir, f)):
            raise AssertionError(f"missing {f}")
    return results


def model_check(log_dir: str) -> dict:
    """The trained G and D, in f32 and eval mode: on the card (kernels)
    against the same weights on the CPU (plain attention)."""
    import torch

    from gan3d_tpu_torch.config import Config
    from gan3d_tpu_torch.models import build_models

    cfg = Config.load(log_dir).replace(compute_dtype="float32")
    payload = torch.load(os.path.join(log_dir, "models", "checkpoint.pt"),
                         map_location="cpu", weights_only=True)
    G, D = build_models(cfg)
    G.load_state_dict(payload["modelG_state_dict"])
    D.load_state_dict(payload["modelD_state_dict"])
    G.eval()
    D.eval()
    z = torch.randn((2, cfg.z_size), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        x_cpu = G(z)
        d_cpu = D(x_cpu)
        Gc, Dc = copy.deepcopy(G).cuda(), copy.deepcopy(D).cuda()
        x_gpu = Gc(z.cuda())
        d_gpu = Dc(x_cpu.cuda())
    if x_gpu.shape != (2, 1, 64, 64, 64) or not torch.isfinite(x_gpu).all():
        raise AssertionError(f"bad sample {tuple(x_gpu.shape)}")
    # cuDNN and the CPU sum in different orders; 1e-3 of the tanh range.
    ex = (x_gpu.cpu() - x_cpu).abs().max().item()
    ed = ((d_gpu.cpu() - d_cpu).abs().max()
          / d_cpu.abs().max().clamp_min(1e-30)).item()
    if not (ex <= 1e-3 and ed <= 1e-3):
        raise AssertionError(f"card vs CPU: G max err {ex:.3e}, D rel err "
                             f"{ed:.3e} (tol 1e-3)")
    return {"g_max_abs_err": ex, "d_rel_err": ed, "tol": 1e-3}


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
    from gan3d_tpu_torch.ops.attention import attention_plain

    t0 = time.time()
    lib = ca.build()
    with open(os.path.join(os.path.dirname(lib), "ptxas.log")) as f:
        ptxas = [ln.strip() for ln in f
                 if any(w in ln for w in ("entry function", "registers",
                                          "spill"))]
    phase("build", seconds=time.time() - t0, library=os.path.relpath(lib, REPO),
          ptxas=ptxas)

    cases = kernel_phase(ca, attention_plain)
    phase("kernel_extra", **extra_checks(ca, attention_plain))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train = train_phase(ca, tmp)
        phase("model_check", **model_check(os.path.join(tmp, "run")))
    launches = train["run_%d_%d" % TRAIN_RUNS[0][::-1]]["launches"]
    print(json.dumps(kernels_line(cases, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
