"""The tensor-core routes of K3 (dW, bf16 and f32), K4 (the wide conv,
f32) and K5 (the W-Toeplitz conv, bf16 and f32) on the CPU: what of them
runs without a card.

- the launch plans (``dw_tc_plan``, ``toeplitz_tc_plan``,
  ``toeplitz_x3_plan``) at every flagship and bench shape and the chip
  check's ragged ones: grid limits, shared memory (two blocks an SM for
  the bf16 routes), every position covered, and K3's split-K parts
  covering every box exactly once; the f32 route's parts covering every
  chunk of input channels once, none summing more than 2048 terms in the
  tensor cores;
- K5's weight repacks (DHWIO, as the forward and as dx takes it; the f32
  route's split into TF32 halves) against their definitions, bit for bit;
- numpy emulations of the two kernels' data movement (csrc/conv3d_k3.cu
  ``dw_tc_kernel``, csrc/conv3d_toeplitz.cu ``toeplitz_tc_kernel``): the
  staged boxes, the halo-row table, each tap's row offset, the repacked
  weight, and for K3 the split-K partials summed in the kernel's fixed
  order, on bf16-rounded inputs with f32 sums; against the plain versions
  (1e-5 of max |plain|: both sum in f32, in other orders) and, for K3,
  against ``gan3d_tpu.ops.dw_conv.conv3d_dw`` in Pallas interpret mode;
- emulations of the f32 routes' arithmetic (csrc/conv3d_k3.cu
  ``wide_tf32x3_kernel``, csrc/conv3d_toeplitz.cu ``toeplitz_tf32x3_kernel``):
  the repacked weight's TF32 halves, x split where read, three products a
  k8 step (a_lo b_hi, a_hi b_lo, a_hi b_hi) in the kernels' order of
  chunks, planes and taps, the plan's split-K parts summed in order;
  against the plain versions and against ``gan3d_tpu.ops.wide_conv.
  wide_conv3d`` / ``pallas_conv.pallas_conv3d`` in Pallas interpret mode,
  forward and dx, with one case of 27 * Ci > 2048; and of K3's
  (``dw_tf32x3_kernel``): g and x both split where read, hi truncated,
  each part's boxes
  in order, chains of at most 2048 positions added into a running sum,
  the parts summed in order; against ``conv3d_dw_plain`` and
  ``gan3d_tpu.ops.dw_conv.conv3d_dw`` in interpret mode, with a ragged
  shape, split-K parts, and a part of two chains;
- ``probes/conv_f32.py`` (the f32 conv routes alone on the card) checks
  chip_smoke.py's conv shapes, reads ptxas's registers and spills, and
  raises without a card;
- the bf16 routes refuse CPU tensors and count nothing.

Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gan3d_tpu.ops import dw_conv, pallas_conv, wide_conv
from gan3d_tpu_torch.ops import cuda_conv
from gan3d_tpu_torch.ops import toeplitz_conv as tc
from gan3d_tpu_torch.ops.conv3d import conv3d_dw_plain, conv3d_k3_plain
from gan3d_tpu_torch.ops.cuda_build import SMS

from test_torch_attention import split_tf32, tf32_rna  # noqa: E402

torch.set_num_threads(1)

cdiv = cuda_conv._cdiv
# (channels, side) of the flagship's eligible convs, G then D
FLAGSHIP = [(128, 4), (128, 8), (128, 16), (64, 16), (64, 32), (32, 32),
            (32, 64), (256, 8), (256, 4)]
# (N, Ci, Co, D, H, W): the flagship's convs at N=16, the chip check's
# ragged shapes (chip_smoke.py CONV_RAGGED) and a deep, thin column
DW_SHAPES = ([(16, c, c, r, r, r) for c, r in FLAGSHIP]
             + [(1, 8, 256, 3, 5, 7), (2, 24, 8, 5, 9, 3),
                (1, 16, 40, 1, 1, 33), (3, 40, 16, 7, 6, 70),
                (1, 256, 8, 4, 4, 4), (1, 200, 72, 20, 18, 36),
                (1, 8, 8, 200, 1, 1)])
# (N, D, H, W, Ci, Co): scripts/bench_lane_conv.py's shapes at batch 16,
# the chip check's checked ones (chip_smoke.py TOEPLITZ_EXTRA), both ways
# round for dx, and a tall, narrow volume
TOEPLITZ_SHAPES = ([(16, s, s, s, c, c) for c, s in ((16, 64), (32, 64),
                                                      (32, 32), (64, 32),
                                                      (128, 16))]
                   + [(2, 4, 4, 8, 32, 32), (1, 3, 5, 8, 16, 16),
                      (1, 4, 4, 8, 8, 64), (1, 4, 4, 8, 64, 8),
                      (3, 5, 7, 12, 24, 40), (3, 5, 7, 12, 40, 24),
                      (2, 3, 37, 70, 20, 40), (2, 3, 37, 70, 40, 20),
                      (1, 2, 4000, 1, 8, 8)])


def bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, as f32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def split_k(nboxes: int, p: int) -> list:
    """Part j's boxes [nboxes*j//p, nboxes*(j+1)//p), as the kernel walks
    them."""
    return [range(nboxes * j // p, nboxes * (j + 1) // p) for j in range(p)]


@pytest.mark.parametrize("n,ci,co,d,h,w", DW_SHAPES)
def test_dw_tc_plan_covers_every_box_once_and_fits_the_card(n, ci, co, d,
                                                           h, w):
    td, th, tw, p = cuda_conv.dw_tc_plan(n, ci, co, d, h, w)
    assert 1 <= td <= d and 1 <= th <= h and 1 <= tw <= min(w, 32)
    assert td * th * tw <= cuda_conv.DW_TC_BOX
    nboxes = n * cdiv(d, td) * cdiv(h, th) * cdiv(w, tw)
    assert nboxes * td * th * tw >= n * d * h * w
    assert 1 <= p <= nboxes
    walked = [b for part in split_k(nboxes, p) for b in part]
    assert walked == list(range(nboxes))
    assert all(len(part) for part in split_k(nboxes, p))
    # two blocks an SM (launch bounds and shared memory)
    assert 2 * cuda_conv.dw_tc_smem(td, th, tw) <= 227 * 1024
    assert cdiv(ci, 16) <= 65535 and cdiv(co, cuda_conv.DW_CO) <= 65535
    tiles = cdiv(ci, 16) * cdiv(co, cuda_conv.DW_CO)
    # one wave of blocks that fills the card, where the boxes allow it
    assert p * tiles <= 2 * SMS or p == 1
    assert p * tiles >= SMS or p == nboxes


def chains_within_2048(ci: int, p: int) -> bool:
    """The f32 routes' split-K parts: part j sums chunks [chunks*j//p,
    chunks*(j+1)//p) of 8 input channels; each chunk, every chunk covered
    once, and no part summing more than 2048 terms (27 taps x 8 channels a
    chunk) in the tensor cores, whose f32 sums are not rounded to
    nearest."""
    chunks = cdiv(ci, cuda_conv.X3_CI)
    parts = [range(chunks * j // p, chunks * (j + 1) // p) for j in range(p)]
    return (1 <= p <= chunks and [c for r in parts for c in r]
            == list(range(chunks))
            and max(len(r) for r in parts) * 27 * cuda_conv.X3_CI <= 2048)


@pytest.mark.parametrize("route", ["bf16", "f32"])
@pytest.mark.parametrize("n,d,h,w,ci,co", TOEPLITZ_SHAPES)
def test_toeplitz_tc_plan_covers_the_volume_and_fits_the_card(n, d, h, w, ci,
                                                             co, route):
    """The bf16 route's block (toeplitz_tc_plan) within two blocks an SM;
    the f32 route's (toeplitz_x3_plan) within one block's shared memory,
    with its split-K parts (chains_within_2048) filling the card where
    the grid is smaller than it."""
    if route == "bf16":
        bh, bw, wn = cuda_conv.toeplitz_tc_plan(n, d, h, w, co)
        warps = cuda_conv.TOEPLITZ_TC_WARPS
        # two blocks an SM (launch bounds and shared memory)
        assert 2 * cuda_conv.toeplitz_tc_smem(bh, bw, wn) <= 227 * 1024
    else:
        bh, bw, wn, p = cuda_conv.toeplitz_x3_plan(n, d, h, w, ci, co)
        warps = cuda_conv.X3_WARPS
        assert cuda_conv.toeplitz_x3_smem(bh, bw, wn) <= 227 * 1024
        assert chains_within_2048(ci, p)
        grid = n * d * cdiv(h, bh) * cdiv(w, bw) * cdiv(co, 32 * wn)
        assert grid * p >= SMS or p == cdiv(ci, 8)
    assert (wn == 1) == (co <= 32)
    assert 1 <= bh <= h and 1 <= bw <= min(w, 32)
    assert bh * bw <= 64 * (warps // wn)
    blocks = n * d * cdiv(h, bh) * cdiv(w, bw)
    assert blocks * bh * bw >= n * d * h * w and blocks < 2 ** 31
    assert cdiv(co, 32 * wn) <= 65535


@pytest.mark.parametrize("route", ["bf16", "f32"])
@pytest.mark.parametrize("ci,co", [(8, 8), (20, 40), (32, 32), (128, 64)])
def test_toeplitz_weight_repack_is_exact(ci, co, route):
    """repack_toeplitz_weight lays w [3, 3, 3, Ci, Co] out as [Ci/16, 27,
    Cop, 16] with wp[i // 16, tap, o, i % 16] = w[tap, i, o] and zeros in
    the padding, bit for bit; for the dx weight (flipped in space, Ci/Co
    swapped, as ToeplitzConv3d.backward builds it) that entry is
    w[26 - tap, o, i]. The f32 route's repack_toeplitz_weight_x3: [2,
    Ci/8, 27, Cop, 8], plane 0 the hi and plane 1 the lo TF32 half
    (split_tf32) of that entry at [., i // 8, tap, o, i % 8]."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, ci, co)).astype(
        np.float32))
    if route == "bf16":
        w = w.bfloat16()
    k = 16 if route == "bf16" else 8
    for name, wt in (("fwd", w),
                     ("dx", w.flip(0, 1, 2).transpose(3, 4).contiguous())):
        i_n, o_n = wt.shape[3:]
        i, o, t = (torch.from_numpy(a) for a in np.meshgrid(
            np.arange(i_n), np.arange(o_n), np.arange(27), indexing="ij"))
        w27 = w.reshape(27, ci, co)
        want = w27[t, i, o] if name == "fwd" else w27[26 - t, o, i]
        if route == "bf16":
            planes = cuda_conv.repack_toeplitz_weight(wt)[None]
            wants = [want]
            assert planes.dtype == torch.bfloat16
        else:
            planes = cuda_conv.repack_toeplitz_weight_x3(wt)
            wants = split_tf32(want)
            assert planes.dtype == torch.float32
        assert planes.is_contiguous()
        assert planes.shape[1:] == (cdiv(i_n, k), 27, cdiv(o_n, 64) * 64,
                                    k), name
        for wp, want in zip(planes, wants):
            got = wp[i // k, t, o, i % k]
            assert torch.equal(got, want), name
            rest = wp.clone()
            rest[i // k, t, o, i % k] = 0
            assert not rest.any(), name


def emulate_dw_tc(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """dw_tc_kernel's data movement in numpy: x [N,Ci,D,H,W], g
    [N,Co,D,H,W] (f32 holding bf16 values) -> f32 [Co, Ci, 3, 3, 3]."""
    n, ci, d, h, w = x.shape
    co = g.shape[1]
    td, th, tw, p = cuda_conv.dw_tc_plan(n, ci, co, d, h, w)
    nbd, nbh, nbw = cdiv(d, td), cdiv(h, th), cdiv(w, tw)
    HB, WB = th + 2, tw + 2
    box = td * th * tw
    kpad = cdiv(box, 16) * 16
    s = np.arange(kpad)
    wl, hl, dl = s % tw, (s // tw) % th, s // (tw * th)
    hrow = np.where(s < box, (dl * HB + hl) * WB + wl, 0)
    toff = [(kd * HB + kh) * WB + kw
            for kd in range(3) for kh in range(3) for kw in range(3)]
    # zero outside the volume, wide enough for the ragged last boxes
    xp = np.pad(x, ((0, 0), (0, 0), (1, nbd * td - d + 1),
                    (1, nbh * th - h + 1), (1, nbw * tw - w + 1)))
    gp = np.pad(g, ((0, 0), (0, 0), (0, nbd * td - d), (0, nbh * th - h),
                    (0, nbw * tw - w)))
    part = np.zeros((p, co, ci, 27), np.float32)
    for j, boxes in enumerate(split_k(n * nbd * nbh * nbw, p)):
        for b in boxes:
            b, bw = divmod(b, nbw)
            b, bh = divmod(b, nbh)
            i, bd = divmod(b, nbd)
            d0, h0, w0 = bd * td, bh * th, bw * tw
            xs = (xp[i, :, d0:d0 + td + 2, h0:h0 + HB, w0:w0 + WB]
                  .reshape(ci, -1).T)                       # [halo rows, ci]
            gs = np.zeros((kpad, co), np.float32)
            gs[:box] = (gp[i, :, d0:d0 + td, h0:h0 + th, w0:w0 + tw]
                        .reshape(co, -1).T)
            for tap in range(27):
                part[j, :, :, tap] += gs.T @ xs[hrow + toff[tap]]
    dw = np.zeros((co, ci, 27), np.float32)
    for j in range(p):
        dw += part[j]
    return dw.reshape(co, ci, 3, 3, 3)


@pytest.mark.parametrize("n,ci,co,d,h,w", [(2, 16, 24, 5, 9, 7),
                                           (1, 8, 40, 3, 5, 33),
                                           (2, 40, 16, 4, 4, 4)])
def test_dw_tc_emulation_matches_plain(n, ci, co, d, h, w):
    rng = np.random.default_rng(9)
    x = bf16(rng.normal(size=(n, ci, d, h, w)).astype(np.float32))
    g = bf16(rng.normal(size=(n, co, d, h, w)).astype(np.float32))
    got = emulate_dw_tc(x, g)
    want = conv3d_dw_plain(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_dw_tc_emulation_matches_jax_dw_conv():
    """At tests/test_dw_conv.py's deep shape, against the Pallas dW in
    interpret mode (f32 sums of the same bf16-valued inputs)."""
    rng = np.random.default_rng(10)
    x = bf16(rng.normal(size=(1, 4, 32, 32, 8)).astype(np.float32))
    g = bf16(rng.normal(size=(1, 4, 32, 32, 64)).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(dw_conv.conv3d_dw(jnp.asarray(x), jnp.asarray(g)))
    got = emulate_dw_tc(np.ascontiguousarray(np.moveaxis(x, -1, 1)),
                        np.ascontiguousarray(np.moveaxis(g, -1, 1)))
    got = got.transpose(2, 3, 4, 1, 0)                      # DHWIO
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def emulate_toeplitz_tc(x: np.ndarray, w: torch.Tensor) -> np.ndarray:
    """toeplitz_tc_kernel's data movement in numpy: x [N,D,H,W,Ci] (f32
    holding bf16 values), w [3,3,3,Ci,Co] bf16 -> f32 [N,D,H,W,Co]."""
    n, d, h, wd, ci = x.shape
    co = w.shape[4]
    bh, bw, _ = cuda_conv.toeplitz_tc_plan(n, d, h, wd, co)
    wp = cuda_conv.repack_toeplitz_weight(w).float().numpy()
    stages = wp.shape[0]
    nbh, nbw = cdiv(h, bh), cdiv(wd, bw)
    HB, WB = bh + 2, bw + 2
    s = np.arange(bh * bw)
    hrow = (s // bw) * WB + s % bw
    toff = [(a * HB + b) * WB + c
            for a in range(3) for b in range(3) for c in range(3)]
    xp = np.pad(x, ((0, 0), (1, 1), (1, nbh * bh - h + 1),
                    (1, nbw * bw - wd + 1), (0, 16 * stages - ci)))
    out = np.zeros((n, d, nbh * bh, nbw * bw, co), np.float32)
    for i in range(n):
        for dd in range(d):
            for bhi in range(nbh):
                for bwi in range(nbw):
                    h0, w0 = bhi * bh, bwi * bw
                    xs = xp[i, dd:dd + 3, h0:h0 + HB, w0:w0 + WB].reshape(
                        -1, stages, 16)
                    acc = np.zeros((bh * bw, wp.shape[2]), np.float32)
                    for c in range(stages):
                        for tap in range(27):
                            acc += xs[hrow + toff[tap], c] @ wp[c, tap].T
                    out[i, dd, h0:h0 + bh, w0:w0 + bw] = acc[:, :co].reshape(
                        bh, bw, co)
    return out[:, :, :h, :wd]


@pytest.mark.parametrize("shape,ci,co,t", [((1, 3, 5, 8), 16, 16, 8),
                                           ((2, 3, 7, 12), 24, 40, 4),
                                           ((1, 2, 37, 70), 20, 40, 2)])
def test_toeplitz_tc_emulation_matches_plain(shape, ci, co, t):
    """The forward, and dx as ToeplitzConv3d.backward calls the conv (the
    output gradient with the flipped, swapped weight)."""
    rng = np.random.default_rng(11)
    x = bf16(rng.normal(size=(*shape, ci)).astype(np.float32))
    g = bf16(rng.normal(size=(*shape, co)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, ci, co))
                          / np.sqrt(27 * ci)).astype(np.float32)).bfloat16()
    w_flip = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    for inp, wt in ((x, w), (g, w_flip)):
        got = emulate_toeplitz_tc(inp, wt)
        want = tc.toeplitz_conv3d_plain(torch.from_numpy(inp), wt.float(),
                                        t).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# The f32 routes' emulations against the plain versions and the JAX
# kernels: 2e-5 of max |reference|. Both sides sum f32 products in f32 in
# other orders; the emulation's products carry 3xTF32's ~2^-21 relative
# error (a_lo b_lo dropped, lo rounded to TF32), a few 1e-6 of the largest
# value at these sizes; the route's contract is 1e-4.
X3_TOL = 2e-5
# (N, Ci, Co, D, H, W): a ragged volume, Ci != Co, and Ci = 80, whose
# 27 * 80 = 2160 terms the plan splits into parts
X3_WIDE = [(2, 16, 24, 3, 5, 7), (1, 24, 8, 4, 4, 4), (1, 80, 16, 4, 4, 8)]
# ((N, D, H, W), Ci, Co, t): tests/test_pallas_conv.py's non-cubic shape,
# ragged channels with Ci != Co, and Ci = 80
X3_TOEPLITZ = [((1, 3, 5, 8), 16, 16, 8), ((2, 3, 7, 12), 20, 36, 4),
               ((1, 4, 4, 8), 80, 16, 4)]


def emulate_wide_tf32x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """wide_tf32x3_kernel's arithmetic: x [N,Ci,D,H,W], w [Co,Ci,3,3,3]
    f32 -> f32 [N,Co,D,H,W]. A is the weight's TF32 halves as
    repack_weight_x3 lays them out, B x split where read; part j of the
    plan's P sums its chunks c, each input plane kd, tap (kh, kw) as the
    products a_lo b_hi, a_hi b_lo, a_hi b_hi of that k8 step, and the
    parts are summed in order (tc::sum_partials)."""
    n, ci, d, h, wd = x.shape
    co = w.shape[0]
    p = cuda_conv.wide_x3_plan(n, ci, co, d, h, wd)[4]
    wp = cuda_conv.repack_weight_x3(w)[:, :, :, :co]    # [2, chunks, 27, Co, 8]
    chunks = wp.shape[1]
    xh, xl = split_tf32(F.pad(x, (1, 1, 1, 1, 1, 1, 0, 8 * chunks - ci)))
    out = torch.zeros((n, co, d * h * wd))
    for j in range(p):
        acc = torch.zeros((n, co, d * h * wd))
        for c in range(chunks * j // p, chunks * (j + 1) // p):
            for tap in range(27):
                kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
                bh, bl = (v[:, 8 * c:8 * c + 8, kd:kd + d, kh:kh + h,
                            kw:kw + wd].reshape(n, 8, -1) for v in (xh, xl))
                ah, al = wp[0, c, tap], wp[1, c, tap]
                for a, b in ((al, bh), (ah, bl), (ah, bh)):
                    acc += torch.einsum("ok,nks->nos", a, b)
        out += acc
    return out.reshape(n, co, d, h, wd)


def emulate_toeplitz_tf32x3(x: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """toeplitz_tf32x3_kernel's arithmetic: x [N,D,H,W,Ci], w
    [3,3,3,Ci,Co] f32 -> f32 [N,D,H,W,Co]. A is x split where read, B the
    weight's TF32 halves as repack_toeplitz_weight_x3 lays them out; part
    j sums its chunks c, each input plane a, tap (b, c') as the products
    a_lo b_hi, a_hi b_lo, a_hi b_hi, and the parts are summed in order."""
    n, d, h, wd, ci = x.shape
    co = w.shape[4]
    p = cuda_conv.toeplitz_x3_plan(n, d, h, wd, ci, co)[3]
    wp = cuda_conv.repack_toeplitz_weight_x3(w)[:, :, :, :co]
    chunks = wp.shape[1]
    xh, xl = split_tf32(F.pad(x, (0, 8 * chunks - ci, 1, 1, 1, 1, 1, 1)))
    out = torch.zeros((n, d, h, wd, co))
    for j in range(p):
        acc = torch.zeros((n, d, h, wd, co))
        for c in range(chunks * j // p, chunks * (j + 1) // p):
            for tap in range(27):
                kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
                ah, al = (v[:, kd:kd + d, kh:kh + h, kw:kw + wd,
                            8 * c:8 * c + 8] for v in (xh, xl))
                bh, bl = wp[0, c, tap], wp[1, c, tap]
                for a, b in ((al, bh), (ah, bl), (ah, bh)):
                    acc += a @ b.T
        out += acc
    return out


def _x3_inputs(seed, x_shape, g_shape, w_shape, ci):
    rng = np.random.default_rng(seed)
    x, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in (x_shape, g_shape))
    w = torch.from_numpy((rng.normal(size=w_shape) / np.sqrt(27 * ci))
                         .astype(np.float32))
    return x, g, w


def _rel(got, want) -> float:
    got, want = (np.asarray(v, np.float64) for v in (got, want))
    return np.abs(got - want).max() / np.abs(want).max()


# The JAX kernels (Pallas in interpret mode), compiled once a shape.
jax_wide = jax.jit(wide_conv.wide_conv3d)
jax_conv = jax.jit(pallas_conv.pallas_conv3d, static_argnums=2)


@pytest.mark.parametrize("n,ci,co,d,h,w", X3_WIDE)
def test_wide_tf32x3_emulation_matches_plain_and_jax(n, ci, co, d, h, w):
    """The forward, and dx as WideConv3d.backward calls the conv (the
    output gradient with the flipped, swapped weight), against
    conv3d_k3_plain; the forward also against the JAX wide_conv3d (Pallas,
    interpret mode) of the same inputs in NDHWC / DHWIO (dx is the same
    kernel on other operands; a JAX compile a shape is most of the
    test's time)."""
    x, g, wt = _x3_inputs(12, (n, ci, d, h, w), (n, co, d, h, w),
                          (co, ci, 3, 3, 3), ci)
    if ci == 80:
        assert cuda_conv.wide_x3_plan(n, ci, co, d, h, w)[4] > 1
    wr = wt.flip(2, 3, 4).transpose(0, 1).contiguous()
    for inp, weight in ((x, wt), (g, wr)):
        got = emulate_wide_tf32x3(inp, weight)
        assert _rel(got, conv3d_k3_plain(inp, weight)) <= X3_TOL
        if inp is x:
            with pltpu.force_tpu_interpret_mode():
                ref = jax_wide(jnp.asarray(x.permute(0, 2, 3, 4, 1).numpy()),
                               jnp.asarray(wt.permute(2, 3, 4, 1, 0).numpy()))
            assert _rel(got.permute(0, 2, 3, 4, 1), ref) <= X3_TOL


def split_tf32_trunc(x: torch.Tensor) -> tuple:
    """(hi, lo) = (x truncated to TF32, rna(x - hi)): csrc/mma_tf32.cuh
    split_tf32_trunc."""
    hi = (x.view(torch.int32) & -8192).view(torch.float32)
    return hi, tf32_rna(x - hi)


def emulate_dw_tf32x3(x: torch.Tensor, g: torch.Tensor, plan=None
                      ) -> torch.Tensor:
    """dw_tf32x3_kernel's arithmetic: x [N,Ci,D,H,W], g [N,Co,D,H,W] f32
    -> f32 [Co, Ci, 3, 3, 3], on the plan (td, th, tw, P) (dw_x3_plan's
    unless given). Part j walks its boxes of the (n, bd, bh, bw) list in
    order (positions past the volume zero); a box adds each tap's products
    a_lo b_hi, a_hi b_lo, a_hi b_hi of g (A) and x shifted by the tap (B),
    both split where read (hi truncated: ``split_tf32_trunc``), into the
    chain's sum, which after every
    DW_X3_CHAIN // (the box rounded up to 8) boxes of the part, and at its
    end, is added into the part's running sum; the parts' sums are added
    in order (tc::sum_partials)."""
    n, ci, d, h, w = x.shape
    co = g.shape[1]
    td, th, tw, p = plan or cuda_conv.dw_x3_plan(n, ci, co, d, h, w)
    nbd, nbh, nbw = cdiv(d, td), cdiv(h, th), cdiv(w, tw)
    chain = cuda_conv.DW_X3_CHAIN // (cdiv(td * th * tw, 8) * 8)
    xh, xl = split_tf32_trunc(F.pad(x, (1, nbw * tw - w + 1, 1,
                                        nbh * th - h + 1, 1, nbd * td - d + 1)))
    gh, gl = split_tf32_trunc(F.pad(g, (0, nbw * tw - w, 0, nbh * th - h,
                                        0, nbd * td - d)))
    out = torch.zeros((co, ci, 27))
    for boxes in split_k(n * nbd * nbh * nbw, p):
        run = torch.zeros((co, ci, 27))
        acc = torch.zeros((co, ci, 27))
        for i, b in enumerate(boxes):
            b, bw = divmod(b, nbw)
            b, bh = divmod(b, nbh)
            s, bd = divmod(b, nbd)
            d0, h0, w0 = bd * td, bh * th, bw * tw
            ah, al = (v[s, :, d0:d0 + td, h0:h0 + th, w0:w0 + tw]
                      .reshape(co, -1) for v in (gh, gl))
            for tap in range(27):
                kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
                bh_, bl_ = (v[s, :, d0 + kd:d0 + kd + td, h0 + kh:h0 + kh + th,
                              w0 + kw:w0 + kw + tw].reshape(ci, -1)
                            for v in (xh, xl))
                for a, bt in ((al, bh_), (ah, bl_), (ah, bh_)):
                    acc[:, :, tap] += a @ bt.T
            if (i + 1) % chain == 0 or i + 1 == len(boxes):
                run += acc
                acc.zero_()
        out += run
    return out.reshape(co, ci, 3, 3, 3)


# (N, Ci, Co, D, H, W, plan): a ragged volume and channels split into 4
# parts of one box (dw_x3_plan's P = 4); Ci > 16 and Co > 32 (several
# channel tiles, the last ragged), boxes of 5 x 3 x 12, P = 2; and, on a
# plan with one part, 16 boxes of 256
# positions: two chains of MMAs (the plan's P fills the card at these
# sizes, so a CPU-sized volume never sums more than one chain in a part;
# chip_smoke.py's CONV_RAGGED holds one whose plan does, on the card)
X3_DW = [(2, 16, 24, 5, 9, 7, None), (1, 24, 40, 5, 6, 12, None),
         (1, 8, 8, 16, 16, 16, (4, 4, 16, 1))]
jax_dw = jax.jit(dw_conv.conv3d_dw)


@pytest.mark.parametrize("n,ci,co,d,h,w,plan", X3_DW)
def test_dw_tf32x3_emulation_matches_plain_and_jax(n, ci, co, d, h, w, plan):
    """Against conv3d_dw_plain and the JAX conv3d_dw (Pallas, interpret
    mode) of the same inputs in NDHWC."""
    x, g, _ = _x3_inputs(14, (n, ci, d, h, w), (n, co, d, h, w),
                         (co, ci, 3, 3, 3), ci)
    td, th, tw, p = plan or cuda_conv.dw_x3_plan(n, ci, co, d, h, w)
    boxes = n * cdiv(d, td) * cdiv(h, th) * cdiv(w, tw)
    chain = cuda_conv.DW_X3_CHAIN // (cdiv(td * th * tw, 8) * 8)
    assert (p > 1) == (plan is None)
    assert (cdiv(boxes, p) > chain) == (plan is not None)
    got = emulate_dw_tf32x3(x, g, plan)
    assert _rel(got, conv3d_dw_plain(x, g)) <= X3_TOL
    with pltpu.force_tpu_interpret_mode():
        ref = jax_dw(jnp.asarray(x.permute(0, 2, 3, 4, 1).numpy()),
                     jnp.asarray(g.permute(0, 2, 3, 4, 1).numpy()))
    assert _rel(got.permute(2, 3, 4, 1, 0), ref) <= X3_TOL


@pytest.mark.parametrize("shape,ci,co,t", X3_TOEPLITZ)
def test_toeplitz_tf32x3_emulation_matches_plain_and_jax(shape, ci, co, t):
    """The forward, and dx as ToeplitzConv3d.backward calls the conv,
    against toeplitz_conv3d_plain; the forward also against the JAX
    pallas_conv3d (interpret mode)."""
    x, g, w = _x3_inputs(13, (*shape, ci), (*shape, co), (3, 3, 3, ci, co),
                         ci)
    if ci == 80:
        n, d, h, wd = shape
        assert cuda_conv.toeplitz_x3_plan(n, d, h, wd, ci, co)[3] > 1
    w_flip = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    for inp, wt in ((x, w), (g, w_flip)):
        got = emulate_toeplitz_tf32x3(inp, wt)
        assert _rel(got, tc.toeplitz_conv3d_plain(inp, wt, t)) <= X3_TOL
        if inp is x:
            with pltpu.force_tpu_interpret_mode():
                ref = jax_conv(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                               t)
            assert _rel(got, ref) <= X3_TOL


def test_conv_f32_probe_shapes_ptxas_and_card_check(tmp_path,
                                                    monkeypatch):
    """probes/conv_f32.py checks chip_smoke.py's conv shapes (the
    flagship's G and D, StyleGAN-1's G whole and on a space rank's halo'd
    slab, the ragged ones) for K4 and K3, times the same ones, reads each
    f32 conv kernel instance's registers and spills (K4, K3, K5) off
    ptxas.log, and raises without a card."""
    import chip_smoke
    from gan3d_tpu_torch.probes import conv_f32

    want = ({(16, c, c, r, r, r) for c, r in chip_smoke.CONV_G
             + chip_smoke.CONV_D}
            | {(16, ci, co, r, r, r) for ci, co, r in chip_smoke.CONV_SG1}
            | {(16, ci, co, r // chip_smoke.SP_SPACE + 2, r, r)
               for ci, co, r in chip_smoke.CONV_SG1}
            | set(chip_smoke.CONV_RAGGED))
    assert set(conv_f32.SHAPES) == want
    assert conv_f32.TIMED <= want
    (tmp_path / "ptxas.log").write_text(
        "ptxas info : Compiling entry function '_ZN45_GLOBAL__N__1_12_conv3d"
        "_k3_cu_218wide_tf32x3_kernelILi2ELb1EEEvPKfS2_PfS3_NS_4GeomEi'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info : Used 210 registers, used 1 barriers\n"
        "ptxas info : Compiling entry function '_ZN45_GLOBAL__N__1_12_conv3d"
        "_k3_cu_218dw_tf32x3_kernelILb0EEEvPKfS2_PfNS_4GeomEi'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info : Used 165 registers, used 1 barriers\n"
        "ptxas info : Compiling entry function '_Z13dw_tc_kerneli'\n"
        "ptxas info : Used 93 registers\n")
    got = conv_f32._registers([str(tmp_path / "libconv3d_k3.so")])
    assert got == {"wide_tf32x3_kernel<2,1>": [210, 8],
                   "dw_tf32x3_kernel<0>": [165, 0]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conv_f32.main()


def test_bf16_routes_refuse_cpu_tensors():
    cuda_conv.reset_counters()
    x = torch.zeros((1, 8, 2, 2, 2), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda_conv.conv3d_dw_cuda(x, x)
    xl = torch.zeros((1, 2, 2, 4, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda_conv.toeplitz_conv3d_cuda(
            xl, torch.zeros((3, 3, 3, 8, 8), dtype=torch.bfloat16))
    assert cuda_conv.dw_tc_launches == cuda_conv.dw_launches == 0
    assert cuda_conv.toeplitz_tc_launches == cuda_conv.toeplitz_launches == 0
