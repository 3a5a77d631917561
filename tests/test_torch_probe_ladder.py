"""The port's probe ladder against the JAX probe ladders on the CPU.

Each of the 14 rungs of scripts/probe_mosaic.py and scripts/probe_mosaic2.py
runs in Pallas interpret mode; the port's rung (its kernel's plain version
on a CPU tensor) must compute the same array from the same inputs: copies
and slices bit-equal, including the last sample's values for lane_concat27
and minor_slice_reshape (their output block is revisited by every grid
step); the products summed over both samples (wide_dot_accum, dw_skeleton:
f32; the port's and the JAX probe's each within 1e-5 of max |exact| of a
float64 product of the same bf16 inputs, since both sum 432 products per
element in f32 in orders of their own, and elements near zero differ by
that order's noise alone) or rounded to bf16 (wide_fwd_skeleton: 2e-2 of
max |ref|).
The ladder's entry raises without a card, and the kernel wrappers refuse
CPU tensors. The gram27 kernel's premise (a tap's view is view 0 shifted
by a constant row offset) is checked against ``views27``, and a numpy
emulation of its fixed summation order against the JAX probe's t_dot;
the im2col27 kernel's launch (``im2col27_units``) writes each output unit
once, from the right input unit, in whole rows a block.
"""

import numpy as np
import pytest
import torch

import jax
from jax.experimental.pallas import tpu as pltpu

import scripts.probe_mosaic as pm
import scripts.probe_mosaic2 as pm2
from gan3d_tpu_torch.probes import mosaic_ladder as ml

torch.set_num_threads(1)

JAX_RUNGS = {
    "copy": pm.t_copy, "cost_estimate": pm.t_cost, "manual_dma": pm.t_dma,
    "dma_dyn_slot": pm.t_dslot, "dma_when_guard": pm.t_when,
    "dma_pds_src": pm.t_pds, "dma_pds_src_offset": pm.t_pds_off,
    "dma_double_buffer": pm.t_dma2, "lane_concat27": pm.t_concat,
    "wide_dot_accum": pm.t_dot, "dw_skeleton": pm.t_full,
    "lane_value_slice": pm2.t_lane, "minor_slice_reshape": pm2.t_resh,
    "wide_fwd_skeleton": pm2.t_fwd,
}


def bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16)


def test_inputs_are_the_probes_inputs():
    inp = ml.inputs("cpu")
    for got, want in ((inp.x, pm.X), (inp.xt, pm2.XT), (inp.w2, pm2.W2)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(got.view(torch.int16).numpy()),
                                      bits(np.asarray(want)))


def test_ladder_has_every_rung():
    assert [name for name, _, _ in ml.RUNGS] == list(JAX_RUNGS)
    assert {k for _, _, k in ml.RUNGS} == set(ml.KERNELS)


@pytest.mark.parametrize("name,rung,kernel", ml.RUNGS,
                         ids=[name for name, _, _ in ml.RUNGS])
def test_rung_matches_jax_probe(name, rung, kernel):
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(JAX_RUNGS[name])())
    ml.reset_counters()
    got = rung(ml.inputs("cpu"))
    assert all(v == 0 for v in ml.launches.values())
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if kernel == "gram27":
        x = ml.inputs("cpu").x
        exact = sum(v[:, :ml.C].T @ v for v in
                    (ml.views27(x[i]).double() for i in range(x.shape[0])))
        exact = exact.numpy()
        scale = np.abs(exact).max()
        for what in (got.numpy(), want):
            assert np.abs(what - exact).max() / scale <= ml.TOL[kernel]
    elif kernel == "wide_fwd":
        ref = want.astype(np.float32)
        err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= ml.TOL[kernel]
    else:
        np.testing.assert_array_equal(bits(got.view(torch.int16).numpy()),
                                      bits(want))


def test_run_reports_and_goes_on(capsys):
    assert ml.run("good", lambda: torch.ones(2)) is True
    assert ml.run("bad", lambda: 1 / 0) is False
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["good", "OK", "(1.000)"]
    assert out[1].split()[:3] == ["bad", "FAIL", "ZeroDivisionError:"]


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ml.main()


def test_kernel_wrappers_refuse_cpu_tensors():
    inp = ml.inputs("cpu")
    for call in (lambda: ml.box_copy_cuda(inp.x, ml.WHOLE),
                 lambda: ml.im2col27_cuda(inp.x),
                 lambda: ml.gram27_cuda(inp.x, bulk=True),
                 lambda: ml.wide_fwd_cuda(inp.w2, inp.xt)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_tap_is_a_row_offset_of_view_zero():
    """Row r of the view at shift (kd, kh, kw) is the position of row r of
    view 0 plus (kd * 8 + kh) * 8 + kw, for all 216 rows and 27 taps: what
    the gram27 kernel's one table of rows relies on."""
    pos = torch.arange(ml.S ** 3, dtype=torch.float64).reshape(ml.S, ml.S,
                                                               ml.S, 1)
    views = ml.views27(pos.expand(-1, -1, -1, ml.C))     # [216, 27 * 32]
    base = views[:, 0]
    for t, (kd, kh, kw) in enumerate(ml.TAPS):
        assert torch.equal(views[:, t * ml.C],
                           base + (kd * ml.S + kh) * ml.S + kw), t
    r = torch.arange(ml.V ** 3)
    assert torch.equal(base.long(), ((r // 36) * ml.S + (r // 6) % 6) * ml.S
                       + r % 6)


def test_im2col27_launch_writes_every_unit_once():
    """im2col27_kernel's launch on blocks of IM2COL_ROWS rows, in its own
    index arithmetic (``im2col27_units``): every one of the 216 x 108
    16-byte output units is stored exactly once, from the sample's unit
    that ``views27`` puts there; each block's units are its own whole rows,
    one contiguous span, and no two blocks share a row."""
    rows = ml.IM2COL_ROWS
    dst, src = ml.im2col27_units()
    units = 27 * ml.C // 8
    assert dst.shape == (ml.V ** 3 // rows, units, rows)
    assert np.bincount(dst.ravel(), minlength=ml.V ** 3 * units).max() == 1
    assert dst.size == ml.V ** 3 * units
    # the input unit each output unit must come from: the sample's units
    # numbered, put through the plain views
    ids = torch.arange(ml.SAMPLE // 8, dtype=torch.float64)
    want = ml.views27(ids.repeat_interleave(8).reshape(ml.S, ml.S, ml.S,
                                                       ml.C))
    want = want.reshape(-1, 8)[:, 0].long().numpy()
    np.testing.assert_array_equal(src.ravel(), want[dst.ravel()])
    for b in range(dst.shape[0]):
        span = np.sort(dst[b].ravel())
        np.testing.assert_array_equal(
            span, np.arange(b * rows * units, (b + 1) * rows * units))
    # a warp's 32 stores of one row are one contiguous run
    assert (np.diff(dst[:, :32, :], axis=1) == 1).all()


# csrc/probe_ladder.cu gram27_kernel: the 216 rows padded to 14 k-steps of
# 16; two groups of 4 warps, group g walking samples g, g + 2, ...; warp w
# of a group taking k-steps [14 w / 4, 14 (w + 1) / 4)
GRAM_STEPS, GROUP_WARPS = 14, 4


def emulate_gram27(x: np.ndarray) -> np.ndarray:
    """The gram27 kernel's summation order in numpy f32: each warp sums
    one 16-row product (an mma) after another into its f32 partial, over
    its samples in order, then over its k-steps in order; the 8 partials
    are added in warp order (group 0's warps, then group 1's)."""
    parts = []
    for group in range(2):
        for w in range(GROUP_WARPS):
            acc = np.zeros((ml.C, 27 * ml.C), np.float32)
            for s in range(group, x.shape[0], 2):
                v = ml.views27(torch.from_numpy(x[s])).numpy()
                v = np.concatenate([v, np.zeros((GRAM_STEPS * 16 - len(v),
                                                 v.shape[1]), np.float32)])
                for kk in range(GRAM_STEPS * w // GROUP_WARPS,
                                GRAM_STEPS * (w + 1) // GROUP_WARPS):
                    blk = v[kk * 16:(kk + 1) * 16]
                    acc = acc + blk[:, :ml.C].T @ blk
            parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def test_gram27_summation_order_matches_jax_probe():
    """The emulation of the kernel's fixed order against the JAX probe's
    t_dot (interpret mode), within 1e-5 of its largest |value|."""
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(pm.t_dot)())
    got = emulate_gram27(ml.inputs("cpu").x.float().numpy())
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() <= ml.TOL["gram27"]


# ---------------------------------------------------------------------------
# box_copy_kernel's launch plans (ml.box_plan), for every box as the rungs
# launch it


def words(src: np.ndarray) -> np.ndarray:
    """The source as little-endian 32-bit words of two values."""
    return src.astype(np.uint32)[0::2] | (src.astype(np.uint32)[1::2] << 16)


def emulate_direct(plan: ml.Plan, src: np.ndarray):
    """box_copy_kernel<false>'s index arithmetic on plan, in numpy: each
    thread's row, its 16-byte units, the aligned 16-byte loads or the
    4-byte words shifted by the row's odd value. Returns (out, the times
    each output value was written)."""
    units, tx = plan.length // 8, 1 << plan.tx_log2
    out = np.zeros(plan.n * plan.rows * plan.length, np.uint16)
    writes = np.zeros(out.size, np.int64)
    w32 = words(np.concatenate([src, np.zeros(len(src) % 2, np.uint16)]))
    t = np.arange(plan.threads)
    for s in range(plan.grid_z):
        for by in range(plan.grid_y):
            for bx in range(plan.grid_x):
                r = by * (plan.threads // tx) + (t >> plan.tx_log2)
                live = r < plan.rows
                r = r[live]
                j = r // plan.b
                at = (plan.off + s * plan.sn + j * plan.sa
                      + (r - j * plan.b) * plan.sb)
                e0 = (bx * plan.items << plan.tx_log2) + (t[live] & (tx - 1))
                for m in range(plan.items):
                    e = e0 + (m << plan.tx_log2)
                    ok = e < units
                    for a_, e_, r_ in zip(at[ok], e[ok], r[ok]):
                        if a_ % 8 == 0:
                            v = src[a_ + 8 * e_:a_ + 8 * e_ + 8]
                        else:
                            half = a_ & 1
                            first = (a_ - half) // 2 + 4 * e_
                            assert 2 * (first + 4 + half) <= len(src) + 1
                            w = w32[first:first + 4 + half].astype(np.uint64)
                            if half:
                                w = (w[:4] >> 16) | (w[1:] << 16)
                            w = w.astype(np.uint32)
                            v = np.stack([w & 0xFFFF, w >> 16], 1).reshape(-1)
                        o = (s * plan.rows + r_) * plan.length + 8 * e_
                        out[o:o + 8] = v
                        writes[o:o + 8] += 1
    return out, writes


def emulate_bulk(plan: ml.Plan, src: np.ndarray):
    """box_copy_kernel<true> on plan, in numpy: for each block and each
    sample it walks, the tensor copy of its sub-box (the copy unit's rules
    checked: a 16-byte aligned base, strides and inner box rows, at most
    256 values a box dim, the sub-box inside the tensor) into the sample's
    slot (128-byte aligned), the barrier armed with exactly the bytes the
    copy delivers, then the slot's one bulk write-out (16-byte aligned, a
    multiple of 16 bytes). Returns (out, write counts)."""
    rank, dims, box = plan.rank, plan.dims, plan.box
    strides = (1,) + plan.strides
    vals = int(np.prod(box))
    slot_bytes = -(-2 * vals // 128) * 128
    assert ml.bulk_smem(plan) == 128 + plan.slots * slot_bytes <= ml.MAX_SMEM
    assert (plan.grid_x, plan.grid_y, plan.grid_z) == (
        plan.parts, plan.n // plan.walk, 1) and plan.n % plan.walk == 0
    assert (2 * plan.off) % 16 == 0 and (2 * box[0]) % 16 == 0
    assert all((2 * st) % 16 == 0 for st in plan.strides)
    assert max(box) <= 256 and dims[rank - 1] == plan.n
    assert dims[rank:] == box[rank:] == (1,) * (5 - rank)
    out = np.zeros(plan.n * plan.rows * plan.length, np.uint16)
    writes = np.zeros(out.size, np.int64)
    # the sub-box's element offsets, dim 0 fastest (the slot's order)
    grid = np.meshgrid(*(np.arange(e) for e in box), indexing="ij")
    offsets = sum(g.transpose(*range(4, -1, -1)).reshape(-1) * st
                  for g, st in zip(grid, strides))
    for by in range(plan.grid_y):
        for part in range(plan.grid_x):
            for j in range(plan.walk):
                s = by * plan.walk + j
                coord = [0] * 5
                coord[rank - 2] = part * box[rank - 2]
                coord[rank - 1] = s
                assert all(c + b <= e for c, b, e in zip(coord, box, dims))
                at = plan.off + sum(c * st for c, st in zip(coord, strides))
                assert at + offsets.max() < len(src)
                slot = src[at + offsets]
                expect_tx = 2 * vals
                assert expect_tx == 2 * slot.size
                dst = 128 + (s % plan.slots) * slot_bytes
                assert dst % 128 == 0
                o = s * plan.rows * plan.length + part * vals
                assert (2 * o) % 16 == 0 and (2 * vals) % 16 == 0
                out[o:o + vals] = slot
                writes[o:o + vals] += 1
    return out, writes


def test_box_plans_cover_every_box_exactly_once():
    """For every box rung, the plan its wrapper makes, emulated: every
    value of the box is copied exactly once to its place (the output
    equals the plain gather), and the bulk copies are 16-byte aligned
    multiples of 16 bytes, armed with exactly their bytes, in shared
    memory under 227 KB."""
    assert sorted(ml.BOX_RUNGS) == sorted(n for n, _, k in ml.RUNGS
                                          if k == "box_copy")
    inp = ml.inputs("cpu")
    for name, (src_name, box, walk, slots, bulk) in ml.BOX_RUNGS.items():
        src = getattr(inp, src_name).reshape(-1).view(torch.int16).numpy()
        src = src.view(np.uint16)
        plan = ml.box_plan(box, walk, slots, bulk)
        assert (plan.bulk, plan.walk, plan.slots) == (int(bulk), walk, slots)
        got, writes = (emulate_bulk if bulk else emulate_direct)(plan, src)
        want = ml.box_plain(torch.from_numpy(src.view(np.int16)), box)
        assert (writes == 1).all(), name
        np.testing.assert_array_equal(got, want.numpy().view(np.uint16)
                                      .reshape(-1), err_msg=name)


def test_box_plans_merge_rows_and_take_one_copy_a_sample():
    """The plans the ladder's boxes get: PDS's 6 rows of a j-plane merge
    (one 3 KB run, then rows of 256 values for the copy unit), PDS_OFF's
    do not; a bulk rung's sample is split over blocks of at least 2 KB
    along its outermost dim, one tensor copy a block, except t_dma2's: one
    block walking both samples; a direct thread moves one or two 16-byte
    units and the copies spread over several blocks; the plans with other
    splits cover the boxes too."""
    assert ml.merged_rows(ml.PDS) == (6, 1, 6 * ml.S * ml.C, ml.S * ml.S
                                      * ml.C, 0)
    assert ml.tensor_dims(ml.PDS)[0] == (ml.S * ml.C, 6, 6, ml.N)
    assert ml.tensor_dims(ml.PDS_OFF)[0] == (6 * ml.C, 6, 6, ml.N)
    assert ml.tensor_dims(ml.WHOLE)[0] == (256, ml.SAMPLE // 256, ml.N)
    parts = {ml.WHOLE: 16, ml.PDS: 6, ml.PDS_OFF: 6}
    for name, (_, box, walk, slots, bulk) in ml.BOX_RUNGS.items():
        plan = ml.box_plan(box, walk, slots, bulk)
        if bulk:
            assert plan.parts == (1 if walk > 1 else parts[box]), name
            assert int(np.prod(plan.box)) * plan.parts == \
                box.a * box.b * box.length, name
        else:
            assert 1 <= plan.items <= ml.MAX_ITEMS
            assert plan.grid_x * plan.grid_y * plan.grid_z > 1
    dma2 = ml.box_plan(ml.PDS, walk=2, slots=2, bulk=True)
    assert (dma2.grid_x, dma2.grid_y, dma2.grid_z) == (1, 1, 1)
    x = ml.inputs("cpu").x.reshape(-1).view(torch.int16).numpy()
    for box, walk, slots, parts in ((ml.PDS_OFF, 1, 1, 3), (ml.PDS, 2, 2, 2),
                                    (ml.WHOLE, 1, 2, 1), (ml.WHOLE, 2, 1, 4)):
        plan = ml.box_plan(box, walk, slots, True, parts)
        got, writes = emulate_bulk(plan, x.view(np.uint16))
        assert (writes == 1).all()
        np.testing.assert_array_equal(
            got, ml.box_plain(torch.from_numpy(x), box).numpy()
            .view(np.uint16).reshape(-1))


def test_box_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="16-byte units"):
        ml.box_plan(ml.Box(0, 2, 1, 1, 12, 12, 0, 0))
    with pytest.raises(ValueError, match="bulk-mode"):
        ml.box_plan(ml.WHOLE, walk=2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ml.box_plan(ml.LANE, bulk=True)
    with pytest.raises(ValueError, match="do not divide"):
        ml.box_plan(ml.PDS_OFF, bulk=True, parts=5)
    with pytest.raises(ValueError, match="past 256"):
        ml.box_plan(ml.Box(0, 2, 300, 1, 8, 8 * 600, 16, 0), bulk=True)
    with pytest.raises(ValueError, match="shared memory"):
        ml.box_plan(ml.Box(0, 2, 256, 1, 256, 256 * 512, 512, 0),
                    walk=2, slots=2, bulk=True)


# ---------------------------------------------------------------------------
# wide_fwd_kernel: the swapped product out^T = X27^T W2^T, warp w on m tile
# w, the taps kd*9 + t sharing one A fragment, one f32 accumulator a kd
# (chains of 9), the three added in kd order and rounded once to bf16

FWD_POS = ml.DD * (ml.H + 2) * (ml.W + 2)   # 200 padded positions
FWD_W2_STRIDE = 55                          # W2's rows in 16-byte units


def fwd_row0(warp: int, m: np.ndarray) -> np.ndarray:
    """The staged row (padded position) of position m of warp's m tile at
    tap (0, 0): csrc/probe_ladder.cu wide_fwd_kernel's r0, with m = 8 (tile
    & 1) + lane % 8."""
    return (((warp >> 2) * (ml.H + 2) + (warp & 3) * 2 + m // 8) * (ml.W + 2)
            + m % 8)


def fwd_swz(r, c):
    """The 16-byte unit of chunk c (ci 8c .. 8c+7) of staged row r."""
    return 2 * r + (c ^ ((r >> 2) & 1))


def bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def emulate_wide_fwd(w2: np.ndarray, xt: np.ndarray) -> np.ndarray:
    """The kernel's arithmetic in numpy f32 (w2, xt: bf16 values as f32)."""
    n = xt.shape[0]
    out = np.zeros((n, 8, ml.DD * ml.H * ml.W), np.float32)
    m = np.arange(16)
    for s in range(n):
        xs = xt[s].reshape(ml.CI, FWD_POS).T         # channels-innermost
        for warp in range(8):
            acc = np.zeros((3, 16, 8), np.float32)
            for t9 in range(9):
                a = xs[fwd_row0(warp, m) + (t9 // 3) * (ml.W + 2) + t9 % 3]
                for kd in range(3):
                    tap = kd * 9 + t9
                    b = w2[:, tap * ml.CI:(tap + 1) * ml.CI].T
                    acc[kd] = acc[kd] + a @ b
            tile = (acc[0] + acc[1]) + acc[2]
            out[s, :, warp * 16:(warp + 1) * 16] = bf16(tile).T
    return out


def test_wide_fwd_emulation_matches_jax_probe():
    """The emulation against the JAX probe's t_fwd (interpret mode), within
    the ladder's 2e-2 of its largest |value|."""
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(pm2.t_fwd)()).astype(np.float32)
    inp = ml.inputs("cpu")
    got = emulate_wide_fwd(inp.w2.float().numpy(), inp.xt.float().numpy())
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() <= ml.TOL["wide_fwd"]


def test_wide_fwd_ldmatrix_is_free_of_bank_conflicts():
    """Every ldmatrix tile of the kernel reads its 8 rows from 8 different
    bank groups (16-byte units mod 8): A at every tap (all 27) of every m
    tile, and B (W2's rows 55 units apart) at every k-step; the restage
    writes every unit of the staged sample exactly once."""
    lane = np.arange(32)
    tile = lane >> 3
    for warp in range(8):
        r0 = fwd_row0(warp, 8 * (tile & 1) + (lane & 7))
        for _, kh, kw in ml.TAPS:
            unit = fwd_swz(r0 + kh * (ml.W + 2) + kw, tile >> 1)
            assert unit.max() < 2 * FWD_POS
            for i in range(4):
                assert len(set(unit[8 * i:8 * i + 8] % 8)) == 8
    for k in range(27):
        unit = (lane % 8) * FWD_W2_STRIDE + 2 * k + (lane >> 3) % 2
        for i in range(2):
            assert len(set(unit[8 * i:8 * i + 8] % 8)) == 8
    t = np.arange(FWD_POS)
    p, half = 2 * (t % (FWD_POS // 2)), t // (FWD_POS // 2)
    staged = np.concatenate([fwd_swz(p, half), fwd_swz(p + 1, half)])
    assert sorted(staged) == list(range(2 * FWD_POS))
