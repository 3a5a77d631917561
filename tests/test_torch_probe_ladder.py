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
emulation of its fixed summation order against the JAX probe's t_dot.
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
