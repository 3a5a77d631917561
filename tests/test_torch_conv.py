"""The port's k3 convs against the JAX package's Pallas kernels (CPU).

- ``conv3d_k3_plain`` (the wide-N conv's plain version) against
  ``gan3d_tpu.ops.wide_conv.wide_conv3d`` in Pallas interpret mode, at the
  shapes of tests/test_wide_conv.py, f32 (atol/rtol 1e-4) and one bf16
  case (2e-2 of max |ref|: both accumulate in f32, the outputs round to
  bf16);
- ``conv3d_dw_plain`` against ``dw_conv.conv3d_dw`` in interpret mode, at
  the shapes of tests/test_dw_conv.py (1e-4);
- the autograd Functions ``WideConv3d`` / ``Conv3dK3Dw`` on the CPU: the
  forward and (dx, dW) through tanh against ``jax.grad`` of
  ``wide_conv3d`` / ``conv3d_k3_dw`` in interpret mode (1e-4 / 1e-5);
- the dispatcher's modes and eligibility, the kernels' tiling plans (the
  f32 and bf16 routes of K4, and K3; StyleGAN-1's G shapes, whole and on
  a space rank's slab, both ways round for dx) and the weight repacks of
  both routes (the f32 route's split into TF32 halves);
- the port's eligibility admits every flagship conv the JAX rule admits
  (it also admits the three the JAX VMEM budgets turn down).

Inputs come from a numpy seed and are transposed NDHWC <-> NCDHW and
DHWIO <-> OIDHW.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gan3d_tpu.ops import dw_conv, wide_conv
from gan3d_tpu_torch.ops import conv3d as tconv
from gan3d_tpu_torch.ops import cuda_conv
from gan3d_tpu_torch.ops.cuda_build import SMS

from test_torch_attention import split_tf32  # noqa: E402
from test_torch_layers import jax_reference_lowering  # noqa: F401,E402

torch.set_num_threads(1)

WIDE_SHAPES = [(2, (4, 4, 8), 16, 16), (1, (3, 5, 8), 8, 16),
               (1, (8, 4, 4), 16, 32), (2, (2, 8, 8), 32, 8)]
DW_SHAPES = WIDE_SHAPES + [(1, (4, 32, 32), 8, 64)]
# (channels, side) of the flagship's eligible convs (64^3 BigGAN-Deep,
# filters 64): G, then D, two convs (conv2, conv3) per deep block.
FLAGSHIP_G = [(128, 4), (128, 8), (128, 8), (128, 16), (64, 16), (64, 32),
              (32, 32), (32, 64)]
FLAGSHIP_D = [(32, 64), (32, 32), (64, 32), (64, 16), (128, 16), (128, 8),
              (256, 8), (256, 4)]


# The JAX references (Pallas in interpret mode) under jax.jit: one
# compiled program a shape rather than eager dispatch of every grid step.
jax_wide = jax.jit(wide_conv.wide_conv3d)
jax_dw = jax.jit(dw_conv.conv3d_dw)


def ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def oidhw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


def to_ndhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def to_dhwio(t):
    return t.detach().float().numpy().transpose(2, 3, 4, 1, 0)


def inputs(seed, n, spatial, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, *spatial, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)
         ).astype(np.float32)
    return x, w


@pytest.mark.parametrize("n,spatial,cin,cout", WIDE_SHAPES)
def test_conv3d_k3_plain_matches_pallas_wide(n, spatial, cin, cout):
    x, w = inputs(0, n, spatial, cin, cout)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_wide(jnp.asarray(x), jnp.asarray(w)))
    got = tconv.conv3d_k3_plain(ncdhw(x), oidhw(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_ndhwc(got), ref, rtol=1e-4, atol=1e-4)


def test_conv3d_k3_plain_matches_pallas_wide_bf16():
    x, w = inputs(4, 2, (4, 8, 8), 16, 16)
    xb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_wide(xb, wb).astype(jnp.float32))
    got = tconv.conv3d_k3_plain(ncdhw(np.asarray(xb.astype(jnp.float32)))
                                .bfloat16(),
                                oidhw(np.asarray(wb.astype(jnp.float32)))
                                .bfloat16())
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(to_ndhwc(got) / scale, ref / scale, atol=2e-2)


@pytest.mark.parametrize("n,spatial,cin,cout", DW_SHAPES)
def test_conv3d_dw_plain_matches_pallas_dw(n, spatial, cin, cout):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, *spatial, cin)).astype(np.float32)
    g = rng.normal(size=(n, *spatial, cout)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_dw(jnp.asarray(x), jnp.asarray(g)))
    got = tconv.conv3d_dw_plain(ncdhw(x), ncdhw(g))
    assert got.dtype == torch.float32 and got.shape == (cout, cin, 3, 3, 3)
    np.testing.assert_allclose(to_dhwio(got), ref, rtol=1e-4, atol=1e-4)


def test_plain_versions_are_the_same_across_chunks(monkeypatch):
    """Depth chunks of one row each give the result of one chunk."""
    x, w = inputs(5, 2, (5, 3, 4), 8, 16)
    g = np.random.default_rng(6).normal(size=(2, 16, 5, 3, 4)).astype(
        np.float32)
    xt, wt, gt = ncdhw(x), oidhw(w), torch.from_numpy(g)
    whole = (tconv.conv3d_k3_plain(xt, wt), tconv.conv3d_dw_plain(xt, gt))
    monkeypatch.setattr(tconv, "CHUNK_BYTES", 1)
    rows = (tconv.conv3d_k3_plain(xt, wt), tconv.conv3d_dw_plain(xt, gt))
    torch.testing.assert_close(rows[0], whole[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(rows[1], whole[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["wide", "dw"])
def test_functions_match_jax_custom_vjps(kind):
    """Forward, dx and dW through tanh: the port's Function (plain versions
    inside, on the CPU) against jax.grad of the JAX custom VJP (Pallas in
    interpret mode)."""
    cout = 8 if kind == "wide" else 16
    x, w = inputs(1, 2, (4, 4, 8), 16, cout)
    jfn = wide_conv.wide_conv3d if kind == "wide" else dw_conv.conv3d_k3_dw
    fn = cuda_conv.WideConv3d if kind == "wide" else cuda_conv.Conv3dK3Dw

    def loss(x_, w_):
        return jnp.sum(jnp.tanh(jfn(x_, w_)))

    with pltpu.force_tpu_interpret_mode():
        y_ref = np.asarray(jax.jit(jfn)(jnp.asarray(x), jnp.asarray(w)))
        gx_ref, gw_ref = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jnp.asarray(x), jnp.asarray(w))
    xt = ncdhw(x).requires_grad_(True)
    wt = oidhw(w).requires_grad_(True)
    y = fn.apply(xt, wt)
    assert y.grad_fn.name().startswith(fn.__name__)
    torch.tanh(y).sum().backward()
    np.testing.assert_allclose(to_ndhwc(y), y_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_ndhwc(xt.grad), np.asarray(gx_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_dhwio(wt.grad), np.asarray(gw_ref),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("needs", [(True, False), (False, True)])
def test_functions_compute_only_the_gradients_asked_for(needs, monkeypatch):
    calls = []
    monkeypatch.setattr(cuda_conv, "_dw", lambda x, g: calls.append("dw")
                        or tconv.conv3d_dw_plain(x, g))
    x, w = inputs(2, 1, (3, 3, 4), 8, 8)
    xt = ncdhw(x).requires_grad_(needs[0])
    wt = oidhw(w).requires_grad_(needs[1])
    cuda_conv.WideConv3d.apply(xt, wt).sum().backward()
    assert (xt.grad is not None) == needs[0]
    assert (wt.grad is not None) == needs[1]
    assert calls == (["dw"] if needs[1] else [])


def _route(x, w, **kw):
    x = x.clone().requires_grad_(True)
    return tconv.conv3d(x, w, **kw).grad_fn.name()


@pytest.mark.parametrize("wide,dw,want", [
    ("auto", "auto", "Convolution"), ("off", "off", "Convolution"),
    ("on", "auto", "WideConv3d"), ("on", "on", "WideConv3d"),
    ("off", "on", "Conv3dK3Dw"), ("auto", "on", "Conv3dK3Dw")])
def test_dispatch_follows_the_modes(wide, dw, want):
    x = torch.randn((1, 8, 4, 4, 4))
    w = torch.randn((8, 8, 3, 3, 3))
    try:
        tconv.set_wide_conv_mode(wide)
        tconv.set_fast_dw_mode(dw)
        assert _route(x, w, padding=1).startswith(want)
        # not eligible: stride 2, k=1, Ci < 8, Co < 8 stay plain
        assert _route(x, w, stride=2, padding=1).startswith("Convolution")
        assert _route(x, w[:, :, :1, :1, :1]).startswith("Convolution")
        assert _route(x[:, :4], w[:, :4], padding=1).startswith(
            "Convolution")
        assert _route(x, w[:4], padding=1).startswith("Convolution")
    finally:
        tconv.set_wide_conv_mode("auto")
        tconv.set_fast_dw_mode("auto")


def test_dispatch_adds_the_bias_after_the_kernel_route():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 8, 3, 4, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(12, 8, 3, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(12,)).astype(np.float32))
    want = F.conv3d(x, w, b, 1, 1)
    try:
        for mode in ("on", "off"):
            tconv.set_wide_conv_mode(mode)
            tconv.set_fast_dw_mode("on")
            torch.testing.assert_close(tconv.conv3d(x, w, b, 1, 1), want,
                                       rtol=1e-5, atol=1e-5)
    finally:
        tconv.set_wide_conv_mode("auto")
        tconv.set_fast_dw_mode("auto")


@pytest.mark.parametrize("mode", ["", "true", "On", None])
def test_modes_outside_off_auto_on_raise(mode):
    for setter in (tconv.set_wide_conv_mode, tconv.set_fast_dw_mode):
        with pytest.raises(ValueError, match="not in"):
            setter(mode)
    assert not tconv.wide_conv_enabled() and not tconv.fast_dw_enabled()


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 8, 2, 2, 2))
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda_conv.wide_conv3d_cuda(x, torch.zeros((8, 8, 3, 3, 3)))
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda_conv.conv3d_dw_cuda(x, x)


@pytest.mark.parametrize("route", ["bf16", "f32"])
@pytest.mark.parametrize("co,ci", [(8, 8), (40, 24), (32, 32), (64, 128)])
def test_weight_repack_is_exact(co, ci, route):
    """repack_weight lays w [Co, Ci, 3, 3, 3] out as [Ci/16, 27, Cop, 16]
    with wp[i // 16, tap, o, i % 16] = w[o, i, tap] and zeros in the padding,
    bit for bit; for the dx weight (flipped in space, in/out swapped) that
    entry is w[i, o, 26 - tap]. The f32 route's repack_weight_x3: [2, Ci/8,
    27, Cop (a multiple of 128), 8], plane 0 the hi and plane 1 the lo
    TF32 half (split_tf32) of that entry at [., i // 8, tap, o, i % 8]."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(size=(co, ci, 3, 3, 3)).astype(
        np.float32))
    if route == "bf16":
        w = w.bfloat16()
    k, pad = (16, 64) if route == "bf16" else (8, 128)
    for name, wt in (("fwd", w), ("dx", w.flip(2, 3, 4).transpose(0, 1))):
        o_n, i_n = wt.shape[:2]
        o, i, t = (torch.from_numpy(a) for a in np.meshgrid(
            np.arange(o_n), np.arange(i_n), np.arange(27), indexing="ij"))
        want = (w.reshape(co, ci, 27)[o, i, t] if name == "fwd"
                else w.reshape(co, ci, 27)[i, o, 26 - t])
        if route == "bf16":
            planes, wants = cuda_conv.repack_weight(wt)[None], [want]
            assert planes.dtype == torch.bfloat16
        else:
            planes = cuda_conv.repack_weight_x3(wt.contiguous())
            wants = split_tf32(want)
            assert planes.dtype == torch.float32
        assert planes.is_contiguous()
        assert planes.shape[1:] == (-(-i_n // k), 27, -(-o_n // pad) * pad,
                                    k), name
        for wp, want in zip(planes, wants):
            got = wp[i // k, t, o, i % k]
            assert torch.equal(got, want), name
            rest = wp.clone()
            rest[i // k, t, o, i % k] = 0
            assert not rest.any(), name


def test_bf16_routes_refuse_cpu_tensors():
    """The bf16 routes (tensor-core kernels) take CUDA tensors only, like
    the f32 ones; a refused call counts no launch."""
    from gan3d_tpu_torch.ops import cuda_attention

    cuda_conv.reset_counters()
    cuda_attention.reset_counters()
    x = torch.zeros((1, 8, 2, 2, 2), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda_conv.wide_conv3d_cuda(x, torch.zeros((8, 8, 3, 3, 3),
                                                  dtype=torch.bfloat16))
    q = torch.zeros((1, 64, 16), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda_attention.attention_bwd(q, k, k, q, torch.zeros((1, 64)), q)
    assert cuda_conv.wide_tc_launches == cuda_conv.wide_launches == 0
    assert (cuda_attention.bwd_tc_launches == cuda_attention.bwd_launches
            == 0)


def _flagship_k3_convs(monkeypatch):
    """(Ci, Co, D, H, W) of every conv the port's rule admits, in call
    order, from forward pre-hooks over the port's 64^3 flagship G and D on
    the meta device (attention stubbed: it has no meta implementation)."""
    import gan3d_tpu_torch.nn.attention as tattn
    from gan3d_tpu_torch.config import Config
    from gan3d_tpu_torch.models import build_models
    from gan3d_tpu_torch.nn.layers import Conv3d

    monkeypatch.setattr(tattn, "pooled_attention",
                        lambda q, k, v: torch.empty_like(q))
    cfg = Config(resolution=64, filterG=64, filterD=64, z_size=512,
                 biggan=True, hinge=True, compute_dtype="float32")
    with torch.device("meta"):
        G, D = build_models(cfg)
    seen = {"G": [], "D": []}
    for name, net in (("G", G), ("D", D)):
        for m in net.modules():
            if isinstance(m, Conv3d):
                m.register_forward_pre_hook(
                    lambda mod, args, name=name: seen[name].append(
                        (mod.weight.shape[1], mod.weight.shape[0],
                         *args[0].shape[2:]))
                    if tconv.eligible(args[0].shape, mod.weight.shape,
                                      mod.stride, mod.padding) else None)
    with torch.no_grad():
        D(G(torch.zeros((16, 512), device="meta")))
    return seen


def test_port_rule_admits_every_flagship_conv_the_jax_rule_admits(
        monkeypatch):
    seen = _flagship_k3_convs(monkeypatch)
    for name, want in (("G", FLAGSHIP_G), ("D", FLAGSHIP_D)):
        assert seen[name] == [(c, c, r, r, r) for c, r in want
                              for _ in range(2)], name
    refused = set()
    for ci, co, d, h, w in seen["G"] + seen["D"]:
        args = ((16, d, h, w, ci), (3, 3, 3, ci, co), (1, 1, 1), (1, 1, 1),
                (1, 1, 1), 1)
        assert tconv.eligible((16, ci, d, h, w), (co, ci, 3, 3, 3), 1, 1)
        if not (wide_conv.eligible(*args) and dw_conv.eligible(*args)):
            refused.add((ci, d))
    # the JAX VMEM budgets turn these down; the port takes them (docstring)
    assert refused == {(32, 64), (64, 32), (256, 8)}


@pytest.mark.parametrize("ci,co,r", [(8, 8, 4), (16, 64, 12), (32, 8, 8),
                                     (8, 8, 40), (64, 64, 16)])
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0)])
def test_port_rule_admits_what_the_jax_rules_admit(ci, co, r, stride,
                                                   padding):
    s, p = (stride,) * 3, (padding,) * 3
    for k in (3, 1):
        args = ((2, r, r, r, ci), (k, k, k, ci, co), s, p, (1, 1, 1), 1)
        if wide_conv.eligible(*args) or dw_conv.eligible(*args):
            assert tconv.eligible((2, ci, r, r, r), (co, ci, k, k, k),
                                  stride, padding)
        assert tconv.eligible((2, ci, r, r, r), (co, ci, k, k, k), stride,
                              padding) == (k == 3 and s == (1, 1, 1)
                                           and p == (1, 1, 1))


# StyleGAN-1's G convs at 64^3 (chip_smoke.py CONV_SG1): (Ci, Co, side)
SG1_G = [(512, 512, 4), (512, 256, 8), (256, 256, 8), (256, 128, 16),
         (128, 128, 16), (128, 64, 32), (64, 64, 32), (64, 32, 64)]
# Every distinct flagship conv (N=16); StyleGAN-1's G convs whose Ci != Co
# (the dx way round too: 512 and 256 channels in) and on a space rank's
# halo'd slab (chip_smoke.py SG1_s2: half the depth and two planes); the
# chip check's ragged shapes (chip_smoke.py CONV_RAGGED) and a deep, thin
# column.
PLAN_SHAPES = ([(16, c, c, r, r, r) for c, r in sorted(set(FLAGSHIP_G
                                                          + FLAGSHIP_D))]
               + [(16, a, b, r, r, r) for ci, co, r in SG1_G if ci != co
                  for a, b in ((ci, co), (co, ci))]
               + [(16, ci, co, r // 2 + 2, r, r) for ci, co, r in SG1_G]
               + [(1, 8, 256, 3, 5, 7), (2, 24, 8, 5, 9, 3),
                  (1, 16, 40, 1, 1, 33), (3, 40, 16, 7, 6, 70),
                  (1, 256, 8, 4, 4, 4), (1, 200, 72, 20, 18, 36),
                  (1, 8, 8, 200, 1, 1)])


@pytest.mark.parametrize("n,ci,co,d,h,w", PLAN_SHAPES)
def test_tiling_plans_cover_the_volume_and_fit_the_card(n, ci, co, d, h, w):
    """The launch plans the kernels take: boxes inside the thread and
    shared-memory limits of csrc/conv3d_k3.cu, every output covered, and a
    grid of at least one block per SM where the volume allows it."""
    cdiv = cuda_conv._cdiv
    # K4 bf16: a box of at most 64 * (4 // wm) positions (the block's 4
    # warps x 64 cover it), 32 * wm output channels, P split-K parts of
    # the Ci/16 stages, within 227 KB of shared memory (with the cp.async
    # staging buffer where W and tw are multiples of 4: launch_wide_tc)
    td, th, tw, wm, p = cuda_conv.wide_tc_plan(n, ci, co, d, h, w)
    assert wm in (1, 2) and (wm == 1) == (co <= 32)
    assert 1 <= td <= d and 1 <= th <= h and 1 <= tw <= min(w, 32)
    assert td * th * tw <= 64 * (4 // wm)
    stages = cdiv(ci, cuda_conv.TC_CI)
    assert 1 <= p <= stages
    halo = (td + 2) * (th + 2) * (tw + 2)
    raw = (2 * 16 * (td + 2) * (th + 2) * (tw + 8)
           if w % 4 == 0 and tw % 4 == 0 else 0)
    assert 32 * (halo + 27 * 32 * wm) + raw <= 227 * 1024
    boxes = n * cdiv(d, td) * cdiv(h, th) * cdiv(w, tw)
    assert boxes * td * th * tw >= n * d * h * w
    blocks = boxes * cdiv(co, 32 * wm) * p
    assert blocks >= SMS or p == stages
    # K4 f32: 8 warps of 64 positions x 32 channels, a box of at most
    # 64 * (8 // wm) positions, within 227 KB (two x and two weight stages,
    # csrc launch_wide_x3); P parts of the Ci/8 chunks, each chunk once and
    # none summing more than 2048 terms in the tensor cores; the grid
    # fills the card where the chunks allow
    td, th, tw, wm, p = cuda_conv.wide_x3_plan(n, ci, co, d, h, w)
    assert wm in (1, 2, 4) and (wm == 1) == (co <= 32)
    assert 1 <= td <= d and 1 <= th <= h and 1 <= tw <= min(w, 32)
    assert td * th * tw <= 64 * (8 // wm)
    assert cuda_conv.wide_x3_smem(td, th, tw, wm) <= 227 * 1024
    chunks = cdiv(ci, 8)
    parts = [range(chunks * j // p, chunks * (j + 1) // p) for j in range(p)]
    assert [c for r in parts for c in r] == list(range(chunks))
    assert max(len(r) for r in parts) * 27 * 8 <= 2048
    boxes = n * cdiv(d, td) * cdiv(h, th) * cdiv(w, tw)
    assert boxes * td * th * tw >= n * d * h * w
    assert boxes * cdiv(co, 32 * wm) * p >= SMS or p == chunks
    # K3 f32: boxes of at most DW_X3_BOX positions, tw a multiple of 4;
    # P parts of the N x boxes list, each box once; a chain of MMAs sums at
    # most 2048 positions (the box rounded up to 8, times the boxes a
    # chain takes); within 227 KB (two x and g stages, csrc dw_x3_smem);
    # about two blocks an SM (one an SM resides) where the boxes allow
    td, th, tw, p = cuda_conv.dw_x3_plan(n, ci, co, d, h, w)
    assert 1 <= td <= d and 1 <= th <= h and tw % 4 == 0
    assert tw <= max(32, cdiv(w, 4) * 4) and tw < w + 4
    kp = cdiv(td * th * tw, 8) * 8
    assert kp <= cuda_conv.DW_X3_BOX
    boxes = n * cdiv(d, td) * cdiv(h, th) * cdiv(w, tw)
    assert boxes * td * th * tw >= n * d * h * w
    assert 1 <= p <= boxes
    parts = [range(boxes * j // p, boxes * (j + 1) // p) for j in range(p)]
    assert [b for r in parts for b in r] == list(range(boxes))
    assert all(len(r) for r in parts)
    assert (cuda_conv.DW_X3_CHAIN // kp) * kp <= 2048
    assert cuda_conv.dw_x3_smem(td, th, tw) <= 227 * 1024
    tiles = cdiv(ci, 16) * cdiv(co, 32)
    assert abs(p * tiles - 2 * SMS) <= tiles // 2 or p in (1, boxes)
