"""The port's pooled-attention op against the JAX package's.

The port's plain version (gan3d_tpu_torch.ops.attention.attention_plain)
is held against the JAX einsum reference and against the Pallas kernel run
in interpret mode, forward and gradients; the dispatcher must send CPU
tensors to the plain version without touching the CUDA kernels. The CUDA
kernels themselves run only on the card (chip_smoke.py holds them against
the plain version there); here blocked emulations of the bf16 forward's
arithmetic (64-key tiles, online softmax, p rounded to bf16 before PV) and
of the bf16 backward's (its rounding points, tiles and split-L partials)
are held against the Pallas forward and backward. Inputs drawn with numpy
from a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gan3d_tpu.ops.attention import attention_einsum
from gan3d_tpu.ops.pallas_attention import pallas_pooled_attention
from gan3d_tpu_torch.ops import cuda_attention
from gan3d_tpu_torch.ops.attention import attention_plain, pooled_attention

torch.set_num_threads(1)


def _qkv(seed, n=2, L=512, m=64, c=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((n, L, c), (n, m, c), (n, m, c))]


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("L,m,c,chunk", [(512, 64, 16, 1024),
                                         (2048, 256, 8, 512),
                                         (1000, 125, 32, 256)])
def test_plain_matches_einsum(L, m, c, chunk):
    """f32, atol 1e-5 / rtol 1e-4: same math, different summation order.
    The last case has ragged L and M and a ragged final chunk."""
    arrs = _qkv(0, L=L, m=m, c=c)
    ref = np.asarray(attention_einsum(*map(jnp.asarray, arrs)))
    out = attention_plain(*_t(arrs), chunk=chunk).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


def test_plain_matches_pallas_interpret():
    """The Pallas kernel (interpret mode) at N=2, L=512, M=64, c=16;
    atol 1e-5 / rtol 1e-4."""
    arrs = _qkv(1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_pooled_attention(*map(jnp.asarray, arrs)))
    out = attention_plain(*_t(arrs)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("c", [16, 32])
def test_grads_match_pallas_interpret(c):
    """d/d(q,k,v) of sum(o^2): jax.grad through the Pallas backward kernel
    (interpret mode) vs torch autograd of the plain version; atol 1e-4 /
    rtol 1e-3, the JAX package's own tolerance for this comparison
    (tests/test_attention_ops.py)."""
    arrs = _qkv(2, c=c)

    def loss(q, k, v):
        return jnp.sum(pallas_pooled_attention(q, k, v) ** 2)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    leaves = [t.requires_grad_(True) for t in _t(arrs)]
    (attention_plain(*leaves) ** 2).sum().backward()
    for got, want, name in zip(leaves, ref, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_dispatcher_sends_cpu_tensors_to_plain():
    """On CPU tensors the dispatcher is the plain version, forward and
    backward, and launches no kernel (exact equality)."""
    cuda_attention.reset_counters()
    arrs = _qkv(3, L=256, m=32)
    a = [t.requires_grad_(True) for t in _t(arrs)]
    b = [t.requires_grad_(True) for t in _t(arrs)]
    out = pooled_attention(*a)
    ref = attention_plain(*b)
    assert torch.equal(out, ref)
    out.sum().backward()
    ref.sum().backward()
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)
    assert cuda_attention.fwd_launches == 0
    assert cuda_attention.fwd_tc_launches == 0
    assert cuda_attention.bwd_launches == 0
    assert cuda_attention.bwd_tc_launches == 0


@pytest.mark.parametrize("case", ["c12", "float16", "mixed", "cpu", "shape",
                                  "bf16_cpu"])
def test_kernel_wrapper_rejects(case):
    """The kernel wrapper raises on what the kernels do not take; it never
    hands a tensor to the plain version, and a refusal counts no launch on
    either route (bf16_cpu: bf16 tensors on the CPU, the tensor-core
    route's dtype); reset_counters zeroes every counter."""
    cuda_attention.reset_counters()
    q, k, v = _t(_qkv(4, L=64, m=8))
    if case == "c12":
        q, k, v = (torch.zeros(2, 64, 12), torch.zeros(2, 8, 12),
                   torch.zeros(2, 8, 12))
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed":
        q = q.bfloat16()
    elif case == "shape":
        k = k[:1]
    elif case == "bf16_cpu":
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError):
        cuda_attention.attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        cuda_attention.pooled_attention_cuda(q, k, v)
    assert cuda_attention.fwd_launches == 0
    assert cuda_attention.fwd_tc_launches == 0
    if case == "bf16_cpu":
        names = ("fwd_launches", "fwd_tc_launches", "bwd_launches",
                 "bwd_tc_launches")
        for name in names:
            setattr(cuda_attention, name, 3)
        cuda_attention.reset_counters()
        assert all(getattr(cuda_attention, name) == 0 for name in names)


LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def emulate_fwd_tc(q, k, v, tile=64):
    """The arithmetic of the bf16 tensor-core forward
    (csrc/pooled_attention.cu, fwd_tc_kernel) in plain PyTorch: q, k, v are
    bf16; the scores are f32 sums of bf16 products, scaled to log2 units;
    per 64-key tile (the last one ragged: its missing keys are the kernel's
    -inf scores) the running row max and the rescale 2^(m_old - m_new); p =
    2^(s - m) in f32, added to the row sum in f32 and rounded to bf16 for
    the PV product; o = acc / den rounded to bf16 once, and lse = (m +
    log2 den) ln2 in f32. Returns (o, lse)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    n, L, c = q.shape
    mx = torch.full((n, L, 1), -float("inf"))
    den = torch.zeros((n, L, 1))
    acc = torch.zeros((n, L, c))
    for j in range(0, k.shape[1], tile):
        s = (qf @ kf[:, j:j + tile].transpose(1, 2)) * LOG2E
        mnew = torch.maximum(mx, s.amax(-1, keepdim=True))
        scale = torch.exp2(mx - mnew)
        p = torch.exp2(s - mnew)
        den = den * scale + p.sum(-1, keepdim=True)
        acc = acc * scale + p.bfloat16().float() @ vf[:, j:j + tile]
        mx = mnew
    return (acc / den).bfloat16(), ((mx + torch.log2(den)) * LN2)[..., 0]


@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_bf16_forward_emulation_matches_pallas_interpret(c):
    """The bf16 forward's arithmetic (emulate_fwd_tc) against the Pallas
    forward (interpret mode) at N=2, L=512, M=72 (a second, masked key
    tile of 8), on the same bf16-valued inputs given as bf16 and as f32:
    o within 2e-2 of the largest |o| (the card's bf16 tolerance) of both,
    the bf16 run having the TPU kernel's rounding point for p (cast to v's
    dtype before PV), the f32 run none; lse within 1e-3 of the largest
    |lse| of the f32 logsumexp of the scores."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(7, m=72, c=c))
    o, lse = emulate_fwd_tc(q, k, v)
    ref = torch.logsumexp(q.float() @ k.float().transpose(1, 2), -1)
    assert (lse - ref).abs().max() / ref.abs().max() <= 1e-3
    for dt in (jnp.float32, jnp.bfloat16):
        jq, jk, jv = (jnp.asarray(t.float().numpy(), dt) for t in (q, k, v))
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(pallas_pooled_attention(jq, jk, jv).astype(
                jnp.float32))
        err = np.abs(o.float().numpy() - want).max() / np.abs(want).max()
        assert err <= 2e-2, (str(dt), err)


def emulate_bwd_tc(q, k, v, o, lse, do, parts, tile=64):
    """The arithmetic of the bf16 tensor-core backward
    (csrc/pooled_attention.cu, bwd_dq_tc_kernel / bwd_dkdv_tc_kernel) in
    plain PyTorch: q, k, v, o, dO are bf16; every product multiplies bf16
    operands into f32 sums; P and dS are rounded to bf16 before the dQ, dK
    and dV products; delta = sum(dO * o) from the bf16 o; dQ runs over
    64-key tiles; dK/dV over 64-query tiles split into ``parts`` contiguous
    parts (``dkdv_split``), whose f32 partials are summed in order; every
    output is rounded to bf16 once."""
    f = [t.float() for t in (q, k, v, do)]
    qf, kf, vf, df = f
    n, L, c = q.shape
    m = k.shape[1]
    delta = (df * o.float()).sum(-1, keepdim=True)            # [N, L, 1]
    lse = lse[..., None]

    def bf(t):
        return t.bfloat16().float()

    dq = torch.zeros((n, L, c))
    for j in range(0, m, tile):
        kj, vj = kf[:, j:j + tile], vf[:, j:j + tile]
        p = torch.exp(qf @ kj.transpose(1, 2) - lse)
        ds = p * (df @ vj.transpose(1, 2) - delta)
        dq += bf(ds) @ kj
    tiles = -(-L // tile)
    dk_parts, dv_parts = [], []
    for part in range(parts):
        dk, dv = torch.zeros((n, m, c)), torch.zeros((n, m, c))
        for t in range(tiles * part // parts, tiles * (part + 1) // parts):
            i = slice(t * tile, (t + 1) * tile)
            pt = torch.exp(kf @ qf[:, i].transpose(1, 2)
                           - lse[:, i].transpose(1, 2))       # P^T [N, M, T]
            dst = pt * (vf @ df[:, i].transpose(1, 2)
                        - delta[:, i].transpose(1, 2))
            dv += bf(pt) @ df[:, i]
            dk += bf(dst) @ qf[:, i]
        dk_parts.append(dk)
        dv_parts.append(dv)
    dk, dv = dk_parts[0], dv_parts[0]
    for a, b in zip(dk_parts[1:], dv_parts[1:]):
        dk, dv = dk + a, dv + b
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_bf16_backward_emulation_matches_pallas_interpret(c):
    """The bf16 backward's arithmetic (emulate_bwd_tc, with split-L
    partials: dkdv_split gives 8 parts here) against jax.vjp through the
    Pallas backward (interpret mode) at N=2, L=512, M=64, on the same
    bf16-valued inputs: within 2e-2 of the largest |gradient|, the card's
    bf16 tolerance, both against the f32 Pallas run (the exact gradient:
    what the rounding points cost) and against the bf16 one (the TPU
    kernel's own rounding points, which these mirror)."""
    arrs = [a.astype(np.float32) for a in _qkv(5, c=c)]
    arrs.append(np.random.default_rng(6).normal(size=arrs[0].shape).astype(
        np.float32))
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrs)
    s = q.float() @ k.float().transpose(1, 2)
    lse = torch.logsumexp(s, -1)
    o = (torch.softmax(s, -1) @ v.float()).bfloat16()
    parts = cuda_attention.dkdv_split(2, 512, 64)
    assert parts == 8
    got = emulate_bwd_tc(q, k, v, o, lse, do, parts)
    for dt in (jnp.float32, jnp.bfloat16):
        jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), dt)
                           for t in (q, k, v, do))
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(pallas_pooled_attention, jq, jk, jv)
            want = vjp(jdo)
        for g, w, name in zip(got, want, "qkv"):
            w = np.asarray(w.astype(jnp.float32))
            err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
            assert err <= 2e-2, (str(dt), name, err)


@pytest.mark.parametrize("n,L,m,want", [(16, 32768, 4096, 1),
                                        (16, 4096, 512, 3),
                                        (2, 1000, 125, 16), (1, 4133, 517, 30),
                                        (2, 512, 64, 8), (16, 512, 64, 8)])
def test_dkdv_split_covers_the_card(n, L, m, want):
    """The bf16 dk/dv pass's parts: none at the G placement (1024 key
    blocks), 3 at the D placement (128 blocks -> 384; also the DCGAN G's
    L and M), 8 at the DCGAN D's (16 blocks, one 64-query tile a part:
    128 blocks); at most one part
    per 64-query tile, and a grid of at least 2 x 132 blocks where L
    allows it."""
    parts = cuda_attention.dkdv_split(n, L, m)
    assert parts == want
    tiles = -(-L // 64)
    assert 1 <= parts <= tiles
    assert n * -(-m // 64) * parts >= 2 * cuda_attention.SMS or parts == tiles
