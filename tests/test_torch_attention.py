"""The port's pooled-attention op against the JAX package's.

The port's plain version (gan3d_tpu_torch.ops.attention.attention_plain)
is held against the JAX einsum reference and against the Pallas kernel run
in interpret mode, forward and gradients; the dispatcher must send CPU
tensors to the plain version without touching the CUDA kernels. The CUDA
kernels themselves run only on the card (chip_smoke.py holds them against
the plain version there); here blocked emulations of the bf16 forward's
arithmetic (64-key tiles, online softmax, p rounded to bf16 before PV) and
of the bf16 backward's (its rounding points, tiles and split-L partials)
are held against the Pallas forward and backward, and so are those of the
f32 route's 3xTF32 kernels (each operand split into two TF32 halves,
three products a term, f32 sums). Inputs drawn with numpy from a seed.
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


# The Pallas kernel (called in interpret mode), forward and vjp, compiled
# once per shape and dtype: the tests at one shape share the compile.
@jax.jit
def pallas_fwd(q, k, v):
    return pallas_pooled_attention(q, k, v)


@jax.jit
def pallas_vjp(q, k, v, do):
    return jax.vjp(pallas_pooled_attention, q, k, v)[1](do)


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
        ref = np.asarray(pallas_fwd(*map(jnp.asarray, arrs)))
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
            want = np.asarray(pallas_fwd(jq, jk, jv).astype(jnp.float32))
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
            want = pallas_vjp(jq, jk, jv, jdo)
        for g, w, name in zip(got, want, "qkv"):
            w = np.asarray(w.astype(jnp.float32))
            err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
            assert err <= 2e-2, (str(dt), name, err)


@pytest.mark.parametrize("n,L,m,c,f32,want", [
    *(pytest.param(n, L, m, 64, False, want, id=f"{n}-{L}-{m}-{want}")
      for n, L, m, want in ((16, 32768, 4096, 1), (16, 4096, 512, 3),
                            (2, 1000, 125, 16), (1, 4133, 517, 30),
                            (2, 512, 64, 8), (16, 512, 64, 8))),
    *(pytest.param(n, L, m, c, True, want, id=f"f32-{n}-{L}-{m}-{c}-{want}")
      for n, L, m, c, want in ((16, 32768, 4096, 16, 16),
                               (16, 4096, 512, 32, 3),
                               (16, 32768, 4096, 64, 16),
                               (16, 4096, 512, 128, 5),
                               (16, 8192, 4096, 64, 4),
                               (16, 1024, 512, 128, 5),
                               (2, 512, 64, 128, 16),
                               (1, 4133, 517, 128, 53)))])
def test_dkdv_split_covers_the_card(n, L, m, c, f32, want):
    """The dk/dv pass's parts. bf16 (64 key rows over 64-query tiles):
    none at the G placement (1024 key blocks), 3 at the D placement (128
    blocks -> 384; also the DCGAN G's L and M), 8 at the DCGAN D's (16
    blocks, one 64-query tile a part: 128 blocks). f32 (the chip_smoke.py
    PLACEMENTS and R256_PLACEMENTS, and test shapes): its own blocks
    (64 rows over 64-query tiles, but 128 rows over 32-query tiles, all
    columns in one block, at c = 128: 3 parts at the flagship's D, 5 at
    the 128^3 and 256^3 D, 16 x 4 key blocks = 64 -> 320), and no part
    sums more than F32_PART_QUERIES queries in the tensor cores (16 parts
    over the 32768 of the flagship's and the 128^3 G, 4 over the 256^3
    G's 8192). Either route: at most one part per tile, and a grid of at
    least 2 x 132 blocks where L allows it."""
    parts = cuda_attention.dkdv_split(n, L, m, c, f32=f32)
    assert parts == want
    rows, tile, halves = cuda_attention.dkdv_blocks(c, f32=f32)
    assert (rows, tile, halves) == (
        (128, 32, 1) if f32 and c > 64 else (64, 64, 1))
    tiles = -(-L // tile)
    assert 1 <= parts <= tiles
    assert (n * -(-m // rows) * halves * parts >= 2 * cuda_attention.SMS
            or parts == tiles)
    if f32:
        assert -(-tiles // parts) * tile <= cuda_attention.F32_PART_QUERIES


def tf32_rna(x):
    """x rounded to TF32 as the f32 route's kernels round it
    (csrc/mma_tf32.cuh tf32_rna, cvt.rna.tf32.f32): to nearest, ties away
    from zero, 10 stored mantissa bits, the 13 low bits zero; on the bit
    pattern, adding half a TF32 ulp to the magnitude and truncating."""
    u = np.ascontiguousarray(x.numpy(), np.float32).view(np.uint32)
    return torch.from_numpy(
        ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32))


def split_tf32(x):
    """(hi, lo) = (rna(x), rna(x - hi)): csrc/mma_tf32.cuh split_tf32."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_tf32x3(a, b):
    """a @ b in 3xTF32 (csrc/mma_tf32.cuh mma3): a_lo b_hi + a_hi b_lo +
    a_hi b_hi, every product of TF32 operands and every sum f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def test_tf32_split_keeps_21_bits():
    """The 3xTF32 split: hi and lo each keep at most 10 stored mantissa
    bits (their 13 low bits zero), hi + lo is within 2^-21 of x, and a tie
    rounds away from zero, at random values over 60 binades and at the
    ties and carries of 1.0."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=20000) * 10.0 ** rng.uniform(-30, 30, 20000))
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                     2 - 2 ** -12, 1 + 2 ** -11 + 2 ** -23])
    x = torch.from_numpy(np.concatenate([x, ties]).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & 0x1fff).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    want = [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 * 2 ** -10, 2.0,
            1 + 2 ** -10]
    assert hi[-5:].tolist() == want


def emulate_fwd_tf32x3(q, k, v, tile=64):
    """The arithmetic of the f32 forward (csrc/pooled_attention.cu,
    fwd_tf32x3_kernel) in plain PyTorch: S = Q K^T and O += P V in
    3xTF32, f32 sums; scores scaled to log2 units; per 64-key tile (the
    last one ragged: its missing keys are the kernel's -inf scores) the
    running row max and the rescale 2^(m_old - m_new); p = 2^(s - m) in
    f32, added to the row sum in f32 and split for PV; o = acc / den, lse
    = (m + log2 den) ln2. Rows are independent, so the kernel's 64-query
    blocks need no loop here. Returns (o, lse)."""
    n, L, c = q.shape
    mx = torch.full((n, L, 1), -float("inf"))
    den = torch.zeros((n, L, 1))
    acc = torch.zeros((n, L, c))
    for j in range(0, k.shape[1], tile):
        s = mm_tf32x3(q, k[:, j:j + tile].transpose(1, 2)) * LOG2E
        mnew = torch.maximum(mx, s.amax(-1, keepdim=True))
        scale = torch.exp2(mx - mnew)
        p = torch.exp2(s - mnew)
        den = den * scale + p.sum(-1, keepdim=True)
        acc = acc * scale + mm_tf32x3(p, v[:, j:j + tile])
        mx = mnew
    return acc / den, ((mx + torch.log2(den)) * LN2)[..., 0]


def emulate_bwd_tf32x3(q, k, v, o, lse, do, parts, tile=64):
    """The arithmetic of the f32 backward (csrc/pooled_attention.cu,
    bwd_dq_tf32x3_kernel / bwd_dkdv_tf32x3_kernel) in plain PyTorch: every
    product in 3xTF32 (mm_tf32x3) with f32 sums; delta = sum(dO * o) from
    the f32 o; dQ over ``tile``-key tiles; dK/dV over ``tile``-query tiles
    (64, or 32 at c = 128: ``dkdv_blocks``) split into ``parts``
    contiguous parts (``dkdv_split``), whose f32 partials are summed in
    order."""
    n, L, c = q.shape
    m = k.shape[1]
    delta = (do * o).sum(-1, keepdim=True)                    # [N, L, 1]
    lse = lse[..., None]
    dq = torch.zeros((n, L, c))
    for j in range(0, m, tile):
        kj, vj = k[:, j:j + tile], v[:, j:j + tile]
        p = torch.exp(mm_tf32x3(q, kj.transpose(1, 2)) - lse)
        ds = p * (mm_tf32x3(do, vj.transpose(1, 2)) - delta)
        dq += mm_tf32x3(ds, kj)
    tiles = -(-L // tile)
    dk, dv = [], []
    for part in range(parts):
        dkp, dvp = torch.zeros((n, m, c)), torch.zeros((n, m, c))
        for t in range(tiles * part // parts, tiles * (part + 1) // parts):
            i = slice(t * tile, (t + 1) * tile)
            pt = torch.exp(mm_tf32x3(k, q[:, i].transpose(1, 2))
                           - lse[:, i].transpose(1, 2))       # P^T [N, M, T]
            dst = pt * (mm_tf32x3(v, do[:, i].transpose(1, 2))
                        - delta[:, i].transpose(1, 2))
            dvp += mm_tf32x3(pt, do[:, i])
            dkp += mm_tf32x3(dst, q[:, i])
        dk.append(dkp)
        dv.append(dvp)
    for a, b in zip(dk[1:], dv[1:]):
        dk[0], dv[0] = dk[0] + a, dv[0] + b
    return dq, dk[0], dv[0]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("c", [8, 16, 32, 64, 128])
def test_tf32x3_forward_emulation_matches_pallas_interpret(c):
    """The f32 forward's arithmetic (emulate_fwd_tf32x3) against the Pallas
    forward (interpret mode, f32) at N=2, L=512, M=72 (a second, masked
    key tile of 8): o within 1e-4 of the largest |o|, the card's f32
    tolerance (chip_smoke.py TOL); lse within 1e-4 of the largest |lse|
    of the f32 logsumexp of the scores."""
    arrs = _qkv(8, m=72, c=c)
    q, k, v = _t(arrs)
    o, lse = emulate_fwd_tf32x3(q, k, v)
    ref = torch.logsumexp(q @ k.transpose(1, 2), -1)
    assert (lse - ref).abs().max() / ref.abs().max() <= 1e-4
    with pltpu.force_tpu_interpret_mode():
        want = pallas_fwd(*map(jnp.asarray, arrs))
    assert _rel(o, want) <= 1e-4


@pytest.mark.parametrize("c", [8, 16, 32, 64, 128])
def test_tf32x3_backward_emulation_matches_pallas_interpret(c):
    """The f32 backward's arithmetic (emulate_bwd_tf32x3, with split-L
    partials: dkdv_split gives one part a tile here, 8 of 64 queries, or 16
    of 32 at c = 128) against jax.vjp through the
    Pallas backward (interpret mode, f32) at N=2, L=512, M=64: each
    gradient within 1e-4 of its largest value, the card's f32 tolerance."""
    arrs = _qkv(9, c=c)
    arrs.append(np.random.default_rng(10).normal(
        size=arrs[0].shape).astype(np.float32))
    q, k, v, do = _t(arrs)
    s = q @ k.transpose(1, 2)
    lse = torch.logsumexp(s, -1)
    o = torch.softmax(s, -1) @ v
    parts = cuda_attention.dkdv_split(2, 512, 64, c, f32=True)
    _, tile, _ = cuda_attention.dkdv_blocks(c, f32=True)
    assert parts == 512 // tile
    got = emulate_bwd_tf32x3(q, k, v, o, lse, do, parts, tile)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_vjp(*map(jnp.asarray, arrs))
    for g, w, name in zip(got, want, "qkv"):
        assert _rel(g, w) <= 1e-4, name
