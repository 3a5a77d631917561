"""The port's pooled-attention op against the JAX package's.

The port's plain version (gan3d_tpu_torch.ops.attention.attention_plain)
is held against the JAX einsum reference and against the Pallas kernel run
in interpret mode, forward and gradients; the dispatcher must send CPU
tensors to the plain version without touching the CUDA kernels. The CUDA
kernels themselves run only on the card (chip_smoke.py holds them against
the plain version there). All in f32; inputs drawn with numpy from a seed.
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
    assert cuda_attention.bwd_launches == 0


@pytest.mark.parametrize("case", ["c12", "float16", "mixed", "cpu", "shape"])
def test_kernel_wrapper_rejects(case):
    """The kernel wrapper raises on what the kernels do not take; it never
    hands a tensor to the plain version."""
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
    with pytest.raises(ValueError):
        cuda_attention.attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        cuda_attention.pooled_attention_cuda(q, k, v)
    assert cuda_attention.fwd_launches == 0
