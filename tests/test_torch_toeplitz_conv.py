"""The port's W-Toeplitz direct conv (K5) against the JAX package's
``gan3d_tpu.ops.pallas_conv`` on the CPU.

- ``toeplitz_weights`` and ``tile_input`` equal the JAX functions bit for
  bit, 128-lane pad included;
- the op (its plain version on the CPU) against ``pallas_conv3d`` in
  Pallas interpret mode at the shapes of tests/test_pallas_conv.py:25-29
  (rtol = atol = 1e-4), and one bf16 case (2e-2 of max |ref|: both sum in
  f32 and round the output to bf16);
- dx and dW through ``ToeplitzConv3d`` against ``jax.grad`` of the JAX op
  in interpret mode at test_pallas_conv.py:44-62's shape (rtol 1e-4, atol
  1e-5);
- a tile that does not divide W, or is < 1, raises on the CPU too; the
  inputs entry raises without a card unless asked for the CPU; the kernel
  wrapper refuses CPU tensors and the CPU path launches nothing;
- the f32 kernel's tiling plan (``toeplitz_x3_plan``) at the bench's
  largest shapes and at small, thin and tall ones.

Inputs come from numpy seeds, in the JAX op's layout (NDHWC, DHWIO).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gan3d_tpu.ops import lane_conv, pallas_conv
from gan3d_tpu_torch.ops import cuda_conv
from gan3d_tpu_torch.ops import toeplitz_conv as tc

torch.set_num_threads(1)

# tests/test_pallas_conv.py:25-29
SHAPES = [((2, 4, 4, 8), 32, 32, 4), ((1, 3, 5, 8), 16, 16, 8),
          ((1, 4, 4, 8), 8, 64, 2)]


def inputs(seed, shape, cin, cout, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, cin)).astype(dtype)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)
         ).astype(dtype)
    return x, w


@pytest.mark.parametrize("t,cin,cout", [(4, 2, 2), (4, 32, 32), (8, 16, 16),
                                        (2, 8, 64), (3, 5, 7)])
def test_toeplitz_weights_and_tiles_equal_jax(t, cin, cout):
    x, w = inputs(0, (1, 3, 4, 2 * t), cin, cout)
    want_b = np.asarray(pallas_conv.toeplitz_weights(jnp.asarray(w), t))
    want_xt = np.asarray(pallas_conv.tile_input(jnp.asarray(x), t))
    got_b = tc.toeplitz_weights(torch.from_numpy(w), t).numpy()
    got_xt = tc.tile_input(torch.from_numpy(x), t).numpy()
    assert got_b.shape == want_b.shape and got_xt.shape == want_xt.shape
    assert got_b.shape[1] % 128 == 0 and got_xt.shape[-1] % 128 == 0
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_xt, want_xt)


@pytest.mark.parametrize("c,s", [(16, 64), (32, 64), (32, 32), (64, 32),
                                 (128, 16), (8, 6), (24, 12)])
def test_pick_tile_is_the_jax_rule(c, s):
    assert tc.pick_tile(c, s) == lane_conv.pick_tile(c, s)


# The JAX op (Pallas in interpret mode) under jax.jit: one compiled
# program a shape rather than eager dispatch of every grid step.
jax_conv = jax.jit(pallas_conv.pallas_conv3d, static_argnums=2)


@pytest.mark.parametrize("shape,cin,cout,t", SHAPES)
def test_op_matches_pallas_conv3d(shape, cin, cout, t):
    x, w = inputs(0, shape, cin, cout)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), t))
    cuda_conv.reset_counters()
    got = tc.toeplitz_conv3d(torch.from_numpy(x), torch.from_numpy(w), t)
    assert cuda_conv.toeplitz_launches == 0
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_op_matches_pallas_conv3d_bf16():
    x, w = inputs(2, (1, 4, 4, 8), 16, 16)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_conv(xb, wb, 8), np.float32)
    got = tc.toeplitz_conv3d(torch.from_numpy(np.asarray(xb, np.float32))
                             .bfloat16(),
                             torch.from_numpy(np.asarray(wb, np.float32))
                             .bfloat16(), 8)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= 2e-2


def test_grads_match_jax_custom_vjp():
    """dx and dW through tanh, against jax.grad of pallas_conv3d in
    interpret mode (test_pallas_conv.py:44-62's shape, t=4)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 4, 4, 8, 16)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 16, 32)) / np.sqrt(27 * 16)
         ).astype(np.float32)

    def loss(x, w):
        return jnp.sum(jnp.tanh(pallas_conv.pallas_conv3d(x, w, 4)))

    with pltpu.force_tpu_interpret_mode():
        gx_j, gw_j = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                             jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    torch.tanh(tc.toeplitz_conv3d(xt, wt, 4)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), rtol=1e-4,
                               atol=1e-5)


def test_function_is_first_order_only():
    x, w = inputs(3, (1, 2, 2, 4), 8, 8)
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(tc.toeplitz_conv3d(xt, torch.from_numpy(w), 2)
                               .pow(2).sum(), xt, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), xt)


@pytest.mark.parametrize("t", [3, 0, -2, 16])
def test_bad_tile_raises(t):
    x, w = inputs(4, (1, 2, 2, 8), 8, 8)
    with pytest.raises(ValueError, match="tile"):
        tc.toeplitz_conv3d(torch.from_numpy(x), torch.from_numpy(w), t)


def test_inputs_entry_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.make_inputs(8, 4, batch=1)
    x, w = tc.make_inputs(8, 4, batch=1, dtype=torch.bfloat16,
                          platform="cpu")
    assert x.shape == (1, 4, 4, 4, 8) and w.shape == (3, 3, 3, 8, 8)
    assert x.dtype == w.dtype == torch.bfloat16 and x.device.type == "cpu"


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w = inputs(5, (1, 2, 2, 4), 8, 8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda_conv.toeplitz_conv3d_cuda(torch.from_numpy(x),
                                       torch.from_numpy(w))


@pytest.mark.parametrize("n,d,h,w,co", [(16, 64, 64, 64, 32),
                                        (16, 16, 16, 16, 128),
                                        (1, 3, 5, 8, 16), (2, 1, 1, 33, 40),
                                        (1, 300, 2, 2, 8)])
def test_tiling_plan_covers_the_volume_and_fits_the_card(n, d, h, w, co):
    """The f32 route's plan (toeplitz_x3_plan) at Ci = Co: a block of 8
    warps within 227 KB, every position covered, the split-K parts of the
    Ci/8 chunks none longer than 2048 terms and filling the card where the
    chunks allow."""
    bh, bw, wn, p = cuda_conv.toeplitz_x3_plan(n, d, h, w, co, co)
    assert cuda_conv.toeplitz_x3_smem(bh, bw, wn) <= 227 * 1024
    assert 1 <= bh <= h and 1 <= bw <= min(w, 32)
    assert bh * bw <= 64 * (8 // wn)
    chunks = -(-co // 8)
    assert 1 <= p <= chunks and -(-chunks // p) * 27 * 8 <= 2048
    blocks = n * d * -(-h // bh) * -(-w // bw) * -(-co // (32 * wn))
    assert blocks * p >= cuda_conv.SMS or p == chunks
