"""One fused train step of the port with the k3 conv routes on, against
the JAX package's step with them off.

The port runs ``train_step`` on the CPU in f32 with ``wide_conv`` and
``fast_dw`` on (the wide-N conv's plain version for the forward and dx,
the dW plain version for dW) and with ``fast_dw`` alone; the JAX step
(``build_train_step``) runs with both off, which computes the same
function. Both start from the same weights and see the same reals and
noise; the comparisons and tolerances are those of test_torch_step.py.

The JAX step does not run its Pallas kernels here: the JAX package's
tests/test_wide_conv.py::test_full_train_step_parity holds its knobs-on
step equal to its knobs-off step, and test_torch_conv.py holds the port's
routes against the Pallas kernels in interpret mode.

Config: resolution 8, filters 32 (so the bottleneck's hidden width, 8
and more, clears Ci >= 8), batch 2, iterD 1, biggan, hinge, f32: the
config of tests/test_wide_conv.py::test_full_train_step_parity cut from
16^3 to 8^3, which keeps eligible convs in both networks (four in G at
4^3 and 8^3, four in D at 8^3 and 4^3) and halves the JAX step's trace
and compile.
"""

import functools

import pytest
import torch

from gan3d_tpu_torch.config import Config
from gan3d_tpu_torch.ops import conv3d as tconv
from gan3d_tpu_torch.ops import cuda_conv

from test_torch_layers import jax_reference_lowering  # noqa: F401,E402
from test_torch_step import jax_step, port_step_matches

torch.set_num_threads(1)

CFG = dict(resolution=8, filterG=32, filterD=32, z_size=16, batch_size=2,
           iterD=1, biggan=True, hinge=True, compute_dtype="float32")


@functools.lru_cache(maxsize=1)
def reference():
    return jax_step(CFG, seed=3)


@pytest.mark.parametrize("wide,fast_dw,route", [
    ("on", "on", "WideConv3d"), ("off", "on", "Conv3dK3Dw")])
def test_step_with_conv_routes_matches_jax(wide, fast_dw, route,
                                           monkeypatch):
    seen = []
    for name in ("WideConv3d", "Conv3dK3Dw"):
        fn = getattr(cuda_conv, name)
        monkeypatch.setattr(fn, "apply", functools.partial(
            lambda apply, name, *a: seen.append(name) or apply(*a),
            fn.apply, name))
    ref = reference()
    try:
        tconv.set_wide_conv_mode(wide)
        tconv.set_fast_dw_mode(fast_dw)
        port_step_matches(Config(**CFG, wide_conv=wide, fast_dw=fast_dw), ref)
    finally:
        tconv.set_wide_conv_mode("auto")
        tconv.set_fast_dw_mode("auto")
    assert seen and set(seen) == {route}
