"""Port layers (yolo_tensorflow_tpu_torch/ops/layers.py) vs the JAX package's
ops/layers.py on the same numpy inputs, f32, rtol 1e-5 / atol 1e-5 (the two
sum a conv's products in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_tensorflow_tpu.ops import layers as JL
from yolo_tensorflow_tpu_torch.ops import layers as TL

import torch_parity  # noqa: F401  (caps torch threads per worker)

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(x_nhwc):
    """NHWC numpy -> NCHW tensor in channels-last memory, as the port runs."""
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("hw", [(9, 9), (8, 10)])
def test_conv2d(k, stride, hw, rng):
    x = rng.standard_normal((2, *hw, 5), dtype=np.float32)
    w = rng.standard_normal((k, k, 5, 7), dtype=np.float32)
    b = rng.standard_normal(7, dtype=np.float32)
    want = JL.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     stride=stride)
    got = TL.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
                    torch.from_numpy(b), stride=stride)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["leaky", "logistic", "relu", "tanh",
                                  "linear"])
def test_activate(name, rng):
    x = rng.standard_normal((3, 17), dtype=np.float32) * 4
    np.testing.assert_allclose(
        TL.activate(torch.from_numpy(x), name).numpy(),
        np.asarray(JL.activate(jnp.asarray(x), name)), **TOL)


@pytest.mark.parametrize("fn", ["leaky_relu", "activate"])
def test_leaky_bf16_matches_jax_exactly(fn, rng):
    """bf16 leaky multiplies by alpha rounded to bf16 (0.10009765625), as
    JAX's weak-typed scalar does; alpha in f32 rounds ~10 % of the outputs
    one ulp off."""
    x = rng.standard_normal(100_000, dtype=np.float32) * 4
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    if fn == "leaky_relu":
        want, got = JL.leaky_relu(jx), TL.leaky_relu(tx)
    else:
        want, got = JL.activate(jx, "leaky"), TL.activate(tx, "leaky")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_activate_unknown_raises():
    with pytest.raises(ValueError, match="unsupported activation"):
        TL.activate(torch.zeros(2), "mish")


@pytest.mark.parametrize("size,stride", [(2, 2), (2, 1)])
@pytest.mark.parametrize("hw", [(7, 7), (8, 8), (5, 6)])
def test_max_pool(size, stride, hw, rng):
    x = rng.standard_normal((2, *hw, 3), dtype=np.float32)
    want = JL.max_pool(jnp.asarray(x), size, stride)
    got = TL.max_pool(_nchw(x), size, stride)
    assert _nhwc(got).shape == want.shape
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw", [(4, 4), (3, 5)])
def test_upsample_nearest(hw, rng):
    x = rng.standard_normal((2, *hw, 6), dtype=np.float32)
    want = JL.upsample_nearest(jnp.asarray(x))
    got = TL.upsample_nearest(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
