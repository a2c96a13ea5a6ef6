"""Port layers (yolo_tensorflow_tpu_torch/ops/layers.py) vs the JAX package's
ops/layers.py on the same numpy inputs, f32, rtol 1e-5 / atol 1e-5 (the two
sum a conv's products in different orders). The pure moves (reorg,
space_to_depth, transpose_flatten) are held bit for bit; dense at rtol 1e-5
/ atol 1e-6 (a dot product's sum order)."""

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


# (NHWC shape, stride): C/s^2 of 1, odd (3, 5) and even; H != W; stride 3
# (C = 18, 45: not square-free, C/s^2 = 2, 5); the yolov2 passthrough's 64
REORG_CASES = [((2, 4, 4, 4), 2), ((2, 6, 8, 12), 2), ((1, 2, 6, 20), 2),
               ((2, 6, 6, 18), 3), ((1, 3, 9, 45), 3), ((1, 26, 26, 64), 2)]


@pytest.mark.parametrize("fn", ["darknet_reorg", "space_to_depth"])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape,stride", REORG_CASES)
def test_reorg_matches_jax_exactly(fn, shape, stride, channels_last, rng):
    """Pure moves: bit for bit, from either memory format, and the result
    comes back channels-last."""
    x = rng.standard_normal(shape, dtype=np.float32)
    want = np.asarray(getattr(JL, fn)(jnp.asarray(x), stride))
    t = _nchw(x) if channels_last else _nchw(x).contiguous()
    got = getattr(TL, fn)(t, stride)
    b, h, w, c = shape
    assert got.shape == (b, c * stride * stride, h // stride, w // stride)
    assert got.permute(0, 2, 3, 1).is_contiguous()
    np.testing.assert_array_equal(_nhwc(got), want)


def test_darknet_reorg_is_not_space_to_depth(rng):
    x = _nchw(rng.standard_normal((1, 4, 4, 8), dtype=np.float32))
    assert not torch.equal(TL.darknet_reorg(x), TL.space_to_depth(x))
    assert not torch.equal(
        TL.darknet_reorg(x),
        torch.nn.functional.pixel_unshuffle(x.contiguous(), 2))


@pytest.mark.parametrize("shape", [(3, 5, 4, 6), (2, 7, 7, 16), (1, 1, 1, 9)])
def test_transpose_flatten_matches_jax_exactly(shape, rng):
    x = rng.standard_normal(shape, dtype=np.float32)
    got = TL.transpose_flatten(_nchw(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JL.transpose_flatten(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_in,n_out", [(40, 7), (513, 64)])
def test_dense_matches_jax(n_in, n_out, dtype, rng):
    """(In, Out) weights; a bf16 x rounds w to bf16 and still sums and
    returns float32, as preferred_element_type does."""
    x = rng.standard_normal((3, n_in), dtype=np.float32)
    w = rng.standard_normal((n_in, n_out), dtype=np.float32) / n_in ** 0.5
    b = rng.standard_normal(n_out, dtype=np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = JL.dense(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                    jnp.asarray(b))
    got = TL.dense(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                   torch.from_numpy(b))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    act = TL.dense(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                   torch.from_numpy(b), act=TL.leaky_relu)
    np.testing.assert_array_equal(act.numpy(), TL.leaky_relu(got).numpy())


def test_exact_f32_convs_restores_the_matmul_flag():
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with TL.exact_f32_convs():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        with TL.exact_f32_convs(False):
            assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
