"""Port letterbox (yolo_tensorflow_tpu_torch/ops/preprocess.py) vs the JAX
package's ops/preprocess.py on the same seeded canvases: the geometry's
integer divisions exactly; the f32 letterbox bit for bit on the CPU (held
to atol 3e-5, the bound tests/test_preprocess.py holds the JAX one to
against the C, so that a different float association would still pass),
with each edge rule, an image that fills its canvas, and both
normalizations; the bf16 serving form within 2/255 of the f32 one and bit
for bit with JAX's bf16; and the box un-mapping."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_tensorflow_tpu.ops import preprocess as JP
from yolo_tensorflow_tpu_torch.ops import preprocess as TP

import torch_parity  # noqa: F401  (caps torch threads per worker)

S = 64
# (h, w) in a 128 canvas: wide, tall, square, odd pads, one pixel wide or
# high, and images that fill the canvas in one or both directions
SIZES = [(40, 100), (100, 40), (64, 64), (37, 91), (91, 37), (1, 57),
         (57, 1), (1, 1), (128, 128), (128, 75), (75, 128), (9, 128)]
# rescale, offset: 'unit' at input_scale 255 and 225, v1's 'symmetric'
NORMS = [(1.0, 0.0), (255.0 / 225.0, 0.0), (2.0, -1.0)]


def _canvases(rng, sizes, side=128):
    canvas = rng.integers(0, 256, (len(sizes), side, side, 3),
                          dtype=np.uint8)        # garbage past each image
    return canvas, np.asarray(sizes, np.int32)


def _jax(canvas, sizes, **kw):
    fn = jax.jit(lambda c, s: JP.letterbox_device_batch(c, s, S, **kw))
    return np.asarray(fn(canvas, sizes))


def _port(canvas, sizes, **kw):
    out = TP.letterbox_device_batch(torch.from_numpy(canvas),
                                    torch.from_numpy(sizes), S, **kw)
    assert out.shape == (len(sizes), 3, S, S)
    assert out.is_contiguous(memory_format=torch.channels_last)
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("h,w,size", [
    (200, 300, 416), (300, 200, 416), (417, 416, 416), (416, 416, 416),
    (1, 5, 32), (5, 1, 32), (1, 1, 32), (97, 211, 64), (211, 97, 64),
    (480, 640, 416), (720, 1280, 608)])
def test_letterbox_geometry_matches_jax(h, w, size):
    want = [int(v) for v in JP.letterbox_geometry(jnp.int32(w), jnp.int32(h),
                                                  size)]
    got = [int(v) for v in TP.letterbox_geometry(w, h, size)]
    assert got == want
    batched = TP.letterbox_geometry(torch.tensor([w, h], dtype=torch.int32),
                                    torch.tensor([h, w], dtype=torch.int32),
                                    size)
    assert [int(v[0]) for v in batched] == want


@pytest.mark.parametrize("rescale,offset", NORMS)
def test_letterbox_f32_matches_jax(rescale, offset, rng):
    canvas, sizes = _canvases(rng, SIZES)
    want = _jax(canvas, sizes, rescale=rescale, offset=offset)
    got = _port(canvas, sizes, rescale=rescale, offset=offset)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"f32 letterbox, rescale {rescale} offset {offset}: max |port - "
          f"JAX| {err:.3g}, {int((got != want).sum())} values differ")
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    # the pad is exactly 0.5 * rescale + offset
    pad = np.float32(np.float32(0.5 * rescale) + np.float32(offset))
    assert got[0, 0, 0, 0] == pad             # (40, 100): top rows are pad


def test_letterbox_single_image_is_the_batched_one(rng):
    canvas, sizes = _canvases(rng, SIZES[:3])
    batched = TP.letterbox_device_batch(torch.from_numpy(canvas),
                                        torch.from_numpy(sizes), S)
    for i, (h, w) in enumerate(sizes):
        one = TP.letterbox_device(torch.from_numpy(canvas[i]), int(h),
                                  int(w), S)
        assert torch.equal(one, batched[i])


@pytest.mark.parametrize("rescale,offset", NORMS)
def test_letterbox_bf16_matches_jax_and_f32(rescale, offset, rng):
    canvas, sizes = _canvases(rng, SIZES)
    kw = dict(rescale=rescale, offset=offset)
    exact = _port(canvas, sizes, **kw)
    got = _port(canvas, sizes, compute_dtype=torch.bfloat16, **kw)
    want = _jax(canvas, sizes, compute_dtype=jnp.bfloat16, **kw)
    err = np.abs(got - want).max()
    print(f"bf16 letterbox, rescale {rescale}: max |port - JAX| {err:.3g}, "
          f"max |bf16 - f32| {np.abs(got - exact).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    assert np.abs(got - exact).max() < 2.0 * rescale / 255.0


def test_unmap_boxes_matches_jax(rng):
    sizes = np.asarray([(40, 100), (100, 40), (64, 64), (37, 91), (1, 1)],
                       np.int32)
    boxes = rng.uniform(-0.1, 1.1, (len(sizes), 10, 4)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda b, s: JP.unmap_boxes_device(
        b, s[0], s[1], S))(boxes, sizes))
    got = TP.unmap_boxes_device(torch.from_numpy(boxes),
                                torch.from_numpy(sizes[:, 0]),
                                torch.from_numpy(sizes[:, 1]), S).numpy()
    np.testing.assert_array_equal(got, want)
    one = TP.unmap_boxes_device(torch.from_numpy(boxes[3]), 37, 91, S)
    np.testing.assert_array_equal(one.numpy(), want[3])
