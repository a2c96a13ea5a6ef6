"""Port rolling-average smoothing (pipeline.make_forward_smoothed,
Detector.detect_batch_smoothed) vs the JAX package, on the CPU.

- ``sliding_mean`` equals, bit for bit, the JAX package's sliding mean as
  its jitted CPU program computes it: the frames summed left to right, the
  ``/ N`` compiled into a multiply by f32(1 / N).
- ``detect_batch_smoothed`` over 6 frames fed as 3 batches of 2, the state
  carried, for the v3, v2 and v1 narrow specs: each call's Detections
  against the JAX Detector's (num, classes and valid equal, boxes and
  scores at rtol 1e-4 / atol 1e-5: float32 conv sums in another order), and
  the final state's tails within the same tolerance.
- The port alone: batches of 2 equal frames one at a time, and once the
  window is full, identical frames give the unsmoothed ``detect_batch``
  (as tests/test_smoothing.py holds the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tensorflow_tpu.pipeline import Detector as JaxDetector
from yolo_tensorflow_tpu.pipeline import smooth_state_shapes as jax_shapes
from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
from yolo_tensorflow_tpu_torch.pipeline import (Detector, sliding_mean,
                                                smooth_state_shapes)

from torch_parity import folded_params, images, jax_model, model

SIZE = 64
OPTS = dict(conf_threshold=0.1, num_candidates=64, max_detections=10)
PARITY = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_sliding_mean_matches_jax(n, rng):
    batch = 3
    frames = rng.standard_normal((n - 1 + batch, 4, 5, 6), dtype=np.float32)
    want = jax.jit(lambda f: sum(f[k:k + batch] for k in range(n)) / n)(
        jnp.asarray(frames))
    got = sliding_mean(torch.from_numpy(frames), batch, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _detectors(name):
    cfg, specs = model(name, SIZE)
    jcfg, jspecs = jax_model(name, SIZE)
    port, jparams = folded_params(specs, SIZE)
    return (Detector(cfg, params=port, specs=specs, device="cpu", **OPTS),
            JaxDetector(jcfg, params=jparams, specs=jspecs, **OPTS))


@pytest.mark.parametrize("name", ["narrow", "narrow-v2", "narrow-v1"])
def test_state_shapes_match_jax(name):
    cfg, specs = model(name, SIZE)
    jcfg, jspecs = jax_model(name, SIZE)
    got = smooth_state_shapes(cfg, specs, 2, 3)
    want = jax_shapes(jcfg, jspecs, 2, 3)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert all(t.dtype == torch.float32 and not t.any() for t in got)


@pytest.mark.parametrize("name", ["narrow", "narrow-v2", "narrow-v1"])
def test_detect_batch_smoothed_matches_jax(name):
    det, jdet = _detectors(name)
    frames = images(6, SIZE, seed=4)
    state = jstate = None
    before = NK.launches
    for j in range(0, 6, 2):
        got, state = det.detect_batch_smoothed(frames[j:j + 2], state,
                                               avg_frames=3)
        want, jstate = jdet.detect_batch_smoothed(frames[j:j + 2], jstate,
                                                  avg_frames=3)
        # the first frames average with zero tails and may detect nothing
        assert j == 0 or (got.num > 0).all(), j
        for field in ("num", "classes", "valid"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=f"{field} frames {j}")
        for field in ("boxes", "scores"):
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(getattr(want, field)),
                                       **PARITY, err_msg=f"{field} {j}")
    assert NK.launches == before
    assert len(state) == len(jstate)
    for t, w in zip(state, jstate):
        assert t.shape == w.shape and t.device.type == "cpu"
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **PARITY)


def test_batched_equals_frame_by_frame():
    det, _ = _detectors("narrow")
    frames = images(4, SIZE, seed=5)
    state, one = None, []
    for j in range(4):
        d, state = det.detect_batch_smoothed(frames[j:j + 1], state)
        one.append(d)
    state, two = None, []
    for j in (0, 2):
        d, state = det.detect_batch_smoothed(frames[j:j + 2], state)
        two += [type(d)(*(f[b:b + 1] for f in d)) for b in range(2)]
    for a, b in zip(one, two):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_steady_state_equals_unsmoothed():
    """With identical frames and the window full, the mean of N equal
    activations is that activation (exactly, for N = 2: x + x is exact,
    and so is the multiply by 1/2), so the Detections are detect_batch's."""
    det, _ = _detectors("narrow")
    batch = np.stack([images(1, SIZE, seed=6)[0]] * 3)
    plain = det.detect_batch(batch)
    smoothed, _ = det.detect_batch_smoothed(batch, avg_frames=2)
    for b in (1, 2):
        n = int(smoothed.num[b])
        assert n == int(plain.num[b]) > 0
        np.testing.assert_allclose(smoothed.boxes[b, :n], plain.boxes[b, :n],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(smoothed.scores[b, :n],
                                   plain.scores[b, :n], rtol=1e-5)
    # the first frame averages with a zero tail: attenuated objectness
    assert int(smoothed.num[0]) <= int(plain.num[0])


def test_avg_frames_must_be_two_or_more():
    det, _ = _detectors("narrow")
    with pytest.raises(ValueError, match="avg_frames"):
        det.detect_batch_smoothed(images(1, SIZE), avg_frames=1)
