"""Port NMS (post/nms.py) vs the JAX package's batched_nms_scored on random,
heavily overlapping boxes: num, classes and valid equal, boxes and scores
exact (NMS only selects; it computes no output values)."""

import numpy as np
import pytest
import torch

import jax

from yolo_tensorflow_tpu.post import nms as JN
from yolo_tensorflow_tpu_torch.post import nms as TN

import torch_parity  # noqa: F401  (caps torch threads per worker)


def _inputs(rng, batch=3, n=300):
    centers = rng.uniform(0.4, 0.6, (batch, n, 2))       # heavy overlap
    half = rng.uniform(0.05, 0.2, (batch, n, 2))
    boxes = np.concatenate([centers - half, centers + half], -1)
    scores = rng.uniform(0, 1, (batch, n))
    labels = rng.integers(0, 4, (batch, n))
    return (boxes.astype(np.float32), scores.astype(np.float32),
            labels.astype(np.int32))


@pytest.mark.parametrize("class_aware", [False, True])
@pytest.mark.parametrize("num_candidates,max_detections", [
    (64, 20),       # K < N
    (300, 20),      # K == N: exact top-k, no approximate path
    (8, 20),        # max_detections > K: the pad path
])
def test_matches_jax(class_aware, num_candidates, max_detections, rng):
    boxes, scores, labels = _inputs(rng)
    kw = dict(conf_threshold=0.3, iou_threshold=0.45,
              max_detections=max_detections, num_candidates=num_candidates,
              class_aware=class_aware)
    want = jax.jit(lambda b, s, c: JN.batched_nms_scored(b, s, c, **kw))(
        boxes, scores, labels)
    got = TN.batched_nms_scored(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(labels), **kw)
    assert (np.asarray(want.num) > 0).all()
    for name in ("num", "classes", "valid", "boxes", "scores"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_fetch_round_trips(rng):
    boxes, scores, labels = _inputs(rng)
    dets = TN.batched_nms_scored(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(labels))
    host = TN.fetch_detections(dets)
    for name in dets._fields:
        np.testing.assert_array_equal(getattr(host, name),
                                      getattr(dets, name).numpy())
