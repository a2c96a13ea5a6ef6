"""Port NMS (post/nms.py, ops/kernels/nms.py) vs the JAX package's
batched_nms_scored: num, classes and valid equal, boxes and scores exact
(NMS only selects; it computes no output values). Random, heavily
overlapping boxes, and the odd cases chip_smoke.py phase 14 holds the CUDA
kernel to: batch 1, K > N, D > K, no candidate or every candidate active, a
suppression chain, an IoU of exactly the threshold, zero-area and inverted
boxes, K from 8 to 1024. Scores are distinct: exactly tied scores are
unordered in the reference too.

The kernel cannot run here; ``_kernel_walk`` transcribes its sequential
walk (float32 IoU in iou_matrix's order, dead flags, stop at the D-th kept
candidate) in numpy, and is held to the plain batched fixpoint."""

import numpy as np
import pytest
import torch

import jax

from yolo_tensorflow_tpu.post import nms as JN
from yolo_tensorflow_tpu_torch.ops.kernels import nms as K
from yolo_tensorflow_tpu_torch.post import nms as TN

import torch_parity  # noqa: F401  (caps torch threads per worker)


def _inputs(rng, batch=3, n=300):
    centers = rng.uniform(0.4, 0.6, (batch, n, 2))       # heavy overlap
    half = rng.uniform(0.05, 0.2, (batch, n, 2))
    boxes = np.concatenate([centers - half, centers + half], -1)
    scores = rng.permutation(batch * n).reshape(batch, n) / (batch * n)
    labels = rng.integers(0, 4, (batch, n))
    return (boxes.astype(np.float32), scores.astype(np.float32),
            labels.astype(np.int32))


def _fixed(boxes, scores, labels=None):
    boxes = np.asarray(boxes, np.float32)[None]
    scores = np.asarray(scores, np.float32)[None]
    labels = (np.zeros(scores.shape, np.int32) if labels is None
              else np.asarray(labels, np.int32)[None])
    return boxes, scores, labels


def _case(name, rng):
    """(boxes, scores, labels, NMS options) of one odd case."""
    if name == "batch 1":
        return (*_inputs(rng, batch=1), {})
    if name == "K > N":                      # yolov1's 98 boxes an image
        return (*_inputs(rng, n=98), dict(num_candidates=256))
    if name == "D > K":
        return (*_inputs(rng), dict(num_candidates=8, max_detections=20))
    if name == "none active":
        b, s, c = _inputs(rng)
        return b, s * 0.29, c, {}
    if name == "all active":
        b, s, c = _inputs(rng, n=64)
        return b, s + 0.5, c, dict(conf_threshold=0.3)
    if name == "chain":
        # A suppresses B (IoU 1/3); B would suppress C, but B is gone, and A
        # and C do not overlap: A and C are kept
        return (*_fixed([[0, 0, 2, 1], [1, 0, 3, 1], [2, 0, 4, 1],
                         [5, 5, 6, 6]], [0.9, 0.8, 0.7, 0.6]),
                dict(iou_threshold=0.3))
    if name == "IoU at the threshold":
        # IoU exactly 0.5 is no overlap (> thr); 0.5 + 2**-10 is
        return (*_fixed([[0, 0, 1, 1], [0, 0, 1, 0.5], [0, 0, 1, 0.5009765625],
                         [0, 0, 1, 1]], [0.9, 0.8, 0.7, 0.6]),
                dict(iou_threshold=0.5))
    if name == "degenerate":
        b, s, c = _inputs(rng, n=64)
        b[:, ::4, 2] = b[:, ::4, 0]                     # zero width
        b[:, 1::4, 3] = b[:, 1::4, 1]                   # zero height
        b[:, 2::4, [0, 2]] = b[:, 2::4, [2, 0]]         # inverted in x
        b[:, 3::8, :] = 0.0                             # a point at 0
        return b, s, c, {}
    k = int(name.split()[-1])                           # "K = 8" ...
    return (*_inputs(rng, n=max(k, 1200) if k > 300 else 300),
            dict(num_candidates=k))


CASES = ["batch 1", "K > N", "D > K", "none active", "all active", "chain",
         "IoU at the threshold", "degenerate", "K = 8", "K = 64", "K = 256",
         "K = 300", "K = 1024"]
DEFAULTS = dict(conf_threshold=0.3, iou_threshold=0.45, max_detections=20,
                num_candidates=64)


def _run(name, class_aware, rng):
    boxes, scores, labels, kw = _case(name, rng)
    kw = dict(DEFAULTS, **kw, class_aware=class_aware)
    return boxes, scores, labels, kw


def _assert_equal(got, want):
    for name in ("num", "classes", "valid", "boxes", "scores"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


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
    _assert_equal(got, want)


@pytest.mark.parametrize("class_aware", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_odd_cases_match_jax(name, class_aware, rng):
    boxes, scores, labels, kw = _run(name, class_aware, rng)
    want = jax.jit(lambda b, s, c: JN.batched_nms_scored(b, s, c, **kw))(
        boxes, scores, labels)
    args = [torch.from_numpy(a) for a in (boxes, scores, labels)]
    got = TN.batched_nms_scored(*args, **kw)
    _assert_equal(got, want)
    _assert_equal(TN.batched_nms_scored_plain(*args, **kw), want)
    if name == "none active":
        assert not np.asarray(want.num).any()
    if name == "chain":
        assert got.num.tolist() == [3] and got.scores[0, :3].tolist() == [
            pytest.approx(0.9), pytest.approx(0.7), pytest.approx(0.6)]
    if name == "IoU at the threshold":
        assert got.num.tolist() == [2]       # the third and fourth go


def _kernel_walk(boxes, scores, labels, *, conf_threshold, iou_threshold,
                 max_detections, class_aware):
    """numpy transcription of csrc/nms.cu's walk over one batch."""
    f32 = np.float32
    B, k = scores.shape
    D = max_detections
    out = (np.zeros((B, D, 4), f32), np.zeros((B, D), f32),
           np.zeros((B, D), np.int32), np.zeros((B, D), bool),
           np.zeros(B, np.int32))

    def area(b):
        return (np.maximum(b[2] - b[0], f32(0))
                * np.maximum(b[3] - b[1], f32(0)))

    for img in range(B):
        bx = boxes[img]
        areas = [area(b) for b in bx]
        dead = ~(scores[img] > f32(conf_threshold))
        kept = []
        for i in range(k):
            if dead[i]:
                continue
            kept.append(i)
            if len(kept) == D:
                break
            for j in range(i + 1, k):
                if dead[j]:
                    continue
                if class_aware and labels[img, j] != labels[img, i]:
                    v = f32(0)
                else:
                    a, b = bx[i], bx[j]
                    inter = (np.maximum(np.minimum(a[2], b[2])
                                        - np.maximum(a[0], b[0]), f32(0))
                             * np.maximum(np.minimum(a[3], b[3])
                                          - np.maximum(a[1], b[1]), f32(0)))
                    union = (areas[i] + areas[j]) - inter
                    v = inter / np.maximum(union, f32(1e-9))
                if v > f32(iou_threshold):
                    dead[j] = True
        for s, c in enumerate(kept):
            out[0][img, s] = bx[c]
            out[1][img, s] = scores[img, c]
            out[2][img, s] = labels[img, c]
            out[3][img, s] = True
        out[4][img] = len(kept)
    return TN.Detections(*out)


@pytest.mark.parametrize("class_aware", [False, True])
@pytest.mark.parametrize("name", CASES[:-1])
def test_kernel_walk_equals_the_plain_version(name, class_aware, rng):
    """The kernel's algorithm (sequential walk, stop at the D-th kept
    candidate, first D kept in rank order) on the candidates
    select_candidates gives it, against greedy_select_plain."""
    boxes, scores, labels, kw = _run(name, class_aware, rng)
    cand = TN.select_candidates(
        *(torch.from_numpy(a) for a in (boxes, scores, labels)),
        conf_threshold=kw["conf_threshold"],
        num_candidates=kw.pop("num_candidates"))
    want = K.greedy_select_plain(*cand, **kw)
    got = _kernel_walk(*(t.numpy() for t in cand), **kw)
    _assert_equal(got, TN.Detections(*want))


def test_fetch_round_trips(rng):
    boxes, scores, labels = _inputs(rng)
    dets = TN.batched_nms_scored(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(labels))
    host = TN.fetch_detections(dets)
    for name in dets._fields:
        np.testing.assert_array_equal(getattr(host, name),
                                      getattr(dets, name).numpy())
