"""Port NMS (post/nms.py, ops/kernels/nms.py) vs the JAX package's
batched_nms_scored: num, classes and valid equal, boxes and scores exact
(NMS only selects; it computes no output values). Random, heavily
overlapping boxes, and the odd cases chip_smoke.py phase 14 holds the CUDA
kernel to: batch 1, K > N, D > K, no candidate or every candidate active, a
suppression chain, an IoU of exactly the threshold, zero-area and inverted
boxes, K from 8 to 1024. Scores are distinct: exactly tied scores are
unordered in the reference too.

The kernel cannot run here; ``_kernel`` transcribes csrc/nms.cu in numpy
(the order keys with -0.0 made +0.0, the radix select over the varying bits
with its index tie-break, the ranking by (key, index), the walk through
windows of 32 ranks that stops at the D-th kept candidate, float32 IoU in
iou_matrix's order) and is
held to the plain version on the unranked decode, at the odd cases and at
the kernel's own: exact bf16 ties across the K-th candidate, +0.0 beside
-0.0, NaN and inf scores and boxes, fewer, as many and more active
candidates than K, and yolov3-416's N = 10647."""

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
    if name == "ties at the K-th":
        # bf16-rounded scores: exact ties, across the K-th among them
        b, s, c = _inputs(rng)
        s = torch.from_numpy(rng.uniform(0.3, 0.9, s.shape).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
        return b, s, c, {}
    if name == "+0 and -0":
        # all active at conf -0.5; the K-th among many +-0.0 in any order
        b, s, c = _inputs(rng)
        s = rng.choice(np.float32([0.5, 0.25, 0.0, -0.0, -0.25]), s.shape,
                       p=[0.05, 0.05, 0.3, 0.3, 0.3])
        return b, s, c, dict(conf_threshold=-0.5)
    if name == "NaN and inf":
        b, s, c = _inputs(rng)
        s[:, ::7] = np.nan
        s[:, 3::11] = np.inf
        s[:, 5::13] = -np.inf
        b[:, 1::17, 2] = np.nan                         # NaN and inf boxes
        b[:, 2::19, 3] = np.inf
        return b, s, c, {}
    if name in ("A < K", "A = K", "A > K"):
        # K = 64 of 300, exactly 40, 64 or 100 active in each image
        b, s, c = _inputs(rng)
        a = {"A < K": 40, "A = K": 64, "A > K": 100}[name]
        s = s * np.float32(0.29)
        for img in range(s.shape[0]):
            on = rng.choice(s.shape[1], a, replace=False)
            s[img, on] = rng.permutation(a) / np.float32(a) * 0.6 + 0.35
        return b, s.astype(np.float32), c, {}
    if name == "N = 10647":                             # yolov3-416's rows
        return (*_inputs(rng, batch=2, n=10647), dict(num_candidates=256))
    k = int(name.split()[-1])                           # "K = 8" ...
    return (*_inputs(rng, n=max(k, 1200) if k > 300 else 300),
            dict(num_candidates=k))


CASES = ["batch 1", "K > N", "D > K", "none active", "all active", "chain",
         "IoU at the threshold", "degenerate", "K = 8", "K = 64", "K = 256",
         "K = 300", "K = 1024"]
# the kernel's own cases besides: ties, signed zeros, NaN and inf, the
# active count against K, the main path's N
KERNEL_CASES = CASES + ["ties at the K-th", "+0 and -0", "NaN and inf",
                        "A < K", "A = K", "A > K", "N = 10647"]
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


def _keys(scores, conf):
    """csrc/nms.cu's score_key: 0 for an inactive score (NaN included), else
    a uint32 that orders as the score, -0.0 first made +0.0."""
    s = np.ascontiguousarray(scores, np.float32)
    u = s.view(np.uint32).astype(np.int64)
    u[u == 0x80000000] = 0
    key = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    with np.errstate(invalid="ignore"):
        return np.where(s > np.float32(conf), key, 0)


def _radix_select(keys, k):
    """The kernel's selection from one image's keys: (threshold, how many
    keys equal to it are taken). Every key above the threshold is taken.
    Radix select of the K-th largest key in 8-bit digits over the bits that
    vary among the active keys, stopping where a digit's bin holds just the
    keys still wanted."""
    act = keys[keys > 0]
    if act.size <= k:
        return 0, 0
    k_and = int(np.bitwise_and.reduce(act))
    vary = k_and ^ int(np.bitwise_or.reduce(act))
    prefix, decided, remaining = k_and, ~vary & 0xFFFFFFFF, k
    lo, shift = (vary & -vary).bit_length() - 1, vary.bit_length()
    while vary and shift > lo:
        width = min(8, shift - lo)
        shift -= width
        digit = ((1 << width) - 1) << shift
        match = act[((act ^ prefix) & decided) == 0]
        hist = np.bincount((match & digit) >> shift, minlength=256)
        above, b = 0, 255
        while above + hist[b] < remaining:     # from the top bin down
            above += hist[b]
            b -= 1
        fits = above + hist[b] == remaining
        remaining -= above
        prefix = (prefix & ~digit) | (b << shift)
        decided |= digit
        if fits:                      # the bin holds just the keys wanted
            return prefix - 1, 0
    return prefix, remaining


def _iou_f32(a, area_a, b, area_b):
    """The kernel's iou of one box against many, float32 step by step in
    iou_matrix's order; NaN kept by max, min and the clamps."""
    f32 = np.float32

    def clamp0(v):
        return np.where(v < f32(0), f32(0), v)

    with np.errstate(all="ignore"):
        inter = (clamp0(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]))
                 * clamp0(np.minimum(a[3], b[:, 3])
                          - np.maximum(a[1], b[:, 1])))
        union = (area_a + area_b) - inter
        return inter / np.where(union < f32(1e-9), f32(1e-9), union)


def _kernel(boxes, scores, labels, *, conf_threshold, iou_threshold,
            max_detections, num_candidates, class_aware):
    """numpy transcription of csrc/nms.cu over one batch -> (Detections,
    each image's ranked candidates (boxes, scores, labels))."""
    f32 = np.float32
    B, n = scores.shape
    k, D = min(num_candidates, n), max_detections
    out = (np.zeros((B, D, 4), f32), np.zeros((B, D), f32),
           np.zeros((B, D), np.int32), np.zeros((B, D), bool),
           np.zeros(B, np.int32))
    ranked = []
    for img in range(B):
        keys = _keys(scores[img], conf_threshold)
        threshold, need = _radix_select(keys, k)
        # every key above the threshold, the first `need` equal to it in
        # index order; ranked by the pair (key, ~index), largest first
        sel = np.concatenate([np.flatnonzero(keys > threshold),
                              np.flatnonzero(keys == threshold)[:need]])
        pairs = (keys[sel].astype(np.uint64) << np.uint64(32)) | (
            ~sel.astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
        order = np.empty_like(sel)
        order[(pairs[None, :] > pairs[:, None]).sum(1)] = sel
        bx = boxes[img, order]
        with np.errstate(invalid="ignore"):
            area = (np.where(bx[:, 2] - bx[:, 0] < 0, f32(0),
                             bx[:, 2] - bx[:, 0])
                    * np.where(bx[:, 3] - bx[:, 1] < 0, f32(0),
                               bx[:, 3] - bx[:, 1]))
        lab = labels[img, order]
        ranked.append((bx, scores[img, order], lab))
        # the walk, 32 ranks at a time: a window's ranks that a candidate
        # kept before it overlaps are dead; one thread's chain through the
        # window keeps each live one and removes the later ones it
        # overlaps; it stops at the D-th kept
        s = len(order)

        def overlaps(r, j):
            v = _iou_f32(bx[r], area[r], bx[j], area[j])
            if class_aware:
                v = np.where(lab[j] != lab[r], f32(0), v)
            return v > f32(iou_threshold)

        kept = []
        for q in range(0, s, 32):
            if len(kept) == D:
                break
            window = np.arange(q, min(q + 32, s))
            removed = np.zeros(len(window), bool)
            for r in kept:
                removed |= overlaps(r, window)
            for i in window:
                if len(kept) < D and not removed[i - q]:
                    kept.append(i)
                    removed |= overlaps(i, window) & (window > i)
        for slot, r in enumerate(kept):
            out[0][img, slot] = bx[r]
            out[1][img, slot] = scores[img, order[r]]
            out[2][img, slot] = lab[r]
            out[3][img, slot] = True
        out[4][img] = len(kept)
    return TN.Detections(*out), ranked


@pytest.mark.parametrize("class_aware", [False, True])
@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_walk_equals_the_plain_version(name, class_aware, rng):
    """The kernel's algorithm (keys, radix select with its index tie-break,
    ranking, the windowed walk that stops at the D-th kept candidate) on the
    unranked decode, against batched_nms_scored_plain: the same ranked
    candidates as select_candidates' active ones, and all five fields."""
    boxes, scores, labels, kw = _run(name, class_aware, rng)
    args = [torch.from_numpy(a) for a in (boxes, scores, labels)]
    want = TN.batched_nms_scored_plain(*args, **kw)
    got, ranked = _kernel(boxes, scores, labels, **kw)
    _assert_equal(got, want)
    cand = K.select_candidates(*args, conf_threshold=kw["conf_threshold"],
                               num_candidates=kw["num_candidates"])
    active = cand[1] > kw["conf_threshold"]
    for img, (bx, sc, lab) in enumerate(ranked):
        s = int(active[img].sum())
        assert len(sc) == s and not active[img, s:].any()
        np.testing.assert_array_equal(bx, cand[0][img, :s].numpy())
        np.testing.assert_array_equal(sc, cand[1][img, :s].numpy())
        np.testing.assert_array_equal(lab, cand[2][img, :s].numpy())
    if name == "ties at the K-th":
        # some image's K-th score is tied with one past the K-th
        top = np.sort(scores, axis=1)[:, ::-1]
        k = kw["num_candidates"]
        assert (top[:, k - 1] == top[:, k]).any()
    if name == "+0 and -0":
        assert (np.signbit(scores) & (scores == 0)).any()


def test_fetch_round_trips(rng):
    boxes, scores, labels = _inputs(rng)
    dets = TN.batched_nms_scored(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(labels))
    host = TN.fetch_detections(dets)
    for name in dets._fields:
        np.testing.assert_array_equal(getattr(host, name),
                                      getattr(dets, name).numpy())
