"""Port flip-TTA and bf16 scoring (models/heads.py, post/nms.py,
pipeline.py, ops/kernels/decode.py's bf16 mode) vs the JAX package, on the
same numpy inputs, on the CPU.

- Head functions on seeded activations at widths 4 and 5 (odd widths skip
  the middle column in the darknet mode): ``activate_v2``/``activate_v3``,
  both flip averages in both ``tta_mode``s, exactly (elementwise sigmoid,
  softmax and averages that round as JAX's do, within ULPS float32 ulps
  where exp or the softmax sum round differently); the decodes of
  activated outputs, the materializing ``decode`` and ``decode_v2`` within
  rtol 1e-5 / atol 1e-6, labels equal.
- bf16 scoring (``score_dtype=torch.bfloat16``): scores within one bf16 ulp
  of JAX's, labels equal; the kernel wrapper's plain version on the CPU is
  ``heads.decode_scored``'s.
- ``post.nms.batched_nms`` equals JAX's (all five fields) on the same
  decode; bf16 Detections compare place by place, as candidates keep
  ``lax.top_k``'s index order of tied scores.
- ``Detector(tta=True)`` in both modes against the JAX Detector: v3 and v2
  narrow specs, int8 params, and the fused letterbox: num, classes and
  valid equal, boxes and scores at rtol 1e-4 / atol 1e-5 (float32 conv sums
  in another order), as tests/test_torch_pipeline.py holds detect_batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tensorflow_tpu.models import heads as JH
from yolo_tensorflow_tpu.pipeline import Detector as JaxDetector
from yolo_tensorflow_tpu.post import nms as JN
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.models import engine as TE
from yolo_tensorflow_tpu_torch.models import heads as TH
from yolo_tensorflow_tpu_torch.models import specs as TS
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
from yolo_tensorflow_tpu_torch.pipeline import Detector
from yolo_tensorflow_tpu_torch.post import nms as TN

from torch_parity import (folded_params, images, jax_int8_params, jax_model,
                          model)

SIZE = 64
OPTS = dict(conf_threshold=0.3, num_candidates=64)
TOL = dict(rtol=1e-5, atol=1e-6)
PARITY = dict(rtol=1e-4, atol=1e-5)
ULPS = 2
MODES = ["darknet", "corrected"]


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _head(rng, width, anchors, classes, scale=2.0):
    return (rng.standard_normal((2, width, width, anchors * (5 + classes)),
                                dtype=np.float32) * scale)


def _cfgs():
    """(port cfg, JAX cfg) of the narrow v2 model: 5 anchors, 4 classes."""
    return model("narrow-v2", SIZE)[0], jax_model("narrow-v2", SIZE)[0]


@pytest.mark.parametrize("width", [4, 5])
def test_activations_match_jax(width, rng):
    cfg, jcfg = _cfgs()
    feat = _head(rng, width, 5, 4)
    got = TH.activate_v2(torch.from_numpy(feat), cfg).numpy()
    assert _ulps(got, JH.activate_v2(jnp.asarray(feat), jcfg)) <= ULPS
    got = TH.activate_v3(torch.from_numpy(feat), 5, 4).numpy()
    assert _ulps(got, JH.activate_v3(jnp.asarray(feat), 5, 4)) <= ULPS


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("width", [4, 5])
def test_flip_averages_match_jax(width, mode, rng):
    """On the same activated inputs the average is elementwise: exact."""
    cfg, jcfg = _cfgs()
    act = rng.uniform(-1, 1, (2, width, width, 5 * 9)).astype(np.float32)
    flipped = rng.uniform(-1, 1, act.shape).astype(np.float32)
    t = (torch.from_numpy(act), torch.from_numpy(flipped))
    j = (jnp.asarray(act), jnp.asarray(flipped))
    np.testing.assert_array_equal(
        TH.region_flip_tta(*t, cfg, mode=mode).numpy(),
        np.asarray(JH.region_flip_tta(*j, jcfg, mode=mode)))
    np.testing.assert_array_equal(
        TH.yolo_flip_tta(*t, 5, 4, mode=mode).numpy(),
        np.asarray(JH.yolo_flip_tta(*j, 5, 4, mode=mode)))


def test_darknet_mode_quirks():
    """The darknet mode negates the planes p < A of the [anchor][entry]
    buffer (anchor 0's x, y, w, h, obj for A = 5), on activated values, and
    leaves the middle column of an odd width alone; corrected sets x to
    1 - x for every anchor."""
    cfg, _ = _cfgs()
    zeros = torch.zeros((1, 1, 5, 45))
    ones = torch.ones((1, 1, 5, 45))
    avg = TH.region_flip_tta(zeros, ones, cfg).reshape(5, 5, 9)
    negated = torch.zeros((5, 9), dtype=torch.bool)
    negated[0, :5] = True
    for col in range(5):
        want = torch.where(negated, -0.5, 0.5) if col != 2 \
            else torch.full((5, 9), 0.5)
        assert torch.equal(avg[col], want), col
    avg = TH.region_flip_tta(zeros, ones, cfg, mode="corrected")
    avg = avg.reshape(5, 5, 9)
    assert torch.equal(avg[..., 0], torch.zeros((5, 5)))
    assert torch.equal(avg[..., 1:], torch.full((5, 5, 8), 0.5))
    with pytest.raises(ValueError, match="tta_mode"):
        TH.region_flip_tta(zeros, ones, cfg, mode="mirror")


def _check(got, want, tol=TOL):
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


@pytest.mark.parametrize("width", [4, 5])
def test_activated_decodes_match_jax(width, rng):
    cfg, jcfg = _cfgs()
    act = rng.uniform(0, 1, (2, width, width, 45)).astype(np.float32)
    act[..., 2::9] = rng.standard_normal(act[..., 2::9].shape)
    got = TH.decode_v2_activated(torch.from_numpy(act), cfg)
    want = JH.decode_v2_activated(jnp.asarray(act), jcfg)
    _check(got, want)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    anchors = [(10, 13), (16, 30), (33, 23), (30, 61), (62, 45)]
    got = TH.decode_v3_scale_activated(torch.from_numpy(act), anchors, SIZE,
                                       4)
    want = JH.decode_v3_scale_activated(jnp.asarray(act), anchors, SIZE, 4)
    _check(got, want)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["narrow", "narrow-v2", "narrow-v1"])
def test_materializing_decode_matches_jax(name, score_dtype, rng):
    """heads.decode: every head; bf16 class probabilities (v3 only) within
    one bf16 ulp."""
    cfg, specs = model(name, SIZE)
    jcfg, _ = jax_model(name, SIZE)
    dets, jdets = [], []
    shapes = TE.infer_shapes(specs, (2, SIZE, SIZE, 3))
    for i, spec in enumerate(specs):
        if isinstance(spec, TS.Detect):
            feat = rng.standard_normal(shapes[i], dtype=np.float32)
            dets.append((torch.from_numpy(feat), spec))
            jdets.append((jnp.asarray(feat), spec))
    bf16 = score_dtype == "bfloat16"
    got = TH.decode(dets, cfg, torch.bfloat16 if bf16 else None)
    want = JH.decode(jdets, jcfg, jnp.bfloat16 if bf16 else jnp.float32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == (torch.bfloat16 if bf16 and cfg.head == 3
                           else torch.float32)
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w.astype(jnp.float32)),
            **(dict(rtol=2 ** -8, atol=0) if g.dtype == torch.bfloat16
               else TOL))


@pytest.mark.parametrize("width", [4, 5])
def test_bf16_scoring_matches_jax(width, rng):
    """score_dtype=bf16 on the v3 head: labels equal, scores within one
    bf16 ulp (rtol 2**-8) of JAX's decode_scored; the v2 head ignores it.
    The decode wrapper's plain version (the kernel's twin) is exactly
    heads.decode_scored's on the CPU."""
    cfg, specs = model("narrow", SIZE)
    jcfg, _ = jax_model("narrow", SIZE)
    feats = [rng.standard_normal((2, width, width, 27), dtype=np.float32) * 3
             for _ in range(2)]
    dets = [(torch.from_numpy(f), s) for f, s in
            zip(feats, [specs[10], specs[17]])]
    jdets = [(jnp.asarray(f), s) for f, s in zip(feats, [specs[10],
                                                         specs[17]])]
    got = TH.decode_scored(dets, cfg, score_dtype=torch.bfloat16)
    want = JH.decode_scored(jdets, jcfg, score_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2 ** -8, atol=0)
    assert not torch.equal(got[1], TH.decode_scored(dets, cfg)[1])
    before = K.launches
    fused = K.decode_fused(dets, cfg, score_dtype=torch.bfloat16)
    assert K.launches == before
    assert torch.equal(fused[1], got[1]) and torch.equal(fused[2], got[2])
    v2cfg, _ = _cfgs()
    head = [(torch.from_numpy(_head(rng, width, 5, 4)), None)]
    assert all(torch.equal(a, b) for a, b in zip(
        TH.decode_scored(head, v2cfg, score_dtype=torch.bfloat16),
        TH.decode_scored(head, v2cfg)))


def test_bf16_sigmoid_rounds_step_by_step(rng):
    """heads.sigmoid_bf16 equals jax.nn.sigmoid on bf16 (XLA rounds each of
    exp, 1 + e and the reciprocal to bf16) on every bf16 value in
    [-16, 16]."""
    x = np.arange(-16, 16, 2 ** -7, dtype=np.float32)
    got = TH.sigmoid_bf16(torch.from_numpy(x)).float().numpy()
    want = np.asarray(jax.jit(jax.nn.sigmoid)(
        jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("class_aware", [False, True])
def test_batched_nms_matches_jax(class_aware, rng):
    cfg, jcfg = _cfgs()
    feat = _head(rng, 8, 5, 4)
    boxes, conf, probs = TH.decode_v2(torch.from_numpy(feat), cfg)
    jb, jc, jp = JH.decode_v2(jnp.asarray(feat), jcfg)
    kw = dict(conf_threshold=0.2, iou_threshold=0.4, max_detections=10,
              num_candidates=64, class_aware=class_aware)
    before = NK.launches
    got = TN.batched_nms(TH.xywh_to_xyxy(boxes), conf, probs, **kw)
    plain = TN.batched_nms_plain(TH.xywh_to_xyxy(boxes), conf, probs, **kw)
    assert NK.launches == before
    want = JN.batched_nms(JH.xywh_to_xyxy(jb), jc, jp, **kw)
    assert (got.num > 0).all()
    for name in ("num", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
        assert torch.equal(getattr(got, name), getattr(plain, name))
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL)


def _check_detections(got, want, **tol):
    assert (got.num > 0).all()
    for name in ("num", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **tol,
                                   err_msg=name)


def _params(name, int8):
    """(port cfg, specs, JAX cfg, JAX specs, JAX params): float folded
    params, or the JAX package's int8 quantization of them."""
    if int8:
        return jax_int8_params(name, SIZE)
    cfg, specs = model(name, SIZE)
    jcfg, jspecs = jax_model(name, SIZE)
    return cfg, specs, jcfg, jspecs, folded_params(specs, SIZE)[1]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,int8", [("narrow", False), ("narrow-v2", False),
                                       ("narrow", True)],
                         ids=["v3", "v2", "v3-int8"])
def test_detector_tta_matches_jax(name, int8, mode):
    cfg, specs, jcfg, jspecs, jparams = _params(name, int8)
    imgs = images(2, SIZE)
    kw = dict(tta=True, tta_mode=mode, **OPTS)
    want = JaxDetector(jcfg, params=jparams, specs=jspecs,
                       **kw).detect_batch(imgs)
    det = Detector(cfg, params=TW.params_from_jax(jparams), specs=specs,
                   device="cpu", **kw)
    before = K.launches, NK.launches
    got = det.detect_batch(imgs)
    assert (K.launches, NK.launches) == before
    _check_detections(got, want, **PARITY)
    plain = Detector(cfg, params=TW.params_from_jax(jparams), specs=specs,
                     device="cpu", **OPTS).detect_batch(imgs)
    assert not torch.equal(got.scores, plain.scores)


@pytest.mark.parametrize("mode", MODES)
def test_detector_tta_fused_letterbox_matches_jax(mode):
    """TTA on the fused letterbox: the letterboxed tensor is mirrored, pad
    columns and all; boxes in pixels (atol 1e-3 as the fused tests)."""
    cfg, specs, jcfg, jspecs, jparams = _params("narrow", False)
    rng = np.random.default_rng(7)
    sizes = np.asarray([(40, 100), (100, 40)], np.int32)
    canvas = np.zeros((2, 128, 128, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        canvas[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    kw = dict(tta=True, tta_mode=mode, letterbox=True, fused=True,
              **dict(OPTS, conf_threshold=0.1))
    want = JaxDetector(jcfg, params=jparams, specs=jspecs,
                       **kw).detect_batch_fused(canvas, sizes)
    got = Detector(cfg, params=TW.params_from_jax(jparams), specs=specs,
                   device="cpu", **kw).detect_batch_fused(canvas, sizes)
    _check_detections(got, want, rtol=1e-4, atol=1e-3)


def _check_bf16_detections(got, want, box_atol):
    """bf16 scores tie often (steps of 2**-9 in [0.5, 1)); candidates keep
    the index order of tied scores, as lax.top_k does, so the Detections
    are compared place by place: num, classes and valid equal, scores
    within one bf16 ulp, boxes within ``box_atol``."""
    for name in ("num", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (got.num > 0).all()
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-4, atol=box_atol)
    ties = [len(r) - len(set(r)) for r in got.scores.numpy().tolist()]
    assert any(ties), "no tied scores: the test would not see tie order"


@pytest.mark.parametrize("fused", [False, True], ids=["batch", "letterbox"])
def test_detector_bf16_scores_match_jax(fused):
    """Detector(score_dtype=bf16) at float32 compute: the bf16 scoring is
    the only difference from JAX's network output (see
    ``_check_bf16_detections``)."""
    cfg, specs, jcfg, jspecs, jparams = _params("narrow", False)
    imgs = images(2, SIZE)
    kw = dict(OPTS)
    if fused:
        kw.update(letterbox=True, fused=True, letterbox_dtype=jnp.float32)
    jdet = JaxDetector(jcfg, params=jparams, specs=jspecs,
                       score_dtype=jnp.bfloat16, **kw)
    if fused:
        kw["letterbox_dtype"] = torch.float32
    det = Detector(cfg, params=TW.params_from_jax(jparams), specs=specs,
                   device="cpu", score_dtype=torch.bfloat16, **kw)
    if fused:
        sizes = np.asarray([(SIZE, SIZE)] * 2, np.int32)
        want = jdet.detect_batch_fused(imgs, sizes)
        got = det.detect_batch_fused(imgs, sizes)
    else:
        want, got = jdet.detect_batch(imgs), det.detect_batch(imgs)
    _check_bf16_detections(got, want, 1e-3 if fused else 1e-5)


def test_detector_accepts_fused_decode():
    """fused_decode is the TPU package's choice of decode; the port always
    decodes through the kernel, and both values give the same Detections."""
    cfg, specs = model("narrow", SIZE)
    params = folded_params(specs, SIZE)[0]
    imgs = images(2, SIZE)
    out = [Detector(cfg, params=params, specs=specs, device="cpu",
                    fused_decode=v, **OPTS).detect_batch(imgs)
           for v in (None, False, True)]
    for d in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(d, out[0]))


def test_tta_needs_a_v2_or_v3_head():
    cfg, specs = model("narrow-v1", SIZE)
    params = folded_params(specs, SIZE)[0]
    with pytest.raises(ValueError, match="flip-TTA"):
        Detector(cfg, params=params, specs=specs, device="cpu", tta=True)
    cfg, specs = model("narrow", SIZE)
    params = folded_params(specs, SIZE)[0]
    with pytest.raises(ValueError, match="tta_mode"):
        Detector(cfg, params=params, specs=specs, device="cpu", tta=True,
                 tta_mode="mirror")
    with pytest.raises(TypeError, match="score_dtype"):
        Detector(cfg, params=params, specs=specs, device="cpu",
                 score_dtype=torch.float16)
