"""Port decode (ops/kernels/decode.py, models/heads.py) vs the JAX package's
Pallas kernel in interpret mode and its XLA decode, mirroring
tests/test_pallas_decode.py: rtol 1e-5 / atol 1e-6 (float32 transcendental
rounding), labels equal; the v1 grid head (no kernel in either package)
against heads.decode_v1 and decode_scored at the same tolerance. On CPU
tensors the wrappers run the plain version and the kernel launch counter
stays 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_tensorflow_tpu import config as JC
from yolo_tensorflow_tpu.models import heads as JH
from yolo_tensorflow_tpu.models import specs as JS
from yolo_tensorflow_tpu.ops.pallas.decode import (decode_fused as
                                                   jax_decode_fused)
from yolo_tensorflow_tpu.ops.pallas.decode import (decode_scale_fused as
                                                   jax_decode_scale_fused)
from yolo_tensorflow_tpu_torch import config as C
from yolo_tensorflow_tpu_torch.models import heads as TH
from yolo_tensorflow_tpu_torch.models import specs as S
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K

import torch_parity  # noqa: F401  (caps torch threads per worker)

TOL = dict(rtol=1e-5, atol=1e-6)


def _check(got, want):
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))


def _v3_scale(rng):
    cfg = C.get_config("yolov3")
    feat = rng.standard_normal((2, 13, 13, 3 * (5 + cfg.num_classes)),
                               dtype=np.float32)
    return cfg, feat, [cfg.anchors[i] for i in (6, 7, 8)]


def test_v3_scale_matches_pallas_interpret(rng):
    cfg, feat, anchors = _v3_scale(rng)
    want = jax_decode_scale_fused(jnp.asarray(feat), anchors, cfg.input_size,
                                  cfg.num_classes, interpret=True)
    before = K.launches
    got = K.decode_scale_fused(torch.from_numpy(feat), anchors,
                               cfg.input_size, cfg.num_classes)
    assert K.launches == before
    _check(got, want)
    _check(K.decode_scale_plain(torch.from_numpy(feat), anchors,
                                cfg.input_size, cfg.num_classes), want)


def test_v3_scale_matches_xla_decode(rng):
    """Against heads.decode_v3_scale's materialized (N, C) scores, in both
    packages."""
    cfg, feat, anchors = _v3_scale(rng)
    bx, conf, probs = JH.decode_v3_scale(jnp.asarray(feat), anchors,
                                         cfg.input_size, cfg.num_classes)
    scores = np.asarray(conf)[..., None] * np.asarray(probs)
    want = (JH.xywh_to_xyxy(bx), scores.max(-1), scores.argmax(-1))
    _check(K.decode_scale_fused(torch.from_numpy(feat), anchors,
                                cfg.input_size, cfg.num_classes), want)
    tb, tconf, tprobs = TH.decode_v3_scale(torch.from_numpy(feat), anchors,
                                           cfg.input_size, cfg.num_classes)
    np.testing.assert_allclose(tb.numpy(), np.asarray(bx), **TOL)
    np.testing.assert_allclose(tconf.numpy(), np.asarray(conf), **TOL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), **TOL)


def test_v2_matches_pallas_and_xla(rng):
    cfg = C.get_config("yolov2-tiny-voc")
    A, Cn = cfg.num_anchors, cfg.num_classes
    feat = rng.standard_normal((2, 13, 13, A * (5 + Cn)), dtype=np.float32)
    jcfg, jdet = JC.get_config("yolov2-tiny-voc"), JS.Detect(tuple(range(A)))
    want = jax_decode_fused([(jnp.asarray(feat), jdet)], jcfg, interpret=True)
    got = K.decode_fused([(torch.from_numpy(feat), S.Detect(tuple(range(A))))],
                         cfg)
    _check(got, want)

    bx, conf, probs = JH.decode([(jnp.asarray(feat), jdet)], jcfg)
    scores = np.asarray(conf)[..., None] * np.asarray(probs)
    _check(got, (JH.xywh_to_xyxy(bx), scores.max(-1), scores.argmax(-1)))


def test_all_scales_match_decode_scored(rng):
    """decode_fused == the plain path (heads.decode_scored + xyxy), in spec
    order, for the three yolov3-416 scales; and == the JAX decode_scored."""
    cfg = C.get_config("yolov3")
    dets = [(rng.standard_normal((1, g, g, 255), dtype=np.float32),
             S.Detect(m)) for g, m in ((13, (6, 7, 8)), (26, (3, 4, 5)),
                                      (52, (0, 1, 2)))]
    got = K.decode_fused([(torch.from_numpy(f), d) for f, d in dets], cfg)
    assert got[0].shape == (1, 10647, 4)
    boxes, scores, labels = TH.decode_scored(
        [(torch.from_numpy(f), d) for f, d in dets], cfg)
    _check(got, (TH.xywh_to_xyxy(boxes), scores, labels))
    jb, js, jl = JH.decode_scored([(jnp.asarray(f), JS.Detect(d.anchor_mask))
                                   for f, d in dets], JC.get_config("yolov3"))
    _check(got, (JH.xywh_to_xyxy(jb), js, jl))


def test_v1_head_raises():
    """The fused decode covers the v2 and v3 heads, in the TPU package too;
    the v1 head decodes through heads.decode_scored."""
    cfg = C.get_config("yolov1")
    dets = [(torch.zeros(1, 1470), S.Detect(()))]
    with pytest.raises(NotImplementedError, match="v2/v3 heads"):
        K.decode_fused(dets, cfg)
    with pytest.raises(NotImplementedError, match="v2/v3"):
        jax_decode_fused([(jnp.zeros((1, 1470)), JS.Detect(()))],
                         JC.get_config("yolov1"), interpret=True)
    assert TH.decode_scored(dets, cfg)[0].shape == (1, 98, 4)


V1_CASES = [dict(), dict(grid=3, boxes_per_cell=2, custom_classes=tuple("abcd")),
            dict(grid=5, boxes_per_cell=3, custom_classes=tuple("abcdefg"))]


def _v1_case(overrides, rng, batch=3):
    cfg = C.get_config("yolov1", **overrides)
    jcfg = JC.get_config("yolov1", **overrides)
    n = cfg.grid ** 2 * (cfg.num_classes + 5 * cfg.boxes_per_cell)
    return cfg, jcfg, rng.standard_normal((batch, n), dtype=np.float32)


@pytest.mark.parametrize("overrides", V1_CASES)
def test_decode_v1_matches_jax(overrides, rng):
    cfg, jcfg, pred = _v1_case(overrides, rng)
    want = JH.decode_v1(jnp.asarray(pred), jcfg)
    got = TH.decode_v1(torch.from_numpy(pred), cfg)
    n = cfg.grid ** 2 * cfg.boxes_per_cell
    assert got[0].shape == (3, n, 4) and got[2].shape == (3, n,
                                                          cfg.num_classes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("overrides", V1_CASES)
def test_v1_decode_scored_matches_jax(overrides, dtype, rng):
    """score = conf * the largest raw class value, label its index; a bf16
    head widens to float32 first in both packages."""
    cfg, jcfg, pred = _v1_case(overrides, rng)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = JH.decode_scored([(jnp.asarray(pred).astype(jdt), JS.Detect(()))],
                            jcfg)
    got = TH.decode_scored([(torch.from_numpy(pred).to(tdt), S.Detect(()))],
                           cfg)
    assert got[2].dtype == torch.int32
    _check(got, want)
    # and against the materialized form: conf * probs, max and argmax
    bx, conf, probs = TH.decode_v1(torch.from_numpy(pred).to(tdt), cfg)
    scores = conf[..., None] * probs
    np.testing.assert_array_equal(got[0].numpy(), bx.numpy())
    np.testing.assert_array_equal(got[2].numpy(), probs.argmax(-1).numpy())
    np.testing.assert_allclose(
        got[1].numpy(), torch.gather(
            scores, 2, got[2].long()[..., None])[..., 0].numpy(), **TOL)


@pytest.mark.parametrize("name", ["yolov2", "yolov2-tiny-voc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_region_head_matches_pallas_interpret(name, dtype, rng):
    """The softmax branch at the two region heads the port serves, f32 and
    bf16 inputs (both widen to float32 before any arithmetic)."""
    cfg, jcfg = C.get_config(name), JC.get_config(name)
    A, Cn = cfg.num_anchors, cfg.num_classes
    feat = rng.standard_normal((2, 13, 13, A * (5 + Cn)), dtype=np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    mask = tuple(range(A))
    want = jax_decode_fused([(jnp.asarray(feat).astype(jdt),
                              JS.Detect(mask))], jcfg, interpret=True)
    got = K.decode_fused([(torch.from_numpy(feat).to(tdt), S.Detect(mask))],
                         cfg)
    assert got[0].shape == (2, 845, 4)
    _check(got, want)
