"""The port's torch.export artifacts (yolo_tensorflow_tpu_torch/export.py)
on the CPU, against the port's live Detector and the JAX package's
artifacts (export.py), the cases of tests/test_export.py.

- Round trip: the loaded artifact's five outputs equal the live port
  Detector's bit for bit (the same operators run: on the CPU their plain
  versions), and the JAX artifact of the same parameters gives the same
  num and classes, boxes and scores within rtol 1e-4 / atol 1e-5 (float32
  conv sums in another order).
- The consumer (``ArtifactDetector``) on a hand-made head (zero weights,
  anchor 0 of every cell class 3 at score sigmoid(4) * softmax, the
  region head's): the hand-computed score and box width, and the JAX
  consumer's results (boxes within 1e-3 px).
- The CLI's ``detect --artifact`` and ``serve --watch --once``; the
  letterbox, int8 and int8 letterbox artifacts, each against the live
  Detector and the JAX artifact.
- The exported program calls the yolo_torch operators by name.
"""

import json

import numpy as np
import pytest
import torch

from yolo_tensorflow_tpu import export as JE
from yolo_tensorflow_tpu.pipeline import Detector as JaxDetector
from yolo_tensorflow_tpu_torch import cli
from yolo_tensorflow_tpu_torch import export as TE
from yolo_tensorflow_tpu_torch.io.weights import params_to_jax
from yolo_tensorflow_tpu_torch.ops import quant as TQ
from yolo_tensorflow_tpu_torch.pipeline import Detector

from torch_parity import folded_params, images, jax_model, model

TOL = dict(rtol=1e-4, atol=1e-5)
PX_TOL = dict(rtol=1e-4, atol=1e-3)
OPTS = dict(num_candidates=32, max_detections=5)
SCORE = 1 / (1 + np.exp(-4.0)) * np.exp(6.0) / (np.exp(6.0) + 3)


def _pair(name, params, size=64, **kw):
    cfg, specs = model(name, size)
    jcfg, jspecs = jax_model(name, size)
    return (Detector(cfg, params=params, specs=specs, device="cpu", **kw),
            JaxDetector(jcfg, params=params_to_jax(params), specs=jspecs,
                        **kw))


def _crafted(size=64):
    """Zero narrow-v2 weights and a head bias: anchor 0 of every cell
    predicts class 3, objectness logit 4 and class logit 6."""
    _, specs = model("narrow-v2", size)
    port, _ = folded_params(specs, size)
    port = {k: {n: np.zeros_like(v) for n, v in p.items()}
            for k, p in port.items()}
    head = max(port)
    port[head]["b"][4] = 4.0
    port[head]["b"][5 + 3] = 6.0
    return port


def _int8(name, seed, size=64):
    _, specs = model(name, size)
    port, _ = folded_params(specs, size, seed=seed)
    return TQ.quantize_params(specs, port, {k: 0.05 for k in port})


def _export_both(det, jdet, tmp_path, **kw):
    path, jpath = tmp_path / "port.ytt", tmp_path / "jax.ytt"
    TE.export_detector(det, str(path), **kw)
    JE.export_detector(jdet, str(jpath), **kw)
    return str(path), str(jpath)


def _assert_outputs(got, live, jax_out):
    """Artifact outputs: equal to the live port Detector's, and to the JAX
    artifact's in num and classes, boxes and scores within TOL."""
    for key, want in zip(got, live):
        assert np.array_equal(got[key].numpy(), want.numpy()), key
    j = {k: np.asarray(v) for k, v in jax_out.items()}
    np.testing.assert_array_equal(got["detected_num"].numpy(),
                                  j["detected_num"])
    np.testing.assert_array_equal(got["detected_classes"].numpy(),
                                  j["detected_classes"])
    np.testing.assert_array_equal(got["detected_valid"].numpy(),
                                  j["detected_valid"])
    for key in ("detected_boxes", "detected_scores"):
        np.testing.assert_allclose(got[key].numpy(), j[key], **TOL)
    assert int(j["detected_num"].sum()) > 0


def _assert_results(got, want, tol=PX_TOL):
    assert [r["class_id"] for r in got] == [r["class_id"] for r in want]
    assert [r["class"] for r in got] == [r["class"] for r in want]
    np.testing.assert_allclose(np.asarray([r["box"] for r in got]),
                               np.asarray([r["box"] for r in want]), **tol)
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], **TOL)


def test_export_roundtrip(tmp_path):
    _, specs = model("narrow", 64)
    port, _ = folded_params(specs, 64)
    det, jdet = _pair("narrow", port, conf_threshold=0.3, **OPTS)
    path, jpath = _export_both(det, jdet, tmp_path, batch_size=2)

    art = TE.LoadedArtifact(path)
    assert art.manifest["model"] == "narrow"
    assert art.manifest["framework"] == "yolo_tensorflow_tpu_torch"
    assert art.manifest["outputs"] == JE.LoadedArtifact(
        jpath).manifest["outputs"]
    assert art.input_shape == (2, 64, 64, 3)
    assert art.classes == ["a", "b", "c", "d"]
    imgs = images(2, 64, seed=0)
    _assert_outputs(art(imgs), det.detect_batch(imgs),
                    JE.LoadedArtifact(jpath)(imgs))
    called = {str(n.target) for n in art._program.graph.nodes
              if "yolo_torch" in str(n.target)}
    assert called == {"yolo_torch.decode.default", "yolo_torch.nms.default"}


def test_artifact_detector_consumer(tmp_path):
    """ArtifactDetector, the object_detect.py app: detects from the .ytt
    alone, pixel-space boxes on the original image."""
    det, jdet = _pair("narrow-v2", _crafted(), **OPTS)
    path, jpath = _export_both(det, jdet, tmp_path, batch_size=1)
    app = TE.ArtifactDetector(path)
    assert app.size == 64 and app.classes[3] == "d"
    img = np.full((100, 200, 3), 128, np.uint8)
    res = app.detect(img)
    assert len(res) == 5 and all(r["class"] == "d" for r in res)
    assert all(abs(r["score"] - SCORE) < 1e-5 for r in res)
    # anchor 0 of the region head: w = anchors[0][0] / grid of the image
    cfg, _ = model("narrow-v2", 64)
    x = torch.zeros((1, 3, 64, 64)).contiguous(
        memory_format=torch.channels_last)
    grid = det.network(x)[0][0].shape[1]
    want_w = cfg.anchors[0][0] / grid * 200
    assert abs(res[0]["box"][2] - res[0]["box"][0] - want_w) < 1e-3
    _assert_results(res, JE.ArtifactDetector(jpath).detect(img))


def test_cli_detect_artifact_and_serve(tmp_path, capsys):
    """detect --artifact and serve --watch --once run the consumer path,
    with the JAX CLI's results on the same artifact's parameters."""
    import cv2
    from yolo_tensorflow_tpu import cli as jcli
    det, jdet = _pair("narrow-v2", _crafted(), **OPTS)
    art, jart = _export_both(det, jdet, tmp_path, batch_size=1)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    cv2.imwrite(str(img_dir / "a.jpg"), np.full((80, 80, 3), 128, np.uint8))

    out_dir = tmp_path / "out"
    cli.main(["detect", "--artifact", art, str(img_dir / "a.jpg"),
              "--out-dir", str(out_dir), "--boxes-txt",
              str(tmp_path / "boxes.txt")])
    out = capsys.readouterr().out
    assert "d " in out and (out_dir / "detected_a.jpg").exists()
    jcli.main(["detect", "--artifact", jart, str(img_dir / "a.jpg"),
               "--out-dir", str(tmp_path / "jout"), "--boxes-txt",
               str(tmp_path / "jboxes.txt")])
    capsys.readouterr()
    assert ((tmp_path / "boxes.txt").read_text()
            == (tmp_path / "jboxes.txt").read_text())

    recs = []
    for mod, path in ((cli, art), (jcli, jart)):
        mod.main(["serve", "--artifact", path, "--watch", str(img_dir),
                  "--once", "--out-dir", str(tmp_path / "served")])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.strip()]
        recs.append(json.loads(lines[-1]))
    assert recs[0]["image"].endswith("a.jpg")
    assert recs[0]["detections"][0]["class"] == "d"
    assert (tmp_path / "served" / "detected_a.jpg").exists()
    _assert_results(recs[0]["detections"], recs[1]["detections"])


def test_letterbox_artifact_roundtrip(tmp_path):
    """A fused letterbox Detector exports the letterbox program: (canvas,
    sizes) in, original-pixel boxes out; the consumer equals the live
    fused Detector exactly (the letterbox of an image does not depend on
    its canvas) and the JAX consumer within PX_TOL; an image larger than
    the canvas is downscaled on the host and its boxes scaled back."""
    det, jdet = _pair("narrow-v2", _crafted(), letterbox=True, fused=True,
                      **OPTS)
    path, jpath = _export_both(det, jdet, tmp_path, batch_size=1,
                               canvas_size=128)
    app, japp = TE.ArtifactDetector(path), JE.ArtifactDetector(jpath)
    assert app.artifact.is_letterbox
    assert app.artifact.manifest["input"] == japp.artifact.manifest["input"]
    img = np.full((100, 90, 3), 128, np.uint8)
    frozen = app.detect(img)
    assert frozen and frozen == det.detect(img)
    _assert_results(frozen, japp.detect(img))
    big = np.full((300, 260, 3), 128, np.uint8)
    res = app.detect(big)
    assert res and all(r["class_id"] == 3 for r in res)
    assert max(v for r in res for v in r["box"]) <= 300.0
    _assert_results(res, japp.detect(big))


def test_int8_artifact_roundtrip(tmp_path):
    """int8 (w_q) parameters export through the same export_detector; the
    program calls the int8 conv operator and equals the live int8
    Detector, and the JAX int8 artifact in num and classes."""
    det, jdet = _pair("narrow-leaky", _int8("narrow-leaky", 3),
                      conf_threshold=0.05, **OPTS)
    path, jpath = _export_both(det, jdet, tmp_path, batch_size=2)
    art = TE.LoadedArtifact(path)
    imgs = images(2, 64, seed=1)
    _assert_outputs(art(imgs), det.detect_batch(imgs),
                    JE.LoadedArtifact(jpath)(imgs))
    assert any("yolo_torch.conv2d_int8" in str(n.target)
               for n in art._program.graph.nodes)


def test_int8_letterbox_artifact(tmp_path):
    """int8 and the fused letterbox compose in one artifact."""
    det, jdet = _pair("narrow-leaky", _int8("narrow-leaky", 5),
                      letterbox=True, fused=True, conf_threshold=0.05,
                      **OPTS)
    path, jpath = _export_both(det, jdet, tmp_path, batch_size=1,
                               canvas_size=128)
    app = TE.ArtifactDetector(path)
    assert app.artifact.is_letterbox
    img = np.random.default_rng(2).integers(0, 255, (90, 110, 3),
                                            dtype=np.uint8)
    frozen = app.detect(img)
    assert frozen and frozen == det.detect(img)
    _assert_results(frozen, JE.ArtifactDetector(jpath).detect(img))


def test_letterbox_artifact_needs_sizes(tmp_path):
    det, _ = _pair("narrow-v2", _crafted(), letterbox=True, fused=True,
                   **OPTS)
    path = tmp_path / "lb.ytt"
    TE.export_detector(det, str(path), batch_size=1, canvas_size=128)
    with pytest.raises(ValueError, match="sizes"):
        TE.LoadedArtifact(str(path))(np.zeros((1, 128, 128, 3), np.uint8))
