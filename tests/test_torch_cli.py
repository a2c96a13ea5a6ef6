"""The port's command line (yolo_tensorflow_tpu_torch/cli.py) through
``cli.main(argv)`` with ``--device cpu``, against the JAX package's CLI on
the same files: a narrow v3 net from a darknet .cfg (both packages'
``config_from_cfg``) with seeded .weights, and yolov3-tiny at 64 for
``quantize`` (which takes a registry model).

- convert: the same .npz keys and layout (the TPU package's), arrays
  within rtol 1e-6 (BN folded in float32 in both); each CLI reads the
  other's .npz.
- detect (--boxes-txt), stream (frames counted, annotated frames written),
  export (the artifacts' outputs): the same num and classes, boxes and
  scores within the boxes.txt's one decimal, or rtol 1e-4 / atol 1e-5.
- quantize: the same int8 weights and weight scales exactly, activation
  scales within rtol 1e-4 (percentiles of float32 activations).
- serve-http: the fused letterbox Detector and the server options reach
  serve_http, and a .npy request (``--body npy``) is answered as the
  Detector answers it (bit for bit with oneDNN's batch-dependent CPU conv
  off, ``torch_parity.batch_invariant_conv``).
"""

import io
import json
import os
import threading
import urllib.request

import cv2
import numpy as np
import pytest

from yolo_tensorflow_tpu import cli as jcli
from yolo_tensorflow_tpu.export import LoadedArtifact as JaxArtifact
from yolo_tensorflow_tpu_torch import cli
from yolo_tensorflow_tpu_torch.export import LoadedArtifact
from yolo_tensorflow_tpu_torch.io import cfg as TCfg

from torch_parity import batch_invariant_conv, images, model, write_weights

SIZE = 64
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg, specs = model("narrow-leaky", SIZE)
    (root / "narrow.cfg").write_text(TCfg.specs_to_cfg(cfg, specs))
    (root / "narrow.names").write_text("a\nb\nc\nd\n")
    write_weights(specs, SIZE, str(root / "narrow.weights"), seed=4)
    imgs = root / "imgs"
    imgs.mkdir()
    for i, (h, w) in enumerate(((64, 64), (48, 80), (90, 70))):
        img = cv2.resize(images(1, 8, seed=20 + i)[0], (w, h),
                         interpolation=cv2.INTER_LINEAR)
        cv2.imwrite(str(imgs / f"im{i}.png"), img[..., ::-1])
    return root


def _model_args(files, weights=None):
    return ["--cfg", str(files / "narrow.cfg"), "--names",
            str(files / "narrow.names"), "--weights",
            str(weights or files / "narrow.weights"), "--conf-threshold",
            "0.2"]


def _both(argv_port, argv_jax=None):
    cli.main(argv_port + ["--device", "cpu"])
    jcli.main(argv_jax if argv_jax is not None else argv_port)


def _boxes_txt(path):
    rows = [ln.split(",") for ln in open(path).read().splitlines()]
    return [r[0] for r in rows], np.asarray([[float(v) for v in r[1:]]
                                             for r in rows])


def test_convert_matches_jax(files, tmp_path):
    args = _model_args(files)
    _both(["convert", *args, "--out", str(tmp_path / "port.npz")],
          ["convert", *args, "--out", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path /
                                                      "jax.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].shape == j[k].shape, k
            np.testing.assert_allclose(p[k], j[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("weights", ["narrow.weights", "jax.npz"])
def test_detect_matches_jax(files, tmp_path, capsys, weights):
    """detect on three image files, from .weights and from an .npz the JAX
    CLI wrote: the port's boxes.txt against the JAX CLI's."""
    if weights == "jax.npz":
        jcli.main(["convert", *_model_args(files), "--out",
                   str(tmp_path / "jax.npz")])
    args = _model_args(files, (tmp_path / weights if weights == "jax.npz"
                               else None))
    paths = sorted(str(p) for p in (files / "imgs").iterdir())
    _both(["detect", *args, *paths, "--out-dir", str(tmp_path / "po"),
           "--boxes-txt", str(tmp_path / "port.txt")],
          ["detect", *args, *paths, "--out-dir", str(tmp_path / "jo"),
           "--boxes-txt", str(tmp_path / "jax.txt")])
    out = capsys.readouterr().out
    assert out.count("objects in") == 6
    names, got = _boxes_txt(tmp_path / "port.txt")
    jnames, want = _boxes_txt(tmp_path / "jax.txt")
    assert names == jnames and len(names) > 0
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=0.1 + 1e-6)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-4 + 1e-9)
    assert len(os.listdir(tmp_path / "po")) == 3


def test_stream_matches_jax(files, tmp_path, capsys):
    """stream over the image directory (resized to the input size), with
    annotated frames written: the same frame count as the JAX CLI."""
    args = _model_args(files)
    src = str(files / "imgs")
    _both(["stream", *args, "--source", src, "--batch", "2", "--save-dir",
           str(tmp_path / "ps"), "--avg-frames", "3"],
          ["stream", *args, "--source", src, "--batch", "2", "--save-dir",
           str(tmp_path / "js"), "--avg-frames", "3"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "frames in" in ln]
    assert len(lines) == 2
    assert all(ln.startswith("3 frames in") for ln in lines)
    assert sorted(os.listdir(tmp_path / "ps")) == sorted(
        os.listdir(tmp_path / "js"))


def test_stream_npy_frames(files, tmp_path, capsys):
    d = tmp_path / "npy"
    d.mkdir()
    for i, img in enumerate(images(3, SIZE, seed=9)):
        np.save(str(d / f"{i}.npy"), img)
    cli.main(["stream", *_model_args(files), "--source", str(d),
              "--npy-frames", "--batch", "2", "--device", "cpu"])
    assert "3 frames in" in capsys.readouterr().out


@pytest.mark.parametrize("fused", [False, True])
def test_export_matches_jax(files, tmp_path, capsys, fused):
    args = _model_args(files)
    extra = (["--letterbox", "--fused-letterbox", "--canvas-size", "128"]
             if fused else [])
    _both(["export", *args, *extra, "--batch", "2", "--out",
           str(tmp_path / "port.ytt")],
          ["export", *args, *extra, "--batch", "2", "--out",
           str(tmp_path / "jax.ytt")])
    art = LoadedArtifact(str(tmp_path / "port.ytt"))
    jart = JaxArtifact(str(tmp_path / "jax.ytt"))
    assert art.manifest["input"] == jart.manifest["input"]
    assert art.device.type == "cpu"
    if fused:
        canvas = np.zeros((2, 128, 128, 3), np.uint8)
        canvas[0, :100, :70] = images(1, 128, seed=3)[0][:100, :70]
        canvas[1, :50, :120] = images(1, 128, seed=4)[0][:50, :120]
        inputs = (canvas, np.asarray([[100, 70], [50, 120]], np.int32))
    else:
        inputs = (images(2, SIZE, seed=3),)
    got, want = art(*inputs), jart(*inputs)
    for key in ("detected_num", "detected_classes", "detected_valid"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("detected_boxes", "detected_scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL, err_msg=key)
    assert int(got["detected_num"].sum()) > 0


def test_quantize_matches_jax(tmp_path, capsys):
    cfg, specs = model("yolov3-tiny", SIZE)
    weights = str(tmp_path / "tiny.weights")
    write_weights(specs, SIZE, weights, seed=2)
    calib = tmp_path / "calib"
    calib.mkdir()
    for i, img in enumerate(images(2, SIZE, seed=5)):
        cv2.imwrite(str(calib / f"c{i}.png"), img[..., ::-1])
    base = ["quantize", "--model", "yolov3-tiny", "--weights", weights,
            "--calib-dir", str(calib), "--input-size", str(SIZE)]
    _both(base + ["--out", str(tmp_path / "port.npz")],
          base + ["--out", str(tmp_path / "jax.npz")])
    out = capsys.readouterr().out
    assert out.count("int8 convs") == 2
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path /
                                                      "jax.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        assert any(k.endswith("/w_q") for k in j.files)
        for k in j.files:
            if k.endswith(("/w_q", "/s_w")):
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
            else:
                np.testing.assert_allclose(p[k], j[k], rtol=1e-4,
                                           err_msg=k)


def test_serve_http_wiring(files, monkeypatch):
    """serve-http builds the fused letterbox Detector and hands the
    server its options; run with them, a .npy request is answered as the
    Detector answers it."""
    from yolo_tensorflow_tpu_torch import server
    seen = {}
    monkeypatch.setattr(server, "serve_http",
                        lambda det, **kw: seen.update(det=det, **kw))
    cli.main(["serve-http", *_model_args(files), "--device", "cpu",
              "--port", "0", "--host", "127.0.0.1", "--batch", "2",
              "--queue-depth", "5", "--max-body-mb", "1", "--body", "npy"])
    det = seen.pop("det")
    assert det.fused and det.device.type == "cpu"
    assert seen["decode_fn"] is cli.decode_npy
    assert (seen["batch_size"], seen["queue_depth"],
            seen["max_body_bytes"]) == (2, 5, 1 << 20)
    monkeypatch.undo()
    ready = threading.Event()
    httpd, batcher = server.serve_http(det, ready_event=ready, **seen)
    try:
        assert ready.wait(5)
        img = images(1, 90, seed=8)[0][:70]
        buf = io.BytesIO()
        np.save(buf, img)
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/detect",
            data=buf.getvalue(), method="POST")
        with batch_invariant_conv():
            with urllib.request.urlopen(req, timeout=30) as r:
                got = json.loads(r.read())["detections"]
            assert got == json.loads(json.dumps(det.detect(img)))
    finally:
        httpd.shutdown()
        batcher.close()
