"""Port evaluation (eval/batched.py, eval/map.py, the host letterbox and
``detect_from_file`` of pipeline.Detector) on the CPU vs the JAX package's,
on the same seeded weights and image files.

- ``evaluate_samples`` on the narrow v3 and v2 nets in each of the
  Detector's three preprocessing branches (stretch, host letterbox, fused
  letterbox), seven images of mixed sizes in batches of three (the tail
  padded): per image the same number of detections and classes, boxes (in
  units of the image's width and height: float32 convs summed in another
  order) and scores within rtol 1e-5 / atol 1e-5, the ground truth equal,
  and ``evaluate_detections`` of each package on its own detections the
  same mAP and APs. The ground truth is made from jittered JAX detections,
  so that the mAP is no trivial 0. The port reads the fused branch's
  images through ``read_fn`` (.npy files), the others through ``read_rgb``
  (cv2), as the JAX package does.
- The batched results equal the serial ``Detector.detect``'s, and
  ``detect_from_file``'s, in every branch, bit for bit, with oneDNN's CPU
  convolution off (``torch_parity.batch_invariant_conv``): on an AVX-512
  CPU oneDNN sums an image's products in another order at batch 3 than at
  batch 1 (from the first layer on; the boxes then differ by up to 1.1e-5
  px), which ``test_onednn_conv_batch_dependence`` records.
- The host letterbox ``Detector.detect`` equals the JAX Detector's.
"""

import os

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolo_tensorflow_tpu.eval import batched as JB
from yolo_tensorflow_tpu.eval import map as JM
from yolo_tensorflow_tpu.pipeline import Detector as JaxDetector
from yolo_tensorflow_tpu_torch.data.datasets import Sample
from yolo_tensorflow_tpu_torch.eval import batched as TB
from yolo_tensorflow_tpu_torch.eval import map as TM
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
from yolo_tensorflow_tpu_torch.pipeline import Detector

from torch_parity import (batch_invariant_conv, folded_params, jax_model,
                          model)

SIZE = 64
# seeded softmax scores of the region head stay low: a lower threshold
CONF = {"narrow": 0.3, "narrow-v2": 0.1}
IMAGE_SIZES = ((64, 64), (48, 80), (100, 60), (37, 91), (120, 120),
               (70, 50), (64, 33))
BRANCHES = {"stretch": {}, "letterbox": {"letterbox": True},
            "fused": {"letterbox": True, "fused": True}}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Seeded RGB images as PNG files (lossless) and .npy twins."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(11)
    paths = []
    for i, (h, w) in enumerate(IMAGE_SIZES):
        # smooth, so that the narrow nets see structure and not noise
        img = cv2.resize(rng.integers(0, 256, (6, 6, 3), dtype=np.uint8),
                         (w, h), interpolation=cv2.INTER_LINEAR)
        path = str(root / f"img{i}.png")
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        np.save(path[:-4] + ".npy", img)
        paths.append(path)
    return paths


def read_npy(path):
    return np.load(os.path.splitext(path)[0] + ".npy")


def _detectors(name, branch):
    cfg, specs = model(name, SIZE)
    jcfg, jspecs = jax_model(name, SIZE)
    port, jaxp = folded_params(specs, SIZE)
    kw = dict(conf_threshold=CONF[name], num_candidates=64,
              **BRANCHES[branch])
    return (Detector(cfg, params=port, specs=specs, device="cpu", **kw),
            JaxDetector(jcfg, params=jaxp, specs=jspecs, **kw))


def _samples(paths, results, rng):
    """Samples whose ground truth is each image's first JAX detections,
    jittered by up to 10 % of the box and relabelled now and then."""
    samples = []
    for path, res, (h, w) in zip(paths, results, IMAGE_SIZES):
        rows = []
        for r in res[:4]:
            x0, y0, x1, y1 = r["box"]
            bw, bh = max(x1 - x0, 1.0), max(y1 - y0, 1.0)
            cx = (x0 + x1) / 2 + rng.uniform(-0.1, 0.1) * bw
            cy = (y0 + y1) / 2 + rng.uniform(-0.1, 0.1) * bh
            cls = r["class_id"] if rng.random() < 0.8 else 0
            rows.append([cx / w, cy / h, bw / w, bh / h, cls])
        samples.append(Sample(path, np.asarray(rows, np.float32).reshape(
            -1, 5)))
    return samples


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("name", ["narrow", "narrow-v2"])
def test_evaluate_samples_matches_jax(name, branch, image_files):
    det, jdet = _detectors(name, branch)
    first, _ = JB.detect_paths(jdet, image_files, batch_size=3)
    samples = _samples(image_files, first, np.random.default_rng(5))
    want = JB.evaluate_samples(jdet, samples, batch_size=3)
    read_fn = read_npy if branch == "fused" else TB.read_rgb
    before = K.launches
    got = TB.evaluate_samples(det, samples, batch_size=3, read_fn=read_fn)
    assert K.launches == before
    (dets, gts, results, sizes), (jdets, jgts, jresults, jsizes) = got, want
    assert sizes == jsizes == list(IMAGE_SIZES)
    assert sum(len(r) for r in results) > len(IMAGE_SIZES)
    for i, (r, jr) in enumerate(zip(results, jresults)):
        assert len(r) == len(jr), i
        assert [d["class_id"] for d in r] == [d["class_id"] for d in jr]
        assert [d["class"] for d in r] == [d["class"] for d in jr]
    for d, jd, (h, w) in zip(dets, jdets, sizes):
        np.testing.assert_array_equal(d["classes"], jd["classes"])
        extent = np.asarray([w, h, w, h], np.float32)
        np.testing.assert_allclose(d["boxes"] / extent, jd["boxes"] / extent,
                                   **TOL)
        np.testing.assert_allclose(d["scores"], jd["scores"], **TOL)
    for g, jg in zip(gts, jgts):
        np.testing.assert_array_equal(g["classes"], jg["classes"])
        np.testing.assert_array_equal(g["boxes"], jg["boxes"])
    m = TM.evaluate_detections(dets, gts, det.cfg.num_classes)
    jm = JM.evaluate_detections(jdets, jgts, jdet.cfg.num_classes)
    assert m["map"] == jm["map"] and 0 < m["map"] <= 1
    assert m["num_classes_evaluated"] == jm["num_classes_evaluated"]
    np.testing.assert_array_equal(m["ap_per_class"], jm["ap_per_class"])


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_batched_equals_serial_detect(branch, image_files):
    det, _ = _detectors("narrow", branch)
    with batch_invariant_conv():
        _batched_equals_serial(det, image_files)


def _batched_equals_serial(det, image_files):
    results, sizes = TB.detect_paths(det, image_files, batch_size=3,
                                     num_workers=2)
    assert sizes == list(IMAGE_SIZES)
    imgs = [TB.read_rgb(p) for p in image_files]
    assert TB.detect_images(det, imgs, batch_size=4) == results
    for path, img, res in zip(image_files, imgs, results):
        for serial in (det.detect(img), det.detect_from_file(path)):
            assert [d["class_id"] for d in serial] == [d["class_id"]
                                                       for d in res]
            np.testing.assert_array_equal(
                np.asarray([d["box"] for d in serial]).reshape(-1, 4),
                np.asarray([d["box"] for d in res]).reshape(-1, 4))


def test_onednn_conv_batch_dependence():
    """Why the batching tests turn oneDNN off: PyTorch's oneDNN CPU
    convolution may give an image other bits at batch 4 than at batch 1
    (measured on an AVX-512 CPU, torch 2.13, on these inputs: 2.9e-6 in
    NCHW and 2.4e-6 in channels-last at Cin = 3, 1.9e-5 at Cin = 16; one
    thread or ONEDNN_MAX_CPU_ISA=AVX2 leaves it), and only where oneDNN runs
    it; with it off the convolution is batch invariant, bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(4, 3, 64, 64, generator=g)
    w = torch.randn(8, 3, 3, 3, generator=g)

    def gap():
        full = F.conv2d(x, w, padding=1)
        one = torch.cat([F.conv2d(x[i:i + 1], w, padding=1)
                         for i in range(4)])
        return float((full - one).abs().max())

    default = gap()
    with batch_invariant_conv():
        assert gap() == 0.0
    assert default == 0.0 or torch.backends.mkldnn.is_available()
    assert default < 1e-5


def test_host_letterbox_detect_matches_jax(image_files):
    det, jdet = _detectors("narrow", "letterbox")
    n = 0
    for path in image_files:
        got, want = det.detect_from_file(path), jdet.detect_from_file(path)
        assert [d["class_id"] for d in got] == [d["class_id"] for d in want]
        n += len(got)
        h, w = IMAGE_SIZES[image_files.index(path)]
        extent = np.asarray([w, h, w, h], np.float32)
        np.testing.assert_allclose(
            np.asarray([d["box"] for d in got], np.float32).reshape(-1, 4)
            / extent,
            np.asarray([d["box"] for d in want], np.float32).reshape(-1, 4)
            / extent,
            **TOL)
        np.testing.assert_allclose(
            np.asarray([d["score"] for d in got], np.float32),
            np.asarray([d["score"] for d in want], np.float32), **TOL)
    assert n > 0


def test_empty_and_missing_inputs():
    det, _ = _detectors("narrow", "stretch")
    assert TB.detect_images(det, []) == []
    assert TB.evaluate_samples(det, []) == ([], [], [], [])
    with pytest.raises(FileNotFoundError):
        TB.read_rgb("/nonexistent/image.png")
