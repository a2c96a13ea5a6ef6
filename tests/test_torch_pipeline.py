"""Port Detector (yolo_tensorflow_tpu_torch/pipeline.py) on the CPU vs the
JAX package's Detector.detect_batch, on the same seeded weights and images:
num and classes equal, boxes and scores at rtol 1e-4 / atol 1e-5 (float32
conv sums in different orders). The JAX side runs its default XLA decode,
which tests/test_pallas_decode.py pins to its Pallas kernel."""

import numpy as np
import pytest
import torch

from yolo_tensorflow_tpu.io import weights as JW
from yolo_tensorflow_tpu.pipeline import Detector as JaxDetector
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
from yolo_tensorflow_tpu_torch.pipeline import Detector

from torch_parity import images, model, write_weights

SIZE = 64
OPTS = dict(conf_threshold=0.3, num_candidates=64)


@pytest.fixture(scope="module", params=["narrow", "yolov3-tiny"])
def case(request, tmp_path_factory):
    """(cfg, specs, weights path, JAX params, images, JAX Detections by
    class_aware_nms)."""
    cfg, specs = model(request.param, SIZE)
    path = tmp_path_factory.mktemp("w") / "m.weights"
    write_weights(specs, SIZE, path)
    params, _, _ = JW.load_darknet_weights(specs, SIZE, str(path),
                                           bn_eps=cfg.bn_eps)
    imgs = images(2, SIZE)
    want = {aware: JaxDetector(cfg, params=params, specs=specs,
                               class_aware_nms=aware,
                               **OPTS).detect_batch(imgs)
            for aware in (False, True)}
    return cfg, specs, path, params, imgs, want


@pytest.mark.parametrize("class_aware_nms", [False, True])
@pytest.mark.parametrize("source", ["params", "weights"])
def test_detect_batch_matches_jax(case, class_aware_nms, source):
    cfg, specs, path, params, imgs, want = case
    want = want[class_aware_nms]
    opts = dict(OPTS, class_aware_nms=class_aware_nms)
    if source == "params":
        det = Detector(cfg, params=TW.params_from_jax(params), specs=specs,
                       device="cpu", **opts)
    else:
        det = Detector(cfg, str(path), specs=specs, device="cpu", **opts)
    before = K.launches
    got = det.detect_batch(imgs)
    assert K.launches == before
    assert (got.num > 0).all()
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_cuda_detector_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        Detector("yolov3-tiny", params={}, device="cuda")


@pytest.mark.parametrize("option", ["letterbox", "fused", "tta", "mesh",
                                    "donate"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Detector("yolov3-tiny", params={}, device="cpu", **{option: True})


def test_needs_weights_or_params():
    with pytest.raises(ValueError, match="weights_path or params"):
        Detector("yolov3-tiny", device="cpu")


def test_detect_matches_jax(case):
    """detect(): one image of another size, host-resized, pixel boxes."""
    cfg, specs, path, params, _, _ = case
    image = images(1, 90, seed=5)[0, :, :70]
    want = JaxDetector(cfg, params=params, specs=specs, **OPTS).detect(image)
    got = Detector(cfg, str(path), specs=specs, device="cpu",
                   **OPTS).detect(image)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["class_id"], g["class"]) == (w["class_id"], w["class"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(g["box"], w["box"], rtol=1e-4, atol=1e-3)
