"""Port Detector (yolo_tensorflow_tpu_torch/pipeline.py) on the CPU vs the
JAX package's Detector.detect_batch, on the same seeded weights and images:
num and classes equal, boxes and scores at rtol 1e-4 / atol 1e-5 (float32
conv sums in different orders). The JAX side runs its default XLA decode,
which tests/test_pallas_decode.py pins to its Pallas kernel. The region (v2:
Reorg, softmax classes) and grid (v1: connected head, symmetric
normalization, heads.decode_scored in place of the fused decode) families
run narrow specs of their own through the same comparison. The fused
letterbox path (``detect_batch_fused``, and ``detect`` through it) runs the
narrow v3, v2 and v1 specs and int8 params on canvases of mixed image sizes
against the JAX Detector's: boxes are then in pixels, held at atol 1e-3 as
``detect``'s are.

Int8 (w8a8) Detectors get the JAX package's quantized params through
``params_from_jax``: at f32 the same tolerances hold. At bf16 every conv is
quantized (heads too), so the networks agree bit for bit and only the
decode differs: the JAX Detector decodes the bf16 heads partly in bf16, the
port in f32, hence boxes and scores at atol 2**-8 (one bf16 ulp in
[0.5, 1)). With float bf16 convs left in, a one-ulp difference there (the
bias is rounded to bf16 before the add in PyTorch, after it in XLA) can move
the next conv's quantized input by a whole step, which no tolerance on the
detections bounds; tests/test_torch_engine.py holds that case on the raw
heads instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tensorflow_tpu.io import weights as JW
from yolo_tensorflow_tpu.pipeline import Detector as JaxDetector
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
from yolo_tensorflow_tpu_torch.pipeline import Detector

from torch_parity import (folded_params, images, jax_int8_params, jax_model,
                          model, write_weights)

SIZE = 64
OPTS = dict(conf_threshold=0.3, num_candidates=64)


@pytest.fixture(scope="module", params=["narrow", "yolov3-tiny", "narrow-v2",
                                        "narrow-v1"])
def case(request, tmp_path_factory):
    """(port cfg, port specs, weights path, JAX params, images, JAX
    Detections by class_aware_nms)."""
    cfg, specs = model(request.param, SIZE)
    jcfg, jspecs = jax_model(request.param, SIZE)
    path = tmp_path_factory.mktemp("w") / "m.weights"
    write_weights(specs, SIZE, path)
    params, _, _ = JW.load_darknet_weights(jspecs, SIZE, str(path),
                                           bn_eps=jcfg.bn_eps)
    imgs = images(2, SIZE)
    want = {aware: JaxDetector(jcfg, params=params, specs=jspecs,
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


@pytest.mark.parametrize("name", ["narrow", "yolov3-tiny"])
def test_int8_detect_batch_matches_jax(name):
    """f32 epilogue (compute_dtype None): the parity mode."""
    cfg, specs, jcfg, jspecs, qparams = jax_int8_params(name, SIZE)
    imgs = images(2, SIZE)
    want = JaxDetector(jcfg, params=qparams, specs=jspecs,
                       **OPTS).detect_batch(imgs)
    det = Detector(cfg, params=TW.params_from_jax(qparams), specs=specs,
                   device="cpu", **OPTS)
    before = Q8.launches, K.launches
    got = det.detect_batch(imgs)
    assert (Q8.launches, K.launches) == before
    _check_detections(got, want, rtol=1e-4, atol=1e-5)


def test_int8_detect_batch_bf16_matches_jax():
    """bf16 serving, every conv quantized (module docstring)."""
    cfg, specs, jcfg, jspecs, qparams = jax_int8_params(
        "yolov3-tiny", SIZE, quantize_heads=True)
    imgs = images(2, SIZE)
    want = JaxDetector(jcfg, params=qparams, specs=jspecs,
                       compute_dtype=jnp.bfloat16, **OPTS).detect_batch(imgs)
    got = Detector(cfg, params=TW.params_from_jax(qparams), specs=specs,
                   device="cpu", compute_dtype=torch.bfloat16,
                   **OPTS).detect_batch(imgs)
    _check_detections(got, want, rtol=0, atol=2 ** -8)


def test_cuda_detector_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        Detector("yolov3-tiny", params={}, device="cuda")


@pytest.mark.parametrize("options", [{"mesh": True}, {"donate": True}],
                         ids=["mesh", "donate"])
def test_unported_options_raise(options):
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1"):
        Detector("yolov3-tiny", params={}, device="cpu", **options)


@pytest.mark.parametrize("options", [
    {"letterbox": True, "fused": True, "tta": True}, {"tta": True}],
    ids=["fused", "tta"])
def test_tta_options_run(options):
    """TTA, which raised before it was ported, on both paths: Detections of
    the narrow v3 model that differ from the detections without it
    (tests/test_torch_tta.py holds them to the JAX package)."""
    cfg, specs = model("narrow", SIZE)
    det = [Detector(cfg, params=folded_params(specs, SIZE)[0], specs=specs,
                    device="cpu", **dict(options, tta=t), **FUSED_OPTS)
           for t in (True, False)]
    if options.get("fused"):
        canvas, sizes = _canvas(FUSED_SIZES)
        got, plain = (d.detect_batch_fused(canvas, sizes) for d in det)
    else:
        got, plain = (d.detect_batch(images(2, SIZE)) for d in det)
    assert (got.num > 0).all() and got.boxes.shape == plain.boxes.shape
    assert not torch.equal(got.scores, plain.scores)


def test_needs_weights_or_params():
    with pytest.raises(ValueError, match="weights_path or params"):
        Detector("yolov3-tiny", device="cpu")


def test_detect_matches_jax(case):
    """detect(): one image of another size, host-resized, pixel boxes."""
    cfg, specs, path, params, _, _ = case
    jcfg, jspecs = jax_model(cfg.name, SIZE)
    image = images(1, 90, seed=5)[0, :, :70]
    want = JaxDetector(jcfg, params=params, specs=jspecs,
                       **OPTS).detect(image)
    got = Detector(cfg, str(path), specs=specs, device="cpu",
                   **OPTS).detect(image)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["class_id"], g["class"]) == (w["class_id"], w["class"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(g["box"], w["box"], rtol=1e-4, atol=1e-3)


# ------------------------------------------------------ the fused letterbox

CANVAS = 128
# mixed image sizes in one canvas bucket: wide, tall, filling the canvas,
# odd pads (a 1x1 image is a flat input, whose equal scores tie: the
# letterbox tests cover it)
FUSED_SIZES = [(40, 100), (100, 40), (128, 128), (37, 91)]
PIXEL_TOL = dict(rtol=1e-4, atol=1e-3)
# a lower threshold than OPTS's: every image of every narrow model detects
FUSED_OPTS = dict(OPTS, conf_threshold=0.1)


def _canvas(sizes, seed=7):
    """Seeded images of the given sizes in zeroed canvases."""
    rng = np.random.default_rng(seed)
    canvas = np.zeros((len(sizes), CANVAS, CANVAS, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        canvas[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return canvas, np.asarray(sizes, np.int32)


@pytest.fixture(scope="module", params=["narrow", "narrow-v2", "narrow-v1",
                                        "int8"])
def fused_case(request):
    """(port Detector kwargs, JAX Detector, canvas, sizes, JAX Detections)
    of the fused letterbox path."""
    name = request.param
    if name == "int8":
        cfg, specs, jcfg, jspecs, jparams = jax_int8_params("narrow", SIZE)
    else:
        cfg, specs = model(name, SIZE)
        jcfg, jspecs = jax_model(name, SIZE)
        jparams = folded_params(specs, SIZE)[1]
    jax_det = JaxDetector(jcfg, params=jparams, specs=jspecs, letterbox=True,
                          fused=True, **FUSED_OPTS)
    canvas, sizes = _canvas(FUSED_SIZES)
    want = jax_det.detect_batch_fused(canvas, sizes)
    port = dict(model=cfg, params=TW.params_from_jax(jparams), specs=specs,
                device="cpu", letterbox=True, fused=True, **FUSED_OPTS)
    return port, jax_det, canvas, sizes, want


@pytest.mark.parametrize("sizes_as", ["numpy", "tensor"])
def test_detect_batch_fused_matches_jax(fused_case, sizes_as):
    port, _, canvas, sizes, want = fused_case
    det = Detector(**port)
    if sizes_as == "tensor":
        sizes = torch.as_tensor(sizes, dtype=torch.int64)
    before = K.launches, NK.launches
    got = det.detect_batch_fused(canvas, sizes)
    assert (K.launches, NK.launches) == before
    # boxes are in pixels of images up to 128 wide
    _check_detections(got, want, **PIXEL_TOL)
    assert (got.boxes[..., 2] <= torch.as_tensor(sizes)[:, 1, None]).all()


def test_detect_fused_matches_jax(fused_case):
    """detect() on the fused path: one image, letterboxed on the device
    (no cv2), pixel boxes."""
    port, jax_det, _, _, _ = fused_case
    image = np.random.default_rng(5).integers(0, 256, (90, 70, 3),
                                              dtype=np.uint8)
    want = jax_det.detect(image)
    got = Detector(**port).detect(image)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["class_id"], g["class"]) == (w["class_id"], w["class"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(g["box"], w["box"], **PIXEL_TOL)


def test_fused_letterbox_dtype_defaults():
    """bf16 letterbox where the model computes narrow, as in the TPU
    package; f32 for f32 float params; an explicit choice stands."""
    cfg, specs = model("narrow", SIZE)
    params = folded_params(specs, SIZE)[0]
    kw = dict(params=params, specs=specs, device="cpu", letterbox=True,
              fused=True)
    assert Detector(cfg, **kw).letterbox_dtype is None
    assert Detector(cfg, compute_dtype=torch.bfloat16,
                    **kw).letterbox_dtype == torch.bfloat16
    assert Detector(cfg, compute_dtype=torch.bfloat16,
                    letterbox_dtype=torch.float32,
                    **kw).letterbox_dtype == torch.float32
    qparams = TW.params_from_jax(jax_int8_params("narrow", SIZE)[-1])
    assert Detector(cfg, **dict(kw, params=qparams)).letterbox_dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="letterbox=True, fused=True"):
        Detector(cfg, params=params, specs=specs,
                 device="cpu").detect_batch_fused(*_canvas([(8, 8)]))
