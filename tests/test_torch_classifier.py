"""Port classifier (pipeline.Classifier, eval/classify.py,
ops/preprocess.resize_device_batch) on the CPU vs the JAX package's, on the
same seeded weights and images.

- ``resize_device`` (darknet's stretch resize_image on the device) against
  the JAX package's jitted, vmapped ``resize_device``: bit for bit in
  bfloat16 at every shape, and in float32 at the output widths where XLA's
  CPU program sums the row pass's two weighted terms with one fma, as the
  port always does (widths that are multiples of 64: 64, 128, 256). At
  other widths (33, 96, 224, 288) that program adds the two products
  rounded apart in some columns, a choice of its dot code generation, and
  the port stays within 1 ulp of it there.
- Every ``Classifier`` mode (single / center crop, crop / stretch, 10crop,
  full, full with snap32, multi) on the narrow darknet19-style classifier:
  probabilities within 1e-5 of the JAX Classifier's, the top 5 equal;
  ``classify`` and ``classify_batch`` too; int8 params in the crop mode.
- ``validate_classifier`` over image files: the same result dicts, images
  read through ``read_fn`` on the port's side; ``read_validation_list``,
  ``topk_indices`` and ``snap_shape_32`` equal.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tensorflow_tpu.eval import classify as JV
from yolo_tensorflow_tpu.ops import preprocess as JP
from yolo_tensorflow_tpu.ops import quant as JQ
from yolo_tensorflow_tpu.pipeline import Classifier as JaxClassifier
from yolo_tensorflow_tpu_torch.eval import classify as TV
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.ops import preprocess as TP
from yolo_tensorflow_tpu_torch.pipeline import Classifier

from torch_parity import folded_params, images, jax_model, model

SIZE = 32
IMAGE_SIZES = ((40, 60), (64, 48), (33, 33), (90, 50), (32, 100))
TOL = dict(rtol=1e-5, atol=1e-5)


def _canvases(seed=0, n=5, side=256):
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    sizes = np.asarray([[200, 150], [1, 1], [256, 256], [17, 240],
                        [100, 3]][:n], np.int32)
    return canvas, sizes


def _jax_resize(canvas, sizes, oh, ow, **kw):
    fn = jax.jit(lambda c, s: jax.vmap(lambda cc, ss: JP.resize_device(
        cc, ss[0], ss[1], oh, ow, **kw))(c, s))
    return np.asarray(fn(jnp.asarray(canvas), jnp.asarray(sizes))
                      .astype(jnp.float32))


def _port_resize(canvas, sizes, oh, ow, **kw):
    got = TP.resize_device_batch(torch.as_tensor(canvas),
                                 torch.as_tensor(sizes), oh, ow, **kw)
    assert got.shape == (len(canvas), 3, oh, ow)
    assert got.is_contiguous(memory_format=torch.channels_last)
    return got.permute(0, 2, 3, 1).float().numpy()


FOLDS = [dict(), dict(rescale=2.0, offset=-1.0), dict(rescale=255 / 225)]


@pytest.mark.parametrize("fold", range(len(FOLDS)))
@pytest.mark.parametrize("oh,ow", [(64, 64), (96, 64), (32, 128),
                                   (300, 256), (1, 64)])
def test_resize_device_bit_for_bit(oh, ow, fold):
    canvas, sizes = _canvases()
    for tdt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        got = _port_resize(canvas, sizes, oh, ow, compute_dtype=tdt,
                           **FOLDS[fold])
        want = _jax_resize(canvas, sizes, oh, ow, compute_dtype=jdt,
                           **FOLDS[fold])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("oh,ow", [(64, 96), (77, 33), (288, 224),
                                   (64, 288)])
def test_resize_device_other_widths(oh, ow):
    canvas, sizes = _canvases(seed=1)
    got = _port_resize(canvas, sizes, oh, ow)
    want = _jax_resize(canvas, sizes, oh, ow)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    np.testing.assert_array_equal(
        _port_resize(canvas, sizes, oh, ow, compute_dtype=torch.bfloat16),
        _jax_resize(canvas, sizes, oh, ow, compute_dtype=jnp.bfloat16))


def test_resize_device_one_image():
    canvas, sizes = _canvases(n=1)
    got = TP.resize_device(torch.as_tensor(canvas[0]), 200, 150, 48, 64)
    want = TP.resize_device_batch(torch.as_tensor(canvas),
                                  torch.as_tensor(sizes), 48, 64)[0]
    assert torch.equal(got, want)


def _images(seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in IMAGE_SIZES:
        small = rng.integers(0, 256, (5, 5, 3), dtype=np.uint8)
        out.append(cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR))
    return out


@pytest.fixture(scope="module")
def classifiers():
    """(port Classifier, JAX Classifier) of the narrow classifier, float32."""
    cfg, specs = model("narrow-cls", SIZE)
    jcfg, jspecs = jax_model("narrow-cls", SIZE)
    port, jaxp = folded_params(specs, SIZE)
    return (Classifier(cfg, params=port, specs=specs, device="cpu"),
            JaxClassifier(jcfg, params=jaxp, specs=jspecs))


def _check_probs(got, want):
    got, want = np.asarray(got), np.asarray(want, np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(TV.topk_indices(got, 5),
                                  JV.topk_indices(want, 5))


@pytest.mark.parametrize("mode,buckets", [
    ("single", None), ("crop", None), ("10crop", None), ("full", None),
    ("full", "snap32"), ("multi", None), ("multi", "snap32")])
def test_classifier_modes_match_jax(classifiers, mode, buckets):
    clf, jclf = classifiers
    imgs = _images()
    got = TV._chunk_probs(clf, imgs, mode, buckets)
    want = JV._chunk_probs(jclf, imgs, mode, buckets)
    _check_probs(got, want)
    if mode in ("single", "crop"):
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


def test_classify_and_classify_batch_match_jax(classifiers):
    clf, jclf = classifiers
    batch = images(3, SIZE, seed=4)
    got = clf.classify_batch(batch)
    assert got.device.type == "cpu"
    _check_probs(got.numpy(), jclf.classify_batch(batch))
    for img in _images()[:2]:
        res, jres = clf.classify(img, top_k=3), jclf.classify(img, top_k=3)
        assert [r["class_id"] for r in res] == [r["class_id"] for r in jres]
        assert [r["class"] for r in res] == [r["class"] for r in jres]
        np.testing.assert_allclose([r["prob"] for r in res],
                                   [r["prob"] for r in jres], **TOL)


def test_int8_classifier_matches_jax():
    """Int8 params (every conv quantized, the class conv too, as
    quantize_params does for a classifier) through QuantConv, f32 epilogue,
    in the crop mode."""
    cfg, specs = model("narrow-cls", SIZE)
    jcfg, jspecs = jax_model("narrow-cls", SIZE)
    _, jaxp = folded_params(specs, SIZE)
    scales = JQ.calibrate_activations(jspecs, jaxp, [images(2, SIZE, seed=3)],
                                      cfg=jcfg)
    qparams = JQ.quantize_params(jspecs, jaxp, scales)
    assert sum("w_q" in p for p in qparams.values()) == 5
    clf = Classifier(cfg, params=TW.params_from_jax(qparams), specs=specs,
                     device="cpu")
    jclf = JaxClassifier(jcfg, params=qparams, specs=jspecs)
    imgs = _images(seed=6)
    _check_probs(TV._chunk_probs(clf, imgs, "crop"),
                 JV._chunk_probs(jclf, imgs, "crop"))


def test_classifier_rejects_detectors():
    with pytest.raises(ValueError, match="not a classifier"):
        Classifier("yolov3-tiny", params={}, device="cpu")
    with pytest.raises(ValueError, match="weights_path or params"):
        Classifier("darknet19-classifier", device="cpu")


@pytest.fixture(scope="module")
def labelled_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cls")
    rng = np.random.default_rng(9)
    pairs = []
    for i, img in enumerate(_images(seed=7) + _images(seed=8)):
        path = str(root / f"img{i}.png")
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        np.save(path[:-4] + ".npy", img)
        pairs.append((path, int(rng.integers(-1, 4))))
    return pairs


@pytest.mark.parametrize("mode", ["single", "crop", "10crop", "full",
                                  "multi"])
def test_validate_classifier_matches_jax(classifiers, labelled_files, mode):
    clf, jclf = classifiers
    want = JV.validate_classifier(jclf, labelled_files, top_k=2,
                                  batch_size=4, mode=mode)
    got = TV.validate_classifier(
        clf, labelled_files, top_k=2, batch_size=4, mode=mode,
        read_fn=lambda p: np.load(p[:-4] + ".npy"))
    assert got == want and got["images"] == len(labelled_files)


def test_list_and_helpers_match_jax(tmp_path):
    names = ("cat", "dog", "bird")
    lines = ["data/cat_1.png", "data/dog_2.png", "", "data/fish.png",
             "data/bird_dog.png"]
    path = tmp_path / "val.list"
    path.write_text("\n".join(lines) + "\n")
    assert (TV.read_validation_list(str(path), names)
            == JV.read_validation_list(str(path), names)
            == [("data/cat_1.png", 0), ("data/dog_2.png", 1),
                ("data/fish.png", -1), ("data/bird_dog.png", 1)])
    probs = np.asarray([[0.1, 0.4, 0.4, 0.1], [0.3, 0.2, 0.3, 0.2]],
                       np.float32)
    np.testing.assert_array_equal(TV.topk_indices(probs, 3),
                                  JV.topk_indices(probs, 3))
    for hw in ((224, 301), (17, 5000), (333, 250)):
        assert TV.snap_shape_32(*hw) == JV.snap_shape_32(*hw)
    assert TV.MULTI_SCALES == JV.MULTI_SCALES
    with pytest.raises(ValueError, match="mode"):
        TV._chunk_probs(None, [], "nine-crop")
