"""Port engine (yolo_tensorflow_tpu_torch/models/engine.py) vs the JAX
package's engine.apply: raw head outputs on the same numpy parameters and
inputs, f32, rtol 1e-4 / atol 1e-4 (conv sums in different orders compound
over depth; the full yolov3 is 75 convs deep); the shallower region (v2) and
grid (v1) families at rtol 1e-4 / atol 1e-5.

Int8 parameters (the JAX package's quantize_params) run through the port's
int8 conv: its accumulator is exact and its epilogue rounds as JAX's, so the
int8 layers agree bit for bit and only the float head convs differ: f32 at
rtol 1e-5 / atol 1e-5; bf16 exactly when the heads are quantized too, and
otherwise within 2 bf16 ulps (rtol 2**-6, atol 2**-9), since PyTorch's bf16
conv adds its bias in bf16 where XLA adds it in f32 before one rounding."""

import numpy as np
import pytest
import torch

import jax

from yolo_tensorflow_tpu.models import engine as JE
from yolo_tensorflow_tpu_torch.models import engine as TE
from yolo_tensorflow_tpu_torch.models import specs as S

from torch_parity import (folded_params, images, jax_int8_params, jax_model,
                          model)
from yolo_tensorflow_tpu.pipeline import normalize_images as jax_normalize
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
from yolo_tensorflow_tpu_torch.pipeline import normalize_images

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,size", [("narrow", 64), ("yolov3-tiny", 64),
                                       ("yolov3", 32)])
def test_heads_match_jax_apply(name, size, rng):
    _, specs = model(name, size)
    jcfg, jspecs = jax_model(name, size)
    port_params, jax_params = folded_params(specs, size)
    x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)

    apply = jax.jit(lambda p, x: [f for f, _ in JE.apply(
        jspecs, p, x, bn_eps=jcfg.bn_eps)[0]])
    want = apply(jax_params, x)

    net = TE.Network(specs, port_params)
    with torch.inference_mode():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want)
    for (feat, det), w in zip(got, want):
        assert isinstance(det, S.Detect)
        assert feat.is_contiguous()       # NHWC view of channels-last: free
        np.testing.assert_allclose(feat.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name,size", [
    ("narrow", 64), ("yolov3-tiny", 64), ("yolov3", 416), ("yolov2", 416),
    ("yolov2-tiny-voc", 416), ("yolov1", 448), ("yolov1-tiny", 448),
    ("darknet19-classifier", 256), ("narrow-v2", 64), ("narrow-v1", 64)])
def test_infer_shapes_match_jax(name, size):
    _, specs = model(name, size)
    _, jspecs = jax_model(name, size)
    shape = (1, size, size, 3)
    assert TE.infer_shapes(specs, shape) == JE.infer_shapes(jspecs, shape)


@pytest.mark.parametrize("spec,item", [
    (S.Local(4, 3), "the long tail"),
    (S.Deconv(4, 3), "the long tail"),
    (S.L2Norm(), "the long tail"),
    (S.LRN(), "the long tail"),
    (S.Upsample(2, "bilinear_sym"), "upsample_bilinear_sym")])
def test_unported_layers_raise(spec, item):
    specs = (S.Conv(4, 3), spec)
    with pytest.raises(NotImplementedError, match=item):
        TE.Network(specs, {"L000": {"w": np.zeros((4, 3, 3, 3)),
                                    "b": np.zeros(4)}})


# the region (v2) and grid (v1) families, at rtol 1e-4 / atol 1e-5: Reorg in
# both modes under a Route, TransposeFlatten, Dense, Dropout as identity
REGION_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,size", [
    ("narrow-v2", 64), ("narrow-v2-s2d", 64), ("narrow-v1", 64),
    ("yolov2", 64), ("yolov1-tiny", 64), ("yolov2-tiny-voc", 64)])
def test_region_and_grid_heads_match_jax_apply(name, size, rng):
    _, specs = model(name, size)
    jcfg, jspecs = jax_model(name, size)
    port_params, jax_params = folded_params(specs, size)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: [f for f, _ in JE.apply(
        jspecs, p, x, bn_eps=jcfg.bn_eps)[0]])(jax_params, x)
    net = TE.Network(specs, port_params)
    with torch.inference_mode():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 1
    (feat, det), = got
    assert isinstance(det, S.Detect) and feat.is_contiguous()
    assert feat.shape == want[0].shape and np.abs(want[0]).max() > 0.1
    np.testing.assert_allclose(feat.numpy(), np.asarray(want[0]),
                               **REGION_TOL)


def test_classifier_tail_matches_jax_apply(rng):
    """GlobalAvgPool and Softmax (darknet19-classifier, 1000 classes)."""
    _, specs = model("darknet19-classifier", 64)
    jcfg, jspecs = jax_model("darknet19-classifier", 64)
    port_params, jax_params = folded_params(specs, 64)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    (want, _), = JE.apply(jspecs, jax_params, x, bn_eps=jcfg.bn_eps)[0]
    with torch.inference_mode():
        (got, _), = TE.Network(specs, port_params)(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("groups,temperature", [(1, 1.0), (4, 1.0), (2, 0.5)])
def test_softmax_groups_and_temperature_match_jax(groups, temperature, rng):
    specs = (S.GlobalAvgPool(), S.Softmax(groups, temperature), S.Detect(()))
    from yolo_tensorflow_tpu.models import specs as JS
    jspecs = (JS.GlobalAvgPool(), JS.Softmax(groups, temperature),
              JS.Detect(()))
    x = rng.standard_normal((2, 3, 5, 8), dtype=np.float32) * 3
    (want, _), = JE.apply(jspecs, {}, x)[0]
    (got, _), = TE.Network(specs, {})(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_bf16_network_keeps_connected_layers_as_jax_does():
    """The first connected layer of a bf16 network takes a bf16 input and
    bf16 weights; its float32 output feeds the next ones, whose weights stay
    float32 (the TPU package rounds w to x's dtype on every call)."""
    _, specs = model("narrow-v1", 64)
    port_params, _ = folded_params(specs, 64)
    net = TE.Network(specs, port_params, dtype=torch.bfloat16)
    assert [d.w.dtype for d in net.dense.values()] == [
        torch.bfloat16, torch.float32, torch.float32]
    assert all(d.b.dtype == torch.float32 for d in net.dense.values())
    assert all(d.w.shape == port_params[k]["w"].shape
               for k, d in net.dense.items())          # (In, Out)
    with torch.inference_mode():
        (feat, _), = net(torch.zeros(1, 3, 64, 64, dtype=torch.bfloat16))
    assert feat.dtype == torch.float32 and feat.shape == (1, 126)


def test_train_network_takes_reorg_and_leaves_connected_layers():
    """TrainNetwork runs the region family's layers (Reorg under a Route);
    the v1 connected head trains too (tests/test_torch_train_families.py)
    and leaves its Dropout to a generator, which it must be given."""
    _, specs = model("narrow-v2", 64)
    jcfg, jspecs = jax_model("narrow-v2", 64)
    raw, _ = TE.init_params(specs, 64, 0)
    from torch_parity import to_jax
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want, aux = JE.apply(jspecs, to_jax(raw), x, train=True,
                         bn_eps=jcfg.bn_eps)
    net = TE.TrainNetwork(specs, raw)
    got, stats = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                     bn_eps=jcfg.bn_eps)
    np.testing.assert_allclose(got[0][0].detach().numpy(),
                               np.asarray(want[0][0]), rtol=1e-4, atol=1e-4)
    assert stats.keys() == aux["batch_stats"].keys()
    _, v1 = model("narrow-v1", 64)
    net = TE.TrainNetwork(v1, TE.init_params(v1, 64, 0)[0])
    x1 = torch.zeros((2, 3, 64, 64))
    with pytest.raises(ValueError, match="Generator"):
        net(x1)
    (feat, _), = net(x1, generator=torch.Generator())[0]
    assert feat.shape == (2, 126) and feat.dtype == torch.float32


def test_unfolded_connected_bn_raises():
    specs = (S.TransposeFlatten(), S.Dense(4, bn=True))
    p = {"L001": {"w": np.zeros((12, 4)), "gamma": np.ones(4),
                  "beta": np.zeros(4)}}
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        TE.Network(specs, p)
    with pytest.raises(ValueError, match="reorg mode"):
        TE.Network((S.Reorg(2, "pixel_unshuffle"),), {})


@pytest.mark.parametrize("extra,item", [
    ({"w_q": np.zeros((4, 3, 5, 5), np.int8), "s_w": np.ones(4, np.float32),
      "s_x": np.float32(1)}, "int8"),
    ({"gamma": 0}, "training")])
def test_unported_params_raise(extra, item):
    """Unfolded BN raises, and so does an int8 conv of a size the int8
    kernel does not take (5x5; its tanh, which the epilogue does not fuse,
    would follow the kernel)."""
    p = {"L000": {"w": np.zeros((4, 3, 5, 5)), "b": np.zeros(4), **extra}}
    with pytest.raises(NotImplementedError, match=item):
        TE.Network((S.Conv(4, 5, act="tanh"),), p)


INT8_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=2 ** -6, atol=2 ** -9)}


@pytest.mark.parametrize("name,dtype,quantize_heads", [
    ("narrow", "float32", False), ("yolov3-tiny", "float32", False),
    ("yolov3-tiny", "bfloat16", False), ("yolov3-tiny", "bfloat16", True)])
def test_int8_heads_match_jax_apply(name, dtype, quantize_heads):
    cfg, specs, jcfg, jspecs, qparams = jax_int8_params(
        name, 64, quantize_heads=quantize_heads)
    tdt, jdt = ((torch.float32, None) if dtype == "float32"
                else (torch.bfloat16, jax.numpy.bfloat16))
    imgs = images(2, 64)
    want = jax.jit(lambda p, x: [f for f, _ in JE.apply(
        jspecs, p, x, bn_eps=jcfg.bn_eps, compute_dtype=jdt)[0]])(
            qparams, jax_normalize(imgs, jcfg, jdt or jax.numpy.float32))

    net = TE.Network(specs, TW.params_from_jax(qparams), dtype=tdt)
    n_int8 = sum(isinstance(c, TE.QuantConv) for c in net.convs.values())
    assert n_int8 == sum("w_q" in p for p in qparams.values()) > 0
    before = Q8.launches
    with torch.inference_mode():
        got = net(normalize_images(torch.from_numpy(imgs), cfg, tdt))
    assert Q8.launches == before
    for (feat, _), w in zip(got, want):
        assert feat.dtype == tdt
        w = np.asarray(w.astype(jax.numpy.float32))
        if quantize_heads:
            np.testing.assert_array_equal(feat.float().numpy(), w)
        else:
            np.testing.assert_allclose(feat.float().numpy(), w,
                                       **INT8_TOL[dtype])
