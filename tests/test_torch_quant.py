"""Port int8 serving (ops/quant.py, ops/kernels/conv_int8.py) vs the JAX
package's ops/quant.py, on the same numpy parameters and inputs.

- ``head_conv_layers`` and ``quantize_params`` equal JAX exactly (the same
  numpy float32 operations, on OIHW instead of HWIO).
- ``calibrate_activations`` equals JAX within rtol 1e-5: both take the same
  numpy percentile, of conv inputs that differ by float32 summation order.
- The plain int32 accumulator equals ``lax.conv_general_dilated`` on int8
  exactly, and at 3x3 stride 1 the Pallas probe
  ``tools/probe_int8_3x3.pallas_conv3x3_int8`` run in interpret mode.
- ``conv2d_int8`` equals the jitted JAX ``quant.conv2d_int8`` (+ leaky) to
  1 ulp in float32 (both round the epilogue as one fma; the bound stays
  1 ulp) and exactly in bfloat16; at yolov1's 7x7 stride-2 first conv
  (narrow_v1_spec's, its params quantized by the JAX package) exactly in
  float32 too.
- The narrow int8 v1 Detector (the 7x7 conv quantized with the rest, the
  connected head float) gives the JAX Detector's num, classes and valid,
  boxes and scores at rtol 1e-4 / atol 1e-5; a quantized logistic conv
  (``engine.QuantConv``: the kernel's linear epilogue, then the sigmoid)
  equals JAX's conv2d_int8 + sigmoid to 1 ulp.
On CPU tensors the wrapper runs the plain version; ``launches`` stays put.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from yolo_tensorflow_tpu.ops import layers as JL
from yolo_tensorflow_tpu.ops import quant as JQ
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.ops import quant as TQ
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as K

from torch_parity import folded_params, images, jax_model, model, to_jax

SIZE = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", params=["narrow", "yolov3-tiny"])
def calibrated(request):
    """(port cfg, port specs, JAX specs, port folded params, JAX folded
    params, calibration batches, JAX activation scales)."""
    cfg, specs = model(request.param, SIZE)
    jcfg, jspecs = jax_model(request.param, SIZE)
    port, jaxp = folded_params(specs, SIZE)
    batches = [images(2, SIZE, seed=s) for s in (3, 4)]
    want = JQ.calibrate_activations(jspecs, jaxp, batches, cfg=jcfg)
    return cfg, specs, jspecs, port, jaxp, batches, want


def test_head_conv_layers_match_jax(calibrated):
    _, specs, jspecs, *_ = calibrated
    assert TQ.head_conv_layers(specs) == JQ.head_conv_layers(jspecs)
    assert TQ.head_conv_layers(specs)


def test_calibrate_matches_jax(calibrated):
    cfg, specs, _, port, _, batches, want = calibrated
    got = TQ.calibrate_activations(specs, port, batches, cfg=cfg)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)


def test_quantize_params_match_jax(calibrated):
    _, specs, jspecs, port, jaxp, _, scales = calibrated
    want = JQ.quantize_params(jspecs, jaxp, scales)
    got = TQ.quantize_params(specs, port, scales)
    assert got.keys() == want.keys()
    quantized = [k for k, p in got.items() if "w_q" in p]
    assert len(quantized) == len(got) - len(TQ.head_conv_layers(specs))
    for key, p in to_jax(got).items():
        assert p.keys() == want[key].keys(), key
        for name, v in p.items():
            assert v.dtype == want[key][name].dtype, (key, name)
            np.testing.assert_array_equal(v, want[key][name],
                                          err_msg=f"{key} {name}")


def test_params_from_jax_carries_int8(calibrated):
    _, _, jspecs, _, jaxp, _, scales = calibrated
    want = JQ.quantize_params(jspecs, jaxp, scales)
    got = TW.params_from_jax(want)
    for key, p in want.items():
        if "w_q" in p:
            assert got[key]["w_q"].dtype == np.int8
            assert got[key]["w_q"].flags.c_contiguous
            np.testing.assert_array_equal(
                got[key]["w_q"], np.asarray(p["w_q"]).transpose(3, 2, 0, 1))
        for name, v in to_jax(got)[key].items():
            np.testing.assert_array_equal(v, np.asarray(p[name]))


def _nchw(x_nhwc):
    return torch.from_numpy(np.array(x_nhwc)).permute(0, 3, 1, 2)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1))).contiguous(
            memory_format=torch.channels_last)


@pytest.mark.parametrize("cin", [3, 16])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2), (7, 2)])
def test_accumulator_matches_lax_conv(k, stride, cin, rng):
    x = rng.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, 24)).astype(np.int8)
    pad = k // 2
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = K.int8_accumulate(_nchw(x), _oihw(w), stride=stride, pad=pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "probe_int8_3x3", os.path.join(REPO, "tools", "probe_int8_3x3.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("cin,cout", [(3, 16), (32, 64)])
def test_accumulator_matches_pallas_probe(cin, cout, rng, monkeypatch):
    """TPU kernel row 2, pallas_conv3x3_int8, interpreted on the CPU."""
    probe = _probe_module()
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    x = rng.integers(-127, 128, (2, 6, 7, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = probe.pallas_conv3x3_int8(jnp.asarray(xp), jnp.asarray(w),
                                     co_tile=cout)
    got = K.int8_accumulate(_nchw(x), _oihw(w), pad=1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def _ulps(a, b):
    """Distance in float32 units in the last place (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("act", ["linear", "leaky"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,cin", [(1, 1, 16), (3, 1, 16),
                                          (3, 2, 16), (3, 1, 3), (7, 2, 3),
                                          (7, 1, 3)])
def test_conv2d_int8_matches_jax(k, stride, cin, dtype, act, rng):
    tdt, jdt = DTYPES[dtype]
    x = jnp.asarray(rng.standard_normal((2, 9, 9, cin), dtype=np.float32)
                    * 2).astype(jdt)
    w = rng.integers(-127, 128, (k, k, cin, 24)).astype(np.int8)
    s_w = (rng.uniform(0.5, 1.5, 24) / 127).astype(np.float32)
    s_x = np.float32(0.031)
    b = rng.standard_normal(24).astype(np.float32)

    def jax_fn(x, w, s_w, b):
        y = JQ.conv2d_int8(x, w, s_x, s_w, b, stride=stride,
                           epilogue_dtype=jdt)
        return JL.leaky_relu(y) if act == "leaky" else y

    want = np.asarray(jax.jit(jax_fn)(x, jnp.asarray(w), jnp.asarray(s_w),
                                      jnp.asarray(b)).astype(jnp.float32))
    before = K.launches
    got = K.conv2d_int8(_nchw(np.asarray(x.astype(jnp.float32))).to(tdt),
                        _oihw(w), s_x, torch.from_numpy(s_w),
                        torch.from_numpy(b), stride=stride, act=act,
                        epilogue_dtype=tdt)
    assert K.launches == before
    assert got.dtype == tdt
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        assert _ulps(got, want).max() <= 1


def _args(cin=16, k=3):
    x = torch.zeros((1, cin, 5, 5)).contiguous(
        memory_format=torch.channels_last)
    w = torch.zeros((8, cin, k, k), dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    return dict(x=x, w_q=w, s_x=1.0, s_w=torch.ones(8), b=torch.zeros(8))


@pytest.mark.parametrize("kw", [dict(k=5), dict(stride=3), dict(pad=0),
                                dict(act="tanh")])
def test_unsupported_geometry_raises(kw):
    args = _args(k=kw.pop("k", 3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K.conv2d_int8(**args, **kw)


@pytest.mark.parametrize("change,error", [
    ("nchw_input", ValueError), ("float_weights", ValueError),
    ("short_scales", ValueError), ("int_input", TypeError),
    ("half_epilogue", TypeError)])
def test_bad_operands_raise(change, error):
    args, kw = _args(), {}
    if change == "nchw_input":
        args["x"] = args["x"].contiguous()
    elif change == "float_weights":
        args["w_q"] = args["w_q"].float()
    elif change == "short_scales":
        args["s_w"] = torch.ones(7)
    elif change == "int_input":
        args["x"] = args["x"].to(torch.int32)
    else:
        kw["epilogue_dtype"] = torch.float16
    with pytest.raises(error):
        K.conv2d_int8(**args, **kw)


@pytest.fixture(scope="module")
def int8_v1():
    """The narrow v1 net's int8 params from the JAX package: every conv
    quantized (the 7x7 stride-2 first one too), the connected head float."""
    from torch_parity import jax_int8_params
    return jax_int8_params("narrow-v1", SIZE)


@pytest.mark.parametrize("act", ["linear", "leaky"])
def test_conv2d_int8_7x7_matches_jax_exactly(int8_v1, act):
    """narrow_v1_spec's first conv (Cin 3, 7x7, stride 2, pad 3) with the
    JAX package's quantized params, f32 epilogue: bit for bit."""
    _, specs, _, _, qparams = int8_v1
    p = qparams["L000"]
    assert specs[0].size == 7 and specs[0].stride == 2
    assert np.asarray(p["w_q"]).shape == (7, 7, 3, 8)
    x = np.asarray(images(2, SIZE), np.float32) / 127.5 - 1.0

    def jax_fn(x):
        y = JQ.conv2d_int8(x, p["w_q"], p["s_x"], p["s_w"], p["b"],
                           stride=2, epilogue_dtype=jnp.float32)
        return JL.leaky_relu(y) if act == "leaky" else y

    want = np.asarray(jax.jit(jax_fn)(jnp.asarray(x)))
    q = TW.params_from_jax(qparams)["L000"]
    args = (_nchw(x).contiguous(memory_format=torch.channels_last),
            torch.from_numpy(q["w_q"]).contiguous(
                memory_format=torch.channels_last), float(q["s_x"]),
            torch.from_numpy(q["s_w"]), torch.from_numpy(q["b"]))
    got = K.conv2d_int8_plain(*args, stride=2, act=act)
    assert got.shape == (2, 8, SIZE // 2, SIZE // 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    before = K.launches
    np.testing.assert_array_equal(
        K.conv2d_int8(*args, stride=2, act=act).numpy(), got.numpy())
    assert K.launches == before


def test_int8_v1_detector_matches_jax(int8_v1):
    from yolo_tensorflow_tpu.pipeline import Detector as JaxDetector
    from yolo_tensorflow_tpu_torch.models import engine as TE
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    cfg, specs, jcfg, jspecs, qparams = int8_v1
    opts = dict(conf_threshold=0.2, num_candidates=64)
    imgs = images(2, SIZE)
    want = JaxDetector(jcfg, params=qparams, specs=jspecs,
                       **opts).detect_batch(imgs)
    det = Detector(cfg, params=TW.params_from_jax(qparams), specs=specs,
                   device="cpu", **opts)
    quant = [m for m in det.network.modules()
             if isinstance(m, TE.QuantConv)]
    assert len(quant) == 3 and quant[0].w_q.shape[-1] == 7
    got = det.detect_batch(imgs)
    assert (got.num > 0).all()
    for name in ("num", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_conv_applies_logistic_after_the_kernel(dtype, rng):
    """A quantized logistic conv: the kernel's linear epilogue in the
    compute dtype, then the sigmoid in it, as JAX's engine.apply runs
    conv2d_int8 and then its activation."""
    from yolo_tensorflow_tpu_torch.models import engine as TE
    from yolo_tensorflow_tpu_torch.models import specs as TS
    tdt, jdt = DTYPES[dtype]
    w = rng.integers(-127, 128, (3, 3, 16, 24)).astype(np.int8)
    p = {"w_q": w, "s_w": (rng.uniform(0.5, 1.5, 24) / 127).astype(
        np.float32), "s_x": np.float32(0.027),
         "b": rng.standard_normal(24).astype(np.float32)}
    x = rng.standard_normal((2, 9, 9, 16), dtype=np.float32).astype(
        jnp.bfloat16 if dtype == "bfloat16" else np.float32)
    want = jax.jit(lambda x: JL.activate(JQ.conv2d_int8(
        x, p["w_q"], p["s_x"], p["s_w"], p["b"], epilogue_dtype=jdt),
        "logistic"))(jnp.asarray(x))
    net = TE.Network((TS.Conv(24, 3, act="logistic"),),
                     TW.params_from_jax({"L000": p}), dtype=tdt)
    assert isinstance(net.convs["L000"], TE.QuantConv)
    got = net.layer_outputs(_nchw(np.asarray(x, np.float32)).to(tdt))[0]
    assert got.dtype == tdt
    got = got.permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        assert _ulps(got, want).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -8)
