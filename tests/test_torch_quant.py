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
  1 ulp) and exactly in bfloat16.
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
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
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
                                          (3, 2, 16), (3, 1, 3)])
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
