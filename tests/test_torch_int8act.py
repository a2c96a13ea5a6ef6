"""Port all-int8-activation path (ops/quant.py calibrate_outputs, apply_int8,
make_int8_forward; ops/kernels/conv_int8.conv2d_int8_q, the int8-in entry,
on the CPU its plain twin; int8 max_pool and upsample) vs the JAX package's
ops/quant.py, on the same numpy parameters and inputs.

- ``calibrate_outputs``: the same layers, scales within rtol 1e-5 (the
  same numpy percentile of outputs that differ by float32 summation order).
- ``apply_int8``, with the JAX package's scales and int8 params, against
  JAX's apply_int8 as its jitted CPU program computes it (XLA turns each
  ``/ s_out`` into a multiply by f32(1 / s_out), folds a dequantize scale
  into it, fuses an int8 shortcut operand's dequantize and the add into
  one fma, and the conv epilogue into one fma): at every requantize of
  JAX's (``_requant``, recorded through a monkeypatch), the number of int8
  elements that differ is 0. The head convs run in float32, their outputs
  within rtol 1e-4 / atol 1e-5 (float32 conv sums in another order).
- ``make_int8_forward`` against JAX's jitted make_int8_forward: num,
  classes and valid equal, boxes and scores at rtol 1e-4 / atol 1e-5.
- ``conv2d_int8_q`` (its plain twin on CPU tensors) against the JAX
  package's formula for the same conv (lax int8 conv, the epilogue, leaky
  and requantize, jitted): int8 outputs equal and float32 outputs equal;
  with integer inputs and unit scales at 3x3 stride 1, the Pallas probe
  tools/probe_int8_3x3.pallas_conv3x3_int8 in interpret mode.
- ``fma_f32`` rounds a * b + c once (against exact rational arithmetic),
  and ``torch.add(..., alpha=)``, the shortcut's fused add, equals it.
The models: yolov3-tiny (routes that requantize, SAME max pool, upsample),
a narrow v3 net with leaky convs only (shortcut, stride 2, a route of the
input), the narrow v2 net (darknet reorg) and the narrow v1 net (its 7x7
stride-2 first conv quantized too). A logistic conv runs the int8-in entry
with its float32 output, the activation after it and then the requantize,
as JAX's apply_int8 orders them.
"""

import functools
import importlib.util
import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from yolo_tensorflow_tpu.ops import layers as JL
from yolo_tensorflow_tpu.ops import quant as JQ
from yolo_tensorflow_tpu.pipeline import normalize_images as jax_normalize
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.models import specs as TS
from yolo_tensorflow_tpu_torch.ops import layers as L
from yolo_tensorflow_tpu_torch.ops import quant as TQ
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K

from torch_parity import folded_params, images, jax_model, model

SIZE = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["yolov3-tiny", "narrow-leaky", "narrow-v2", "narrow-v1"]
PARITY = dict(rtol=1e-4, atol=1e-5)
OPTS = dict(conf_threshold=0.2, num_candidates=64)


@pytest.fixture(scope="module", params=MODELS)
def quantized(request):
    """(name, port cfg, port specs, JAX cfg, JAX specs, port folded
    params, JAX folded params, JAX output scales, JAX int8 params)."""
    name = request.param
    cfg, specs = model(name, SIZE)
    jcfg, jspecs = jax_model(name, SIZE)
    port, jaxp = folded_params(specs, SIZE)
    calib = [images(2, SIZE, seed=3)]
    act = JQ.calibrate_activations(jspecs, jaxp, calib, cfg=jcfg)
    outs = JQ.calibrate_outputs(jspecs, jaxp, calib, cfg=jcfg)
    qparams = JQ.quantize_params(jspecs, jaxp, act,
                                 skip=JQ.head_conv_layers(jspecs))
    return name, cfg, specs, jcfg, jspecs, port, jaxp, outs, qparams


def test_calibrate_outputs_matches_jax(quantized):
    _, cfg, specs, jcfg, jspecs, port, jaxp, _, _ = quantized
    calib = [images(2, SIZE, seed=s) for s in (3, 4)]
    want = JQ.calibrate_outputs(jspecs, jaxp, calib, cfg=jcfg)
    got = TQ.calibrate_outputs(specs, port, calib, cfg=cfg, device="cpu")
    assert got.keys() == want.keys() and -1 in got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=str(key))


def _jax_apply(jspecs, qparams, outs, x, monkeypatch):
    """JAX's jitted apply_int8 -> (head features, [(s_out, int8 array)] of
    every _requant in call order)."""
    real = JQ._requant
    scales = []

    def traced(qp, xn):
        recorded = []

        def requant(y, s_out):
            q = real(y, s_out)
            scales.append(s_out)
            recorded.append(q)
            return q

        monkeypatch.setattr(JQ, "_requant", requant)
        dets = JQ.apply_int8(jspecs, qp, outs, xn)
        monkeypatch.setattr(JQ, "_requant", real)
        return [f for f, _ in dets], recorded

    feats, qs = jax.jit(traced)(qparams, x)
    return feats, list(zip(scales, qs))


def _port_events(specs, layers, x_q, outs, skip):
    """The port's int8 tensors at the places JAX requantizes, in JAX's
    order: the input, each requantized conv, an input fetched by a route or
    shortcut, each route part whose scale differs from the route's, each
    shortcut."""
    events = [(outs[-1], x_q)]
    for i, spec in enumerate(specs):
        if isinstance(spec, TS.Conv):
            if i in outs and i not in skip:
                events.append((outs[i], layers[i][0]))
        elif isinstance(spec, TS.Route):
            refs = [TS.resolve_ref(r, i) for r in spec.refs]
            events += [(outs[-1], x_q) for r in refs if r == TS.INPUT]
            if len(refs) > 1:
                off = 0
                for r in refs:
                    t, s = (x_q, outs[-1]) if r == TS.INPUT else layers[r]
                    if s is None or abs(s - outs[i]) >= 1e-12:
                        events.append((outs[i], layers[i][0][
                            :, off:off + t.shape[1]]))
                    off += t.shape[1]
        elif isinstance(spec, TS.Shortcut):
            if TS.resolve_ref(spec.ref, i) == TS.INPUT:
                events.append((outs[-1], x_q))
            events.append((outs[i], layers[i][0]))
    return events


def test_apply_int8_matches_jax(quantized, monkeypatch):
    """Zero int8 elements differ at every requantize (module docstring)."""
    name, cfg, specs, jcfg, jspecs, _, _, outs, qparams = quantized
    x = np.asarray(jax_normalize(jnp.asarray(images(2, SIZE)), jcfg))
    jfeats, jevents = _jax_apply(jspecs, qparams, outs, x, monkeypatch)
    xt = torch.from_numpy(x.copy()).permute(0, 3, 1, 2)
    before = Q8.launches_q, Q8.launches
    dets, layers = TQ.apply_int8_layers(specs, TW.params_from_jax(qparams),
                                        outs, xt)
    assert (Q8.launches_q, Q8.launches) == before
    events = _port_events(specs, layers, TQ._requant_from(xt, None,
                                                          outs[-1]),
                          outs, TQ.head_conv_layers(specs))
    assert len(events) == len(jevents) > 2
    counts = []
    for (s, got), (js, want) in zip(events, jevents):
        assert s == js and got.dtype == torch.int8
        counts.append(int((got.permute(0, 2, 3, 1).numpy()
                           != np.asarray(want)).sum()))
    assert counts == [0] * len(counts), counts
    quantized_convs = [i for i, s in enumerate(specs)
                       if isinstance(s, TS.Conv) and layers[i][1] is not None]
    assert len(quantized_convs) >= 3
    assert len(dets) == len(jfeats)
    for (feat, _), want in zip(dets, jfeats):
        assert feat.dtype == torch.float32
        np.testing.assert_allclose(feat.numpy(), np.asarray(want), **PARITY)


def test_make_int8_forward_matches_jax(quantized):
    name, cfg, specs, jcfg, jspecs, _, _, outs, qparams = quantized
    imgs = images(2, SIZE)
    want = jax.jit(JQ.make_int8_forward(jcfg, jspecs, outs, **OPTS))(
        qparams, imgs)
    fwd = TQ.make_int8_forward(cfg, specs, outs, **OPTS)
    before = K.launches, Q8.launches_q
    got = fwd(TQ.int8_params_to(TW.params_from_jax(qparams), "cpu"),
              torch.from_numpy(imgs))
    assert (K.launches, Q8.launches_q) == before
    assert (got.num > 0).all()
    for field in ("num", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    for field in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   **PARITY, err_msg=field)


def test_make_int8_forward_takes_only_nms_options():
    cfg, specs = model("narrow-leaky", SIZE)
    with pytest.raises(TypeError, match="unknown options"):
        TQ.make_int8_forward(cfg, specs, {}, tta=True)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1))).contiguous(
            memory_format=torch.channels_last)


@pytest.mark.parametrize("out", ["int8", "float32"])
@pytest.mark.parametrize("act", ["linear", "leaky"])
@pytest.mark.parametrize("k,stride,cin", [(1, 1, 16), (3, 1, 16), (3, 2, 16),
                                          (1, 2, 8), (3, 1, 3), (7, 2, 3),
                                          (7, 1, 3)])
def test_conv2d_int8_q_matches_jax(k, stride, cin, act, out, rng):
    """The int8-in conv as JAX's jitted apply_int8 computes one layer:
    acc * (s_in * s_w) + b, leaky, _requant."""
    xq = rng.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, 24)).astype(np.int8)
    s_w = (rng.uniform(0.5, 1.5, 24) / 127).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    s_in, s_out = 0.0123, (0.0377 if out == "int8" else None)
    pad = k // 2

    def jax_fn(xq, w, s_w, b):
        acc = lax.conv_general_dilated(
            xq, w, (stride, stride), ((pad, pad), (pad, pad)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * (s_in * s_w) + b
        if act == "leaky":
            y = JL.leaky_relu(y)
        return y if s_out is None else JQ._requant(y, s_out)

    want = np.asarray(jax.jit(jax_fn)(xq, w, s_w, b))
    before = Q8.launches_q
    got = Q8.conv2d_int8_q(_nchw(xq), s_in, _oihw(w), torch.from_numpy(s_w),
                           torch.from_numpy(b), stride=stride, act=act,
                           s_out=s_out)
    assert Q8.launches_q == before
    assert got.dtype == (torch.int8 if s_out else torch.float32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "probe_int8_3x3", os.path.join(REPO, "tools", "probe_int8_3x3.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_conv2d_int8_q_is_the_pallas_accumulator(rng, monkeypatch):
    """Integer inputs, unit scales, zero bias, float32 out: the output is
    the int32 accumulator of TPU kernel row 2, interpreted on the CPU."""
    probe = _probe_module()
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    xq = rng.integers(-127, 128, (2, 6, 7, 32)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 32, 64)).astype(np.int8)
    want = probe.pallas_conv3x3_int8(
        jnp.asarray(np.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)))),
        jnp.asarray(w), co_tile=64)
    got = Q8.conv2d_int8_q(_nchw(xq), 1.0, _oihw(w), torch.ones(64),
                           torch.zeros(64))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("kw,error", [
    (dict(act="logistic"), NotImplementedError),
    (dict(k=5), None), (dict(stride=3), None),
    (dict(float_input=True), TypeError)])
def test_conv2d_int8_q_raises(kw, error):
    k = kw.pop("k", 3)
    xq = torch.zeros((1, 16, 5, 5), dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    if kw.pop("float_input", False):
        xq = xq.float()
    w = torch.zeros((8, 16, k, k), dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    if error is None:
        # any geometry goes through the operator: on the CPU its plain
        # version
        xq = torch.ones_like(xq)
        w = torch.ones_like(w)
        before = Q8.launches_q
        got = Q8.conv2d_int8_q(xq, 1.0, w, torch.ones(8), torch.zeros(8),
                               s_out=1.0, **kw)
        assert Q8.launches_q == before
        torch.testing.assert_close(got, Q8.conv2d_int8_q_plain(
            xq, 1.0, w, torch.ones(8), torch.zeros(8), s_out=1.0, **kw),
            rtol=0, atol=0)
        return
    with pytest.raises(error, match="ROADMAP|input"):
        Q8.conv2d_int8_q(xq, 1.0, w, torch.ones(8), torch.zeros(8),
                         s_out=1.0, **kw)


def test_apply_int8_raises_on_logistic(monkeypatch):
    """It no longer raises: a quantized logistic conv (narrow-leaky's layer
    1) runs the float32-out int8-in entry, the sigmoid, the requantize, and
    equals JAX's apply_int8 at every requantize, as the leaky nets do."""
    cfg, specs = model("narrow-leaky", SIZE)
    specs = specs[:1] + (TS.Conv(16, 3, stride=2, act="logistic"),) + \
        specs[2:]
    jcfg, jspecs = jax_model("narrow-leaky", SIZE)
    jspecs = jspecs[:1] + (type(jspecs[0])(16, 3, stride=2,
                                           act="logistic"),) + jspecs[2:]
    port, jaxp = folded_params(specs, SIZE)
    calib = [images(2, SIZE, seed=3)]
    act = JQ.calibrate_activations(jspecs, jaxp, calib, cfg=jcfg)
    outs = JQ.calibrate_outputs(jspecs, jaxp, calib, cfg=jcfg)
    qparams = JQ.quantize_params(jspecs, jaxp, act,
                                 skip=JQ.head_conv_layers(jspecs))
    assert "w_q" in qparams["L001"]
    x = np.asarray(jax_normalize(jnp.asarray(images(2, SIZE)), jcfg))
    jfeats, jevents = _jax_apply(jspecs, qparams, outs, x, monkeypatch)
    xt = torch.from_numpy(x.copy()).permute(0, 3, 1, 2)
    dets, layers = TQ.apply_int8_layers(specs, TW.params_from_jax(qparams),
                                        outs, xt)
    assert layers[1][0].dtype == torch.int8
    events = _port_events(specs, layers, TQ._requant_from(xt, None,
                                                          outs[-1]),
                          outs, TQ.head_conv_layers(specs))
    assert len(events) == len(jevents)
    counts = [int((got.permute(0, 2, 3, 1).numpy() != np.asarray(want))
                  .sum()) for (_, got), (_, want) in zip(events, jevents)]
    assert counts == [0] * len(counts), counts
    for (feat, _), want in zip(dets, jfeats):
        np.testing.assert_allclose(feat.numpy(), np.asarray(want), **PARITY)


def _exact_fma(a, b, c):
    """a * b + c rounded once to float32, by rational arithmetic."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(v))
    near = [f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf))]
    return min(near, key=lambda n: (abs(Fraction(float(n)) - v),
                                    int(np.asarray(n).view(np.int32)) & 1))


def test_fma_f32_rounds_once(rng):
    n = 3000
    a = rng.integers(-2 ** 20, 2 ** 20, n).astype(np.float32)
    b = (rng.uniform(0.5, 1.5, n) / 1000).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    # exact float32 halfway cases, where rounding the double sum again
    # would tie: 1 + 2**-24 plus or minus a double-only residue
    a[:4] = [1.0, 1.0, 3.0, -3.0]
    b[:4] = [1.0 + 2 ** -23, 1.0 + 2 ** -23, 2 ** -25, 2 ** -25]
    c[:4] = [-(2 ** -23) + 2 ** -24 + 2 ** -40, 2 ** -24, 1.0, -1.0]
    got = Q8.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    want = np.asarray([_exact_fma(*v) for v in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    # the shortcut's fused add
    t = torch.from_numpy(rng.integers(-127, 128, 100000).astype(np.float32))
    o = torch.from_numpy(rng.standard_normal(100000).astype(np.float32))
    s = float(np.float32(0.0312345))
    assert torch.equal(torch.add(o, t, alpha=s),
                       Q8.fma_f32(t, torch.tensor(s), o))


@pytest.mark.parametrize("size,stride", [(2, 2), (2, 1), (3, 1)])
def test_int8_pool_and_upsample(size, stride, rng):
    x = torch.from_numpy(rng.integers(-128, 128, (2, 7, 9, 5)).astype(
        np.int8)).permute(0, 3, 1, 2)
    got = L.max_pool(x, size, stride)
    assert got.dtype == torch.int8
    assert torch.equal(got, L.max_pool(x.float(), size, stride).to(
        torch.int8))
    up = L.upsample_nearest(x, 2)
    assert up.dtype == torch.int8
    assert up.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(up, L.upsample_nearest(x.float(), 2).to(torch.int8))
