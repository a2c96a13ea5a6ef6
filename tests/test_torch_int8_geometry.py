"""Int8 convs of any geometry: the port's int8 entries take any square k,
stride and padding (5x5, 3x3 with padding 0, 3x3 stride 3 here) through
their operators, as the JAX package's ``lax.conv_general_dilated`` takes
any geometry: on a CUDA tensor the kernel (its implicit GEMM walks any k,
stride and padding), on a CPU tensor the plain version. Against the JAX
package on the same inputs, with the tolerances of the 7x7 cases in
tests/test_torch_quant.py and tests/test_torch_int8act.py:

- ``conv2d_int8`` (mixed entry) against the jitted JAX ``conv2d_int8`` (+
  leaky): bfloat16 exactly, float32 within 1 ulp.
- ``conv2d_int8_q`` (int8-in entry) against JAX's apply_int8 formula for
  one layer: int8 and float32 outputs equal; also at first convs (Cin 3)
  on the direct kernel's tile edges (``torch_parity.DIRECT_EDGES``).
- The narrow net ``narrow-geom`` written as a darknet .cfg and read back by
  each package's ``config_from_cfg``, its params quantized by the JAX
  package: the mixed int8 Detector and the all-int8-activation forward give
  JAX's num, classes and valid, boxes and scores within rtol 1e-4 /
  atol 1e-5.
On CPU tensors no launch is counted; on the card every int8 conv of the
net launches the kernel (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from yolo_tensorflow_tpu import config as JC
from yolo_tensorflow_tpu.ops import layers as JL
from yolo_tensorflow_tpu.ops import quant as JQ
from yolo_tensorflow_tpu_torch import config as TC
from yolo_tensorflow_tpu_torch.io import cfg as TCfg
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.models import engine as TE
from yolo_tensorflow_tpu_torch.models import specs as TS
from yolo_tensorflow_tpu_torch.ops import quant as TQ
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as K

from torch_parity import DIRECT_EDGES, folded_params, images, model, to_jax

SIZE = 64
PARITY = dict(rtol=1e-4, atol=1e-5)
OPTS = dict(conf_threshold=0.2, num_candidates=64)
GEOMETRIES = [(5, 1, 2), (3, 1, 0), (3, 3, 1), (5, 2, 2)]   # k, stride, pad
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1))).contiguous(
            memory_format=torch.channels_last)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _record_ops(monkeypatch):
    """Replace the two conv operators with recorders that call them: a list
    of (operator, stride, pad) of every call."""
    calls = []
    for name in ("conv_op", "conv_q_op"):
        def rec(*a, _op=getattr(K, name), _name=name):
            calls.append((_name, a[5], a[6]))
            return _op(*a)
        monkeypatch.setattr(K, name, rec)
    return calls


@pytest.mark.parametrize("k,stride,pad", GEOMETRIES)
def test_kernel_geometry_routes(k, stride, pad, monkeypatch, rng):
    """Both entries take the geometry through their operator, which on the
    card launches the kernel, and the plan is a kernel instance."""
    calls = _record_ops(monkeypatch)
    x = _nchw(rng.standard_normal((1, 9, 9, 16), dtype=np.float32)).contiguous(
        memory_format=torch.channels_last)
    xq = _nchw(rng.integers(-127, 128, (1, 9, 9, 16)).astype(
        np.int8)).contiguous(memory_format=torch.channels_last)
    w = _oihw(rng.integers(-127, 128, (k, k, 16, 8)).astype(np.int8))
    s_w, b = torch.full((8,), 0.01), torch.zeros(8)
    y = K.conv2d_int8(x, w, 0.05, s_w, b, stride=stride, pad=pad)
    yq = K.conv2d_int8_q(xq, 0.05, w, s_w, b, stride=stride, pad=pad,
                         s_out=0.1)
    assert calls == [("conv_op", stride, pad), ("conv_q_op", stride, pad)]
    ho = (9 + 2 * pad - k) // stride + 1
    assert y.shape == yq.shape == (1, 8, ho, ho)
    assert K.plan(x, w)[0] in ("wgmma", "gather")
    assert K.plan_q(xq, w)[0] in ("wgmma", "gather")


@pytest.mark.parametrize("act", ["linear", "leaky"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,pad", GEOMETRIES)
def test_conv2d_int8_any_geometry_matches_jax(k, stride, pad, dtype, act,
                                              rng):
    tdt, jdt = DTYPES[dtype]
    x = jnp.asarray(rng.standard_normal((2, 11, 13, 16), dtype=np.float32)
                    * 2).astype(jdt)
    w = rng.integers(-127, 128, (k, k, 16, 24)).astype(np.int8)
    s_w = (rng.uniform(0.5, 1.5, 24) / 127).astype(np.float32)
    s_x = np.float32(0.031)
    b = rng.standard_normal(24).astype(np.float32)

    def jax_fn(x, w, s_w, b):
        y = JQ.conv2d_int8(x, w, s_x, s_w, b, stride=stride, pad=pad,
                           epilogue_dtype=jdt)
        return JL.leaky_relu(y) if act == "leaky" else y

    want = np.asarray(jax.jit(jax_fn)(x, jnp.asarray(w), jnp.asarray(s_w),
                                      jnp.asarray(b)).astype(jnp.float32))
    before = K.launches
    got = K.conv2d_int8(
        _nchw(np.asarray(x.astype(jnp.float32))).to(tdt).contiguous(
            memory_format=torch.channels_last), _oihw(w), s_x,
        torch.from_numpy(s_w), torch.from_numpy(b), stride=stride, pad=pad,
        act=act, epilogue_dtype=tdt)
    assert K.launches == before
    assert got.dtype == tdt
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        assert _ulps(got, want).max() <= 1


@pytest.mark.parametrize("out", ["int8", "float32"])
@pytest.mark.parametrize("act", ["linear", "leaky"])
@pytest.mark.parametrize("k,stride,pad", GEOMETRIES)
def test_conv2d_int8_q_any_geometry_matches_jax(k, stride, pad, act, out,
                                                rng):
    xq = rng.integers(-127, 128, (2, 11, 13, 16)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, 16, 24)).astype(np.int8)
    s_w = (rng.uniform(0.5, 1.5, 24) / 127).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    s_in, s_out = 0.0123, (0.0377 if out == "int8" else None)

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
    before = K.launches_q
    got = K.conv2d_int8_q(_nchw(xq).contiguous(
        memory_format=torch.channels_last), s_in, _oihw(w),
        torch.from_numpy(s_w), torch.from_numpy(b), stride=stride, pad=pad,
        act=act, s_out=s_out)
    assert K.launches_q == before
    assert got.dtype == (torch.int8 if s_out else torch.float32)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("out", ["int8", "float32"])
@pytest.mark.parametrize("k,stride,pad,cout,h,w", DIRECT_EDGES)
def test_first_conv_q_tile_edges_match_jax(k, stride, pad, cout, h, w, out,
                                           rng):
    """The int8-in entry at first convs on the direct kernel's tile edges
    (H, W off its 8 x 32 output tile times the stride, B = 3), leaky,
    against JAX's apply_int8 formula for one layer: equal, as above."""
    xq = rng.integers(-127, 128, (3, h, w, 3)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, k, 3, cout)).astype(np.int8)
    s_w = (rng.uniform(0.5, 1.5, cout) / 127).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    s_in, s_out = 0.0123, (0.0377 if out == "int8" else None)

    def jax_fn(xq, wq, s_w, b):
        acc = lax.conv_general_dilated(
            xq, wq, (stride, stride), ((pad, pad), (pad, pad)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        y = JL.leaky_relu(acc.astype(jnp.float32) * (s_in * s_w) + b)
        return y if s_out is None else JQ._requant(y, s_out)

    want = np.asarray(jax.jit(jax_fn)(xq, wq, s_w, b))
    xt = _nchw(xq).contiguous(memory_format=torch.channels_last)
    # int8 out takes the direct kernel where Cout fills 16-byte stores
    assert (K.plan_q(xt, _oihw(wq), out == "int8")[0] == "direct") == (
        out == "float32" or cout % 16 == 0)
    before = K.launches_q
    got = K.conv2d_int8_q(xt, s_in, _oihw(wq), torch.from_numpy(s_w),
                          torch.from_numpy(b), stride=stride, pad=pad,
                          act="leaky", s_out=s_out)
    assert K.launches_q == before
    assert got.dtype == (torch.int8 if s_out else torch.float32)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.fixture(scope="module")
def geom(tmp_path_factory):
    """narrow-geom through a darknet .cfg: (port cfg, port specs, JAX cfg,
    JAX specs, JAX folded params, JAX int8 params (heads float), JAX
    output scales)."""
    cfg, specs = model("narrow-geom", SIZE)
    path = tmp_path_factory.mktemp("geom") / "geom.cfg"
    path.write_text(TCfg.specs_to_cfg(cfg, specs))
    names = tmp_path_factory.getbasetemp() / "geom.names"
    names.write_text("a\nb\nc\nd\n")
    tcfg, tspecs = TC.config_from_cfg(str(path), class_names_file=str(names))
    jcfg, jspecs = JC.config_from_cfg(str(path), class_names_file=str(names))
    convs = [s for s in tspecs if isinstance(s, TS.Conv)]
    assert [(s.size, s.stride, s.pad) for s in convs[1:4]] == [
        (5, 1, 2), (3, 1, 0), (3, 3, 1)]
    port, _ = folded_params(tspecs, SIZE)
    jaxp = to_jax(port)
    calib = [images(2, SIZE, seed=3)]
    act = JQ.calibrate_activations(jspecs, jaxp, calib, cfg=jcfg)
    outs = JQ.calibrate_outputs(jspecs, jaxp, calib, cfg=jcfg)
    qparams = JQ.quantize_params(jspecs, jaxp, act,
                                 skip=JQ.head_conv_layers(jspecs))
    return tcfg, tspecs, jcfg, jspecs, jaxp, qparams, outs


def _same_detections(got, want):
    assert (got.num > 0).all()
    for name in ("num", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   **PARITY, err_msg=name)


def test_int8_detector_any_geometry_matches_jax(geom, monkeypatch):
    from yolo_tensorflow_tpu.pipeline import Detector as JaxDetector
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    cfg, specs, jcfg, jspecs, _, qparams, _ = geom
    imgs = images(2, SIZE)
    want = JaxDetector(jcfg, params=qparams, specs=jspecs,
                       **OPTS).detect_batch(imgs)
    det = Detector(cfg, params=TW.params_from_jax(qparams), specs=specs,
                   device="cpu", **OPTS)
    quant = [m for m in det.network.modules()
             if isinstance(m, TE.QuantConv)]
    assert len(quant) == 5
    assert {(m.w_q.shape[-1], m.stride, m.pad) for m in quant} >= {
        (5, 1, 2), (3, 1, 0), (3, 3, 1)}
    calls = _record_ops(monkeypatch)
    before = K.launches
    _same_detections(det.detect_batch(imgs), want)
    assert K.launches == before
    assert [c[0] for c in calls] == ["conv_op"] * 5


def test_int8_forward_any_geometry_matches_jax(geom):
    cfg, specs, jcfg, jspecs, _, qparams, outs = geom
    imgs = images(2, SIZE)
    want = jax.jit(JQ.make_int8_forward(jcfg, jspecs, outs, **OPTS))(
        qparams, imgs)
    fwd = TQ.make_int8_forward(cfg, specs, outs, **OPTS)
    before = K.launches_q
    got = fwd(TQ.int8_params_to(TW.params_from_jax(qparams), "cpu"),
              torch.from_numpy(imgs))
    assert K.launches_q == before
    _same_detections(got, want)
