"""The yolo_torch operators (ops/kernels/library.py) on the CPU.

- Each of decode, nms, quantize_act, conv2d_int8 and conv2d_int8_q has a
  CPU, a CUDA and a fake (Meta) kernel registered.
- A fake call (FakeTensorMode, no data, no card) gives the shapes, dtypes
  and strides that the real CPU call returns on the same inputs, at each
  case below; the fake calls launch nothing (the counts stay 0).
- The wrappers reach the operators: a CPU call through the wrapper equals
  the plain version bit for bit and launches nothing.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from yolo_tensorflow_tpu_torch.models import heads
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
from yolo_tensorflow_tpu_torch.ops.kernels import library
from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK

OPS = ("decode", "nms", "quantize_act", "conv2d_int8", "conv2d_int8_q")


@pytest.mark.parametrize("name", OPS)
def test_cpu_cuda_and_fake_kernels_registered(name):
    qual = f"{library.NAMESPACE}::{name}"
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), key


def _same_meta(real, fake):
    real = real if isinstance(real, (tuple, list)) else (real,)
    fake = fake if isinstance(fake, (tuple, list)) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype,
                                                  r.stride())
        assert f.device.type == "cpu"


def _fake_matches(op, *args):
    """op on real CPU tensors against op under FakeTensorMode on fakes of
    the same tensors; no launch counted."""
    counts = (K.launches, NK.launches, Q8.launches, Q8.launches_q)
    real = op(*args)
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                 else [mode.from_tensor(t) for t in a]
                 if isinstance(a, list) and a
                 and isinstance(a[0], torch.Tensor) else a for a in args]
        fake = op(*fargs)
    _same_meta(real, fake)
    assert (K.launches, NK.launches, Q8.launches, Q8.launches_q) == counts
    return real


DECODE = [((13, 26), 3, 80, False, False), ((13,), 5, 20, True, False),
          ((7, 14, 28), 3, 4, False, True), ((1,), 1, 1, False, False)]


@pytest.mark.parametrize("grids,anchors,classes,softmax,bf16", DECODE)
def test_decode_fake_matches_real(grids, anchors, classes, softmax, bf16):
    rng = np.random.default_rng(0)
    feats = [torch.from_numpy(rng.standard_normal(
        (2, g, g, anchors * (5 + classes)), dtype=np.float32))
        for g in grids]
    flat = [float(v) for _ in grids for a in range(anchors)
            for v in (10.0 + a, 13.0 + a)]
    out = _fake_matches(K.decode_op, feats, flat, [anchors] * len(grids),
                        416, classes, softmax, bf16)
    assert out[0].shape == (2, sum(g * g * anchors for g in grids), 4)


@pytest.mark.parametrize("k,d,class_aware", [(64, 20, False), (8, 20, True),
                                             (256, 100, False)])
def test_nms_fake_matches_real(k, d, class_aware):
    """The unranked decode of 3 images of 200 rows, K = min(k, 200)."""
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 0.8, (3, 200, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(0.05, 0.2, (3, 200, 2)).astype(np.float32)],
        -1))
    scores = torch.from_numpy(rng.uniform(0, 1, (3, 200)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, (3, 200)).astype(np.int32))
    out = _fake_matches(NK.nms_op, boxes, scores, labels, 0.3, 0.45, d, k,
                        class_aware)
    assert [t.shape for t in out] == [(3, d, 4), (3, d), (3, d), (3, d),
                                      (3,)]
    assert out[4].sum() > 0


def _x(rng, b, c, h, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal((b, c, h, h)).astype(
        np.float32)).to(dtype).contiguous(memory_format=torch.channels_last)


def _w(rng, cout, cin, k):
    return torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k))
                            .astype(np.int8)).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_fake_matches_real(dtype):
    q = _fake_matches(Q8.quantize_op, _x(np.random.default_rng(2), 2, 8, 5,
                                        dtype), 0.05)
    assert q.dtype == torch.int8


CONV = [(3, 1, 8, 16, 9, torch.float32, True),
        (1, 1, 16, 24, 7, torch.bfloat16, False),
        (3, 2, 3, 16, 11, torch.float32, True),
        (7, 2, 3, 8, 13, torch.bfloat16, True)]


@pytest.mark.parametrize("k,stride,cin,cout,h,epi,leaky", CONV)
def test_conv_int8_fake_matches_real(k, stride, cin, cout, h, epi, leaky):
    rng = np.random.default_rng(3)
    s_w = torch.full((cout,), 0.01)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    y = _fake_matches(Q8.conv_op, _x(rng, 2, cin, h), _w(rng, cout, cin, k),
                      0.05, s_w, b, stride, k // 2, leaky, epi)
    assert y.dtype == epi and y.is_contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("s_out", [None, 0.1])
@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)])
def test_conv_int8_q_fake_matches_real(k, stride, s_out):
    rng = np.random.default_rng(4)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 16, 9, 9)).astype(
        np.int8)).contiguous(memory_format=torch.channels_last)
    y = _fake_matches(Q8.conv_q_op, xq, 0.05, _w(rng, 24, 16, k),
                      torch.full((24,), 0.01), torch.zeros(24), stride,
                      k // 2, True, s_out)
    assert y.dtype == (torch.float32 if s_out is None else torch.int8)


def test_wrappers_reach_the_operators_on_cpu():
    """Through the wrappers a CPU input runs the plain versions, bit for
    bit, and launches nothing."""
    rng = np.random.default_rng(5)
    before = (K.launches, NK.launches, Q8.launches, Q8.launches_q)
    feat = torch.from_numpy(rng.standard_normal((2, 5, 5, 3 * 9)).astype(
        np.float32))
    anchors = [(10.0, 13.0), (16.0, 30.0), (33.0, 23.0)]
    got = K.decode_scale_fused(feat, anchors, 160, 4)
    want = K.decode_scale_plain(feat, anchors, 160, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x, w = _x(rng, 2, 8, 6), _w(rng, 16, 8, 3)
    s_w, b = torch.full((16,), 0.01), torch.zeros(16)
    assert torch.equal(Q8.conv2d_int8(x, w, 0.05, s_w, b, act="leaky"),
                       Q8.conv2d_int8_plain(x, w, 0.05, s_w, b, act="leaky"))
    decoded = heads.xywh_to_xyxy(want[0]), want[1], want[2]
    kw = dict(conf_threshold=0.2, iou_threshold=0.45, max_detections=10,
              num_candidates=32, class_aware=False)
    assert all(torch.equal(a, b) for a, b in zip(
        NK.greedy_nms(*decoded, **kw), NK.nms_plain(*decoded, **kw)))
    assert (K.launches, NK.launches, Q8.launches, Q8.launches_q) == before
