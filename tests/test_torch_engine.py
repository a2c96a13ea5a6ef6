"""Port engine (yolo_tensorflow_tpu_torch/models/engine.py) vs the JAX
package's engine.apply: raw head outputs on the same numpy parameters and
inputs, f32, rtol 1e-4 / atol 1e-4 (conv sums in different orders compound
over depth; the full yolov3 is 75 convs deep)."""

import numpy as np
import pytest
import torch

import jax

from yolo_tensorflow_tpu.models import engine as JE
from yolo_tensorflow_tpu.models import specs as S
from yolo_tensorflow_tpu_torch.models import engine as TE

from torch_parity import folded_params, model

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,size", [("narrow", 64), ("yolov3-tiny", 64),
                                       ("yolov3", 32)])
def test_heads_match_jax_apply(name, size, rng):
    cfg, specs = model(name, size)
    port_params, jax_params = folded_params(specs, size)
    x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)

    apply = jax.jit(lambda p, x: [f for f, _ in JE.apply(
        specs, p, x, bn_eps=cfg.bn_eps)[0]])
    want = apply(jax_params, x)

    net = TE.Network(specs, port_params)
    with torch.inference_mode():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want)
    for (feat, det), w in zip(got, want):
        assert isinstance(det, S.Detect)
        assert feat.is_contiguous()       # NHWC view of channels-last: free
        np.testing.assert_allclose(feat.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name,size", [("narrow", 64), ("yolov3-tiny", 64),
                                       ("yolov3", 416)])
def test_infer_shapes_match_jax(name, size):
    _, specs = model(name, size)
    shape = (1, size, size, 3)
    assert TE.infer_shapes(specs, shape) == JE.infer_shapes(specs, shape)


@pytest.mark.parametrize("spec,item", [
    (S.Reorg(), "yolov2/yolov1 layers"),
    (S.Dense(10), "yolov2/yolov1 layers"),
    (S.GlobalAvgPool(), "yolov2/yolov1 layers"),
    (S.LRN(), "the long tail"),
    (S.Upsample(2, "bilinear_sym"), "upsample_bilinear_sym")])
def test_unported_layers_raise(spec, item):
    specs = (S.Conv(4, 3), spec)
    with pytest.raises(NotImplementedError, match=item):
        TE.Network(specs, {"L000": {"w": np.zeros((4, 3, 3, 3)),
                                    "b": np.zeros(4)}})


@pytest.mark.parametrize("extra,item", [({"w_q": 0}, "int8"),
                                        ({"gamma": 0}, "training")])
def test_unported_params_raise(extra, item):
    p = {"L000": {"w": np.zeros((4, 3, 3, 3)), "b": np.zeros(4), **extra}}
    with pytest.raises(NotImplementedError, match=item):
        TE.Network((S.Conv(4, 3),), p)
