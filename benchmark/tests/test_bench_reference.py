"""The plain reference held to the port at a small size on the CPU: the
configurations' layer lists equal the port's specs, the weight draw
follows the port's rule, and the int8 forward and NMS agree with it. This
file imports both sides; the reference's own modules import nothing of
the port."""

import numpy as np
import pytest
import torch

import run as R
import serve_driver as SD
import weights as W
from reference import detect as RD
from reference import model as RM

from yolo_tensorflow_tpu_torch import config as C
from yolo_tensorflow_tpu_torch import pipeline
from yolo_tensorflow_tpu_torch.io.weights import fold_params
from yolo_tensorflow_tpu_torch.models import engine
from yolo_tensorflow_tpu_torch.models import specs as S
from yolo_tensorflow_tpu_torch.ops import quant as Q
from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK

REG = R.Registry()
CONFIGS = ("yolov3-416", "yolov2-416")
SIZE = 64
torch.set_num_threads(2)


def small(name):
    cfg = REG.config(name)
    cfg["input_size"] = SIZE
    model = C.get_config(cfg["model"], input_size=SIZE)
    return cfg, model, C.build_specs(model)


@pytest.mark.parametrize("name", CONFIGS)
def test_layers_equal_port_specs(name):
    cfg = REG.config(name)
    specs = C.build_specs(C.get_config(cfg["model"]))
    assert len(specs) == len(cfg["layers"])
    for sp, lay in zip(specs, cfg["layers"]):
        if isinstance(sp, S.Conv):
            assert (lay["type"], lay["filters"], lay["size"], lay["stride"],
                    lay["bn"], lay["act"], sp.pad) == (
                "conv", sp.filters, sp.size, sp.stride, sp.bn, sp.act, -1)
        elif isinstance(sp, S.Shortcut):
            assert lay == {"type": "shortcut", "from": sp.ref}
        elif isinstance(sp, S.Route):
            assert lay == {"type": "route", "layers": list(sp.refs)}
        elif isinstance(sp, S.Detect):
            assert lay == {"type": "detect", "mask": list(sp.anchor_mask)}
        else:
            assert lay["type"] in ("upsample", "maxpool", "reorg")
    model = C.get_config(cfg["model"])
    assert [list(a) for a in model.anchors] == cfg["anchors"]
    assert (model.num_classes, model.input_size, model.bn_eps,
            model.class_softmax, model.iou_threshold,
            model.max_detections) == (
        cfg["num_classes"], cfg["input_size"], cfg["bn_eps"],
        cfg["class_softmax"], cfg["iou_threshold"], cfg["max_detections"])


@pytest.mark.parametrize("name", CONFIGS)
def test_weight_rule_follows_init_params(name):
    """The draw's scales are engine.init_params': per layer the weights'
    spread, and the batch-norm values' ranges."""
    cfg, model, specs = small(name)
    drawn = W.draw(cfg, 7, torch.device("cpu"))
    params, stats = engine.init_params(specs, SIZE, 7)
    for i, p in drawn.items():
        q = params[engine.layer_key(i)]
        assert sorted(p) == sorted(list(q) + list(stats.get(
            engine.layer_key(i), {})))
        ratio = float(p["w"].std()) / float(np.std(q["w"]))
        assert 0.8 < ratio < 1.25 or p["w"].numel() < 2000
        if "gamma" in p:
            g = np.asarray(q["gamma"])
            assert float(p["gamma"].min()) >= 0.8 * g.min() / 1.2 - 1e-6
            assert float(p["gamma"].max()) <= 1.2 * g.max() / 0.8 + 1e-6
            assert 0.8 <= float(p["var"].min()) <= float(p["var"].max()) \
                <= 1.2


def port_outputs(specs, qparams, frames, model):
    """Every layer's output of the port's bfloat16 int8 network on the
    frames, NCHW."""
    net = engine.Network(specs, qparams, device="cpu", dtype=torch.bfloat16)
    x = pipeline.normalize_images(frames, model, torch.bfloat16)
    with torch.no_grad():
        return net.layer_outputs(x)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_forward_matches_port(name, seed):
    """The reference's int8 forward and the port's bfloat16 int8 network
    from the same seeded weights: every layer before the heads bit for bit
    (its own fold, quantization, exact sums and bfloat16 epilogue), the
    head convolutions within one bfloat16 step of their values, and
    ``RM.forward``'s heads those outputs."""
    cfg, model, specs = small(name)
    drawn = W.draw(cfg, seed, torch.device("cpu"))
    params, stats = SD.port_params(drawn)
    qparams = Q.quantize_params(
        specs, fold_params(params, stats, model.bn_eps),
        {engine.layer_key(i): 0.05 for i, sp in enumerate(specs)
         if isinstance(sp, S.Conv)})
    gen = torch.Generator().manual_seed(3)
    frames = torch.randint(0, 256, (2, SIZE, SIZE, 3), generator=gen,
                           dtype=torch.uint8)
    want = port_outputs(specs, qparams, frames, model)
    x = RD.normalize(frames, cfg["normalization_divisor"])
    folded = {i: RM.fold(p, cfg["bn_eps"]) for i, p in drawn.items()}
    with torch.no_grad():
        got = list(RM.outputs(cfg["layers"], folded, x))
        heads = RM.forward(cfg["layers"], folded, x)
    assert len(got) == len(want)
    heads_at = RM.head_convs(cfg["layers"])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == torch.bfloat16, i
        if i in heads_at or cfg["layers"][i]["type"] == "detect":
            torch.testing.assert_close(g.float(), w.float(), rtol=2 ** -7,
                                       atol=2 ** -7)
        else:
            assert torch.equal(g, w), (i, cfg["layers"][i])
    assert all(torch.equal(h, got[i])
               for (h, _), i in zip(heads, sorted(heads_at)))


@pytest.mark.parametrize("aware", [False, True])
def test_nms_matches_port(aware):
    gen = torch.Generator().manual_seed(5)
    n = 600
    xy = torch.rand((1, n, 2), generator=gen)
    wh = 0.05 + 0.3 * torch.rand((1, n, 2), generator=gen)
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    scores = torch.rand((1, n), generator=gen)
    labels = torch.randint(0, 4, (1, n), generator=gen, dtype=torch.int32)
    cfg = {"conf_threshold": 0.3, "iou_threshold": 0.5,
           "max_detections": 20, "num_candidates": 256,
           "class_aware_nms": aware}
    b, s, lab, valid, num = NK.nms_plain(
        boxes, scores, labels, conf_threshold=0.3, iou_threshold=0.5,
        max_detections=20, num_candidates=256, class_aware=aware)
    rb, rs, rl = RD.nms(boxes[0], scores[0], labels[0], cfg)
    k = int(num[0])
    assert k == len(rs)
    torch.testing.assert_close(rb, b[0, :k])
    torch.testing.assert_close(rs, s[0, :k])
    assert torch.equal(rl, lab[0, :k])
