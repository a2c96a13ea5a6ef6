"""The count module reproduces the bounds recorded before the benchmark
(PERF.md: the int8 convolutions at B=256) and the forward FLOPs of the
port's ``utils/summary``."""

import pytest

import counts
import run as R

REG = R.Registry()


@pytest.mark.parametrize("config,batch,total,by_bytes,by_ops", [
    ("yolov3-416", 256, 15.119, 8.724, 6.396),
    ("yolov2-416", 256, 5.961, 2.969, 2.992),
])
def test_int8_bound(config, batch, total, by_bytes, by_ops):
    b = counts.int8_bound_s(REG.config(config), batch)
    assert round(b["total"] * 1e3, 3) == total
    assert round(b["bytes"] * 1e3, 3) == by_bytes
    assert round(b["ops"] * 1e3, 3) == by_ops


@pytest.mark.parametrize("config", ["yolov3-416", "yolov2-416"])
def test_forward_flops_equal_summary(config):
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.utils import summary
    cfg = REG.config(config)
    line = summary.summarize(C.get_config(cfg["model"])).splitlines()[-1]
    want = float(line.split()[-2])
    assert round(counts.forward_flops(cfg) / 1e9, 1) == want
    assert len(counts.int8_convs(cfg)) == {"yolov3-416": 72,
                                           "yolov2-416": 22}[config]
