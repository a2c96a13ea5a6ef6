"""The port trains a detector: the counterpart of
tests/test_train_convergence.py on the CPU. Each loss family overfits one
synthetic single-object batch at 64 px (yolov3-tiny, yolov2-tiny-voc with
darknet's region loss, yolov1-tiny on a 4x4 grid with its detection-layer
loss), then its folded parameters detect the object through the port's
Detector. The gates are the JAX test's: the cost falls under 0.2x its value
at step 5, and the best detection's IoU with the truth passes 0.45 (0.4 for
v1).

The runs are full-width models trained eagerly on the CPU, dominated by
the backward of 1024-channel convs at a 2x2 grid; the module runs them on
4 threads with oneDNN off (PyTorch's own CPU convolution takes about 0.6x
oneDNN's time at these shapes), both restored afterwards.
"""

import dataclasses

import numpy as np
import pytest
import torch

from yolo_tensorflow_tpu_torch import config as C
from yolo_tensorflow_tpu_torch.io.weights import fold_params
from yolo_tensorflow_tpu_torch.pipeline import Detector
from yolo_tensorflow_tpu_torch.train import loop as T

SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _cpu_settings():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(threads)


def _batch(n, rng):
    imgs = np.full((n, SIZE, SIZE, 3), 30, np.uint8)
    truths = np.zeros((n, 2, 5), np.float32)
    for b in range(n):
        w, h = int(rng.integers(28, 48)), int(rng.integers(28, 48))
        x0 = int(rng.integers(0, SIZE - w))
        y0 = int(rng.integers(0, SIZE - h))
        imgs[b, y0:y0 + h, x0:x0 + w] = 220
        truths[b, 0] = [(x0 + w / 2) / SIZE, (y0 + h / 2) / SIZE,
                        w / SIZE, h / SIZE, 0]
    return imgs, truths


def _iou(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua


def _overfit(cfg, lr, burn_in, steps, seed, rng):
    tx = T.make_optimizer(T.darknet_lr_schedule(lr, burn_in=burn_in),
                          weight_decay=0)
    state = T.create_train_state(cfg, tx, seed=seed, input_size=SIZE,
                                 device="cpu")
    step = T.make_train_step(cfg, tx, input_size=SIZE)
    imgs, truths = _batch(4, rng)
    costs = []
    for _ in range(steps):
        state, m = step(state, imgs, truths)
        costs.append(float(m["cost"]))
    assert np.isfinite(costs).all(), costs
    assert costs[-1] < costs[5] * 0.2, (costs[5], costs[-1])
    return fold_params(state.params, state.batch_stats, cfg.bn_eps), imgs, \
        truths


def _best_iou(res, t):
    assert res, "no detections after overfitting"
    tb = ((t[0] - t[2] / 2) * SIZE, (t[1] - t[3] / 2) * SIZE,
          (t[0] + t[2] / 2) * SIZE, (t[1] + t[3] / 2) * SIZE)
    return max(_iou(r["box"], tb) for r in res)


@pytest.mark.parametrize("model,steps,lr", [
    ("yolov3-tiny", 120, 1e-3),
    ("yolov2-tiny-voc", 150, 5e-4),       # darknet region loss (default)
])
def test_overfit_then_detect(model, steps, lr, rng):
    torch.manual_seed(0)
    cfg = C.get_config(model, input_size=SIZE)
    folded, imgs, truths = _overfit(cfg, lr, 15, steps, 0, rng)
    det = Detector(model, params=folded, input_size=SIZE, device="cpu",
                   conf_threshold=0.3, num_candidates=64)
    best = _best_iou(det.detect(imgs[0]), truths[0, 0])
    assert best > 0.45, best


def test_overfit_v1_then_detect(rng):
    """v1's detection-layer loss (detection_layer.c:50) trains yolov1-tiny
    on the task; the grid head decodes through the Detector."""
    torch.manual_seed(0)
    cfg = dataclasses.replace(C.get_config("yolov1-tiny"), input_size=SIZE,
                              custom_classes=("obj",), grid=4,
                              boxes_per_cell=2)
    folded, imgs, truths = _overfit(cfg, 2e-4, 20, 200, 1, rng)
    det = Detector(cfg, params=folded, device="cpu", conf_threshold=0.25,
                   num_candidates=32)
    best = _best_iou(det.detect(imgs[0]), truths[0, 0])
    assert best > 0.4, best
