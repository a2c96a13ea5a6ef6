"""The synthetic-shapes task and the in-process training demo, on the card.

The port's counterpart of tools/synthetic_train_demo.py: the same scene
generator (``make_scene``, ``make_batch``; every cv2 call replaced by
``tools.raster``, which paints cv2's pixels, and the same rng draws in the
same order, so boxes and labels are those of the original for a seed) and
the same demo: train a detector from scratch on 3 easy or 12 hard shape
classes, then score held-out scenes with mAP@0.5 through
``eval.batched.detect_images`` in five legs: float, flip-TTA in darknet's
and in the corrected mode, int8 PTQ (calibrated on training scenes) and
int8 QAT (a fine-tune against the int8 lattice, ``ops.qat.export_int8``).
Needs no cv2: the scenes are at the input size, so the stretch Detector
takes them as they are.

Usage:  python -m yolo_tensorflow_tpu_torch.tools.synthetic_train_demo
            [steps] [model] [hard] [onepass] [seed=N] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from yolo_tensorflow_tpu_torch.tools import raster

SIZE = 160
CLASSES = ("circle", "square", "triangle")
# 12 classes: polygons with adjacent vertex counts (pentagon/hexagon/
# circle), aspect-ambiguous pairs (square/rect, circle/ellipse), outline vs
# fill (circle/ring), clutter and a lower size floor keep mAP mid-range
HARD_CLASSES = ("circle", "square", "triangle", "ellipse", "rect",
                "diamond", "plus", "ring", "star", "semicircle",
                "pentagon", "hexagon")


def _poly(cx, cy, r, n, rot):
    ang = rot + 2 * np.pi * np.arange(n) / n
    return np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                    1).astype(np.int32)


def _draw_shape(img, cls, cx, cy, s, color, rng):
    h = s // 2
    if cls == 0:
        raster.circle(img, (cx, cy), h, color, -1)
    elif cls == 1:
        raster.rectangle(img, (cx - h, cy - h), (cx + h, cy + h), color, -1)
    elif cls == 2:
        raster.fill_poly(img, [np.asarray([(cx, cy - h), (cx - h, cy + h),
                                           (cx + h, cy + h)], np.int32)],
                         color)
    elif cls == 3:  # ellipse, distinctly non-circular
        ax = (h, max(3, int(h * rng.uniform(0.45, 0.65))))
        if rng.integers(0, 2):
            ax = ax[::-1]
        raster.ellipse(img, (cx, cy), ax, 0, 0, 360, color, -1)
        return (cx - ax[0], cy - ax[1], cx + ax[0], cy + ax[1])
    elif cls == 4:  # rect, distinctly non-square
        w2 = max(3, int(h * rng.uniform(0.45, 0.65)))
        if rng.integers(0, 2):
            raster.rectangle(img, (cx - h, cy - w2), (cx + h, cy + w2), color,
                             -1)
            return (cx - h, cy - w2, cx + h, cy + w2)
        raster.rectangle(img, (cx - w2, cy - h), (cx + w2, cy + h), color, -1)
        return (cx - w2, cy - h, cx + w2, cy + h)
    elif cls == 5:  # diamond
        raster.fill_poly(img, [np.asarray([(cx, cy - h), (cx + h, cy),
                                           (cx, cy + h), (cx - h, cy)],
                                          np.int32)], color)
    elif cls == 6:  # plus
        t = max(2, s // 6)
        raster.rectangle(img, (cx - t, cy - h), (cx + t, cy + h), color, -1)
        raster.rectangle(img, (cx - h, cy - t), (cx + h, cy + t), color, -1)
    elif cls == 7:  # ring
        raster.circle(img, (cx, cy), h, color, max(2, s // 5))
    elif cls == 8:  # 5-point star
        rot = -np.pi / 2
        outer = _poly(cx, cy, h, 5, rot)
        inner = _poly(cx, cy, max(2, int(h * 0.42)), 5, rot + np.pi / 5)
        pts = np.empty((10, 2), np.int32)
        pts[0::2], pts[1::2] = outer, inner
        raster.fill_poly(img, [pts], color)
    elif cls == 9:  # semicircle, random flat side; tight half-disc box
        r = int(rng.integers(0, 4))
        raster.ellipse(img, (cx, cy), (h, h), r * 90, 0, 180, color, -1)
        return ((cx - h, cy, cx + h, cy + h),        # bottom half
                (cx - h, cy - h, cx, cy + h),        # left
                (cx - h, cy - h, cx + h, cy),        # top
                (cx, cy - h, cx + h, cy + h))[r]     # right
    elif cls == 10:
        raster.fill_poly(img, [_poly(cx, cy, h, 5, -np.pi / 2)], color)
    else:
        raster.fill_poly(img, [_poly(cx, cy, h, 6, 0)], color)
    return None


def make_scene(rng, hard=False, size=SIZE):
    """One synthetic scene at ``size``x``size``. Geometry (shape sizes,
    clutter density) scales with size/SIZE so the 416px flagship task is
    the same distribution as the 160px one, just rendered larger."""
    sc = size / SIZE
    img = rng.integers(0, 60, (size, size, 3), dtype=np.uint8)
    ncls = len(HARD_CLASSES) if hard else 3
    if hard:
        # clutter that is not an object: dim lines and tiny specks
        for _ in range(int(rng.integers(2, 6))):
            p0 = tuple(int(v) for v in rng.integers(0, size, 2))
            p1 = tuple(int(v) for v in rng.integers(0, size, 2))
            raster.line(img, p0, p1,
                        tuple(int(c) for c in rng.integers(40, 100, 3)),
                        max(1, int(rng.integers(1, 3) * sc)))
        for _ in range(int(rng.integers(0, 8))):
            raster.circle(img,
                          tuple(int(v) for v in rng.integers(0, size, 2)),
                          max(1, int(rng.integers(1, 3) * sc)),
                          tuple(int(c) for c in rng.integers(40, 110, 3)), -1)
    boxes = []
    lo, hi = (16, 56) if hard else (24, 64)
    lo, hi = max(6, int(lo * sc)), int(hi * sc)
    for _ in range(int(rng.integers(1, 6 if hard else 4))):
        cls = int(rng.integers(0, ncls))
        s = int(rng.integers(lo, hi))
        cx = int(rng.integers(s // 2 + 2, size - s // 2 - 2))
        cy = int(rng.integers(s // 2 + 2, size - s // 2 - 2))
        color = tuple(int(c) for c in rng.integers(120, 255, 3))
        tight = _draw_shape(img, cls, cx, cy, s, color, rng)
        if tight is None:
            tight = (cx - s // 2, cy - s // 2, cx + s // 2, cy + s // 2)
        x0, y0, x1, y1 = tight
        boxes.append([(x0 + x1) / 2 / size, (y0 + y1) / 2 / size,
                      (x1 - x0) / size, (y1 - y0) / size, cls])
    return img, np.asarray(boxes, np.float32)


def make_batch(rng, n, max_boxes=8, hard=False, size=SIZE):
    from yolo_tensorflow_tpu_torch.data.augment import pad_truths
    imgs = np.empty((n, size, size, 3), np.uint8)
    tr = np.empty((n, max_boxes, 5), np.float32)
    for i in range(n):
        imgs[i], b = make_scene(rng, hard=hard, size=size)
        tr[i] = pad_truths(b, max_boxes)
    return imgs, tr


def scene_truth(boxes, size):
    """A scene's (cx, cy, w, h, cls) rows -> the ground truth of
    ``eval.map.evaluate_detections`` (xyxy pixels)."""
    b = np.asarray(boxes, np.float32).reshape(-1, 5)
    return {"boxes": np.stack([(b[:, 0] - b[:, 2] / 2) * size,
                               (b[:, 1] - b[:, 3] / 2) * size,
                               (b[:, 0] + b[:, 2] / 2) * size,
                               (b[:, 1] + b[:, 3] / 2) * size], 1),
            "classes": b[:, 4].astype(np.int32)}


def score_detector(det, images, gts, num_classes, *, batch_size,
                   num_workers=4):
    """(evaluate_detections result, seconds): ``det`` over ``images``
    through the batched pipeline (warmed on one batch first), scored
    against ``gts``."""
    from yolo_tensorflow_tpu_torch.eval.batched import detect_images
    from yolo_tensorflow_tpu_torch.eval.map import evaluate_detections
    size = det.cfg.input_size
    det.detect_batch(np.zeros((batch_size, size, size, 3), np.uint8))
    t = time.time()
    results = detect_images(det, images, batch_size=batch_size,
                            num_workers=num_workers)
    dt = time.time() - t
    dets = [{
        "boxes": np.asarray([r["box"] for r in res],
                            np.float32).reshape(-1, 4),
        "scores": np.asarray([r["score"] for r in res], np.float32),
        "classes": np.asarray([r["class_id"] for r in res], np.int32)}
        for res in results]
    return evaluate_detections(dets, gts, num_classes), dt


def _numpy(tree):
    from yolo_tensorflow_tpu_torch.train.loop import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def main(steps=1200, batch=32, model="yolov3-tiny", hard=False,
         bn_stats="twopass", seed=0, device="cuda"):
    """Train ``model`` from scratch for ``steps`` on the easy (3 classes,
    float32) or hard (12 classes, bf16) task, then score the five legs on
    the held-out scenes (seed 777). Returns {leg: mAP@0.5}: "float",
    "flip-TTA[darknet]", "flip-TTA[corrected]", "int8 PTQ", "int8 QAT"."""
    import torch
    cudnn = torch.backends.cudnn
    # the easy run trains f32 so that its numbers are stable: on the card
    # that needs cuDNN's deterministic algorithms, since its default f32
    # backward gives another result on each run (the bf16 one does not)
    deterministic = cudnn.deterministic
    cudnn.deterministic = deterministic or not hard
    try:
        return _train_and_score(steps, batch, model, hard, bn_stats, seed,
                                device)
    finally:
        cudnn.deterministic = deterministic


def _train_and_score(steps, batch, model, hard, bn_stats, seed, device):
    import dataclasses

    import torch

    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io.weights import fold_params
    from yolo_tensorflow_tpu_torch.ops import qat as QA
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    from yolo_tensorflow_tpu_torch.pipeline import Detector
    from yolo_tensorflow_tpu_torch.train import loop as T

    device = torch.device(device)
    classes = HARD_CLASSES if hard else CLASSES
    if model == "yolov2-tiny-voc":
        # v2 via the darknet region loss; anchors scaled to the shapes task
        # (grid units at stride 32 -> grid 5 for 160px input)
        cfg = dataclasses.replace(
            C.get_config("yolov2-tiny-voc", input_size=SIZE),
            custom_classes=classes,
            anchors=((0.8, 0.8), (1.5, 1.5), (2.4, 2.4)))
    elif hard:
        cfg = dataclasses.replace(C.get_config(model, input_size=SIZE),
                                  custom_classes=classes)
    else:
        cfg = C.get_config(model, input_size=SIZE)
    specs = C.build_specs(cfg)
    tx = T.make_optimizer(T.darknet_lr_schedule(1e-3, burn_in=100),
                          weight_decay=5e-4)
    state = T.create_train_state(cfg, tx, seed=seed, input_size=SIZE,
                                 specs=specs, device=device)
    # the hard run trains mixed-precision (the production mode); the
    # 3-class baseline stays exact-f32 so its recorded numbers are stable
    dtype = torch.bfloat16 if hard else None
    step = T.make_train_step(cfg, tx, input_size=SIZE, specs=specs,
                             compute_dtype=dtype, bn_stats=bn_stats)

    rng = np.random.default_rng(seed)
    pool = [make_batch(rng, batch, hard=hard)
            for _ in range(80 if hard else 40)]  # fresh-ish data
    print(f"training {cfg.name} on synthetic shapes: {steps} steps, "
          f"batch {batch}, {SIZE}x{SIZE}, device {device}", flush=True)
    t0 = time.time()
    for i in range(steps):
        imgs, tr = pool[i % len(pool)]
        state, m = step(state, imgs, tr)
        if (i + 1) % 150 == 0 or i == 0:
            print(f"step {i+1:5d}: cost {float(m['cost']):9.2f} "
                  f"avg_iou {float(m['avg_iou']):.3f} "
                  f"obj {float(m['avg_obj']):.3f} "
                  f"({batch*(i+1)/(time.time()-t0):.0f} img/s)", flush=True)
    print(f"trained in {time.time()-t0:.0f}s", flush=True)

    folded = fold_params(state.params, state.batch_stats, cfg.bn_eps)

    # held-out scenes once; every leg runs through the batched pipeline
    erng = np.random.default_rng(777)
    scenes = [make_scene(erng, hard=hard) for _ in range(200 if hard else 100)]
    gts = [scene_truth(b, SIZE) for _, b in scenes]
    imgs_eval = [img for img, _ in scenes]
    results = {}

    def eval_batched(det, label, key):
        out, dt = score_detector(det, imgs_eval, gts, len(classes),
                                 batch_size=20)
        print(f"{label}: mAP@0.5 = {out['map']:.4f} "
              f"({len(imgs_eval)/dt:.0f} img/s batched eval)  per-class "
              f"{ {classes[c]: round(v, 3) for c, v in out['ap_per_class'].items()} }",
              flush=True)
        results[key] = float(out["map"])
        return out

    nms = dict(conf_threshold=0.3, iou_threshold=0.45, max_detections=10)
    det = Detector(cfg, params=folded, specs=specs, device=device, **nms)
    out = eval_batched(det, "held-out", "float")

    # flip-TTA eval (validate_detector_flip / region TTA) — measured delta
    for mode in ("darknet", "corrected"):
        det_tta = Detector(cfg, params=folded, specs=specs, device=device,
                           tta=True, tta_mode=mode, **nms)
        out_t = eval_batched(det_tta, f"flip-TTA[{mode}]",
                             f"flip-TTA[{mode}]")
        print(f"  flip-TTA[{mode}] mAP delta {out_t['map'] - out['map']:+.4f}",
              flush=True)

    # int8: calibrate on training scenes, quantize, re-evaluate
    calib = [pool[i][0][:8] for i in range(8)]
    scales = Q.calibrate_activations(specs, folded, calib, cfg=cfg,
                                     device=device)
    qparams = Q.quantize_params(specs, folded, scales)
    det_q = Detector(cfg, params=qparams, specs=specs, device=device, **nms)
    out_q = eval_batched(det_q, "int8 (w8a8)", "int8 PTQ")
    print(f"int8 mAP delta {out_q['map'] - out['map']:+.4f}", flush=True)

    # QAT: fine-tune the SAME trained weights against the int8 lattice
    # (ops/qat.py), export on the tracked scales, re-evaluate — the PTQ
    # accuracy price should come back
    ft_steps = max(200, steps // 5)
    tx_ft = T.make_optimizer(T.darknet_lr_schedule(1e-4, burn_in=20),
                             weight_decay=5e-4)
    state_q = T.create_train_state(
        cfg, tx_ft, seed=7 + seed, input_size=SIZE, specs=specs,
        device=device, params=_numpy(state.params),
        batch_stats=_numpy(state.batch_stats), qat=True)
    del state
    step_q = T.make_train_step(cfg, tx_ft, input_size=SIZE, specs=specs,
                               compute_dtype=dtype, bn_stats=bn_stats)
    t0 = time.time()
    for i in range(ft_steps):
        imgs, tr = pool[i % len(pool)]
        state_q, mq = step_q(state_q, imgs, tr)
    print(f"QAT fine-tune: {ft_steps} steps in {time.time()-t0:.0f}s "
          f"(cost {float(mq['cost']):.2f}, "
          f"{batch*ft_steps/(time.time()-t0):.0f} img/s)", flush=True)
    qat_params = QA.export_int8(specs, state_q.params, state_q.batch_stats,
                                state_q.qat_scales, bn_eps=cfg.bn_eps)
    det_qat = Detector(cfg, params=qat_params, specs=specs, device=device,
                       **nms)
    out_qat = eval_batched(det_qat, "int8 (QAT fine-tune)", "int8 QAT")
    print(f"QAT int8 mAP delta vs float {out_qat['map'] - out['map']:+.4f}"
          f", vs PTQ {out_qat['map'] - out_q['map']:+.4f}", flush=True)
    return results


if __name__ == "__main__":
    argv = [a for a in sys.argv[1:]]
    dev = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        dev = argv[i + 1]
        del argv[i:i + 2]
    res = main(int(argv[0]) if argv else 1200,
               model=argv[1] if len(argv) > 1 else "yolov3-tiny",
               hard="hard" in argv[2:],
               bn_stats="onepass" if "onepass" in argv[2:] else "twopass",
               seed=next((int(a[5:]) for a in argv[2:]
                          if a.startswith("seed=")), 0),
               device=dev)
    import json
    print(json.dumps({"demo": res}))
