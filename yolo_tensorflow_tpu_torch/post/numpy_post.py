"""Host-side numpy postprocess twin.

The reference ships both in-graph and numpy postprocess paths (utils.py:30
``postprocess``: pixel-scale, clip, score, top-400 sort, class-aware greedy
NMS; YOLOV3.py:491 per-class numpy NMS). This is the framework's equivalent
for CPU-only consumers and a readable specification of the NMS semantics
(the on-device post/nms.py is parity-tested against it)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> float:
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
    ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
    ub = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
    return inter / max(ua + ub - inter, 1e-9)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray, *,
               conf_threshold: float = 0.5, iou_threshold: float = 0.5,
               max_detections: int = 20, class_aware: bool = False,
               top_k: int = 400):
    """Sequential greedy NMS (utils.py:146 bboxes_sort top-400 + :176
    bboxes_nms semantics). Returns (boxes, scores, labels) arrays."""
    order = np.argsort(-scores, kind="stable")[:top_k]
    kept = []
    for i in order:
        if scores[i] <= conf_threshold:
            continue
        ok = True
        for j in kept:
            if class_aware and labels[i] != labels[j]:
                continue
            if iou_xyxy(boxes[i], boxes[j]) > iou_threshold:
                ok = False
                break
        if ok:
            kept.append(i)
            if len(kept) >= max_detections:
                break
    kept = np.asarray(kept, np.int64)
    return boxes[kept], scores[kept], labels[kept]


def postprocess(boxes_xywh: np.ndarray, conf: np.ndarray,
                class_probs: np.ndarray, *, image_shape: Tuple[int, int],
                conf_threshold: float = 0.5, iou_threshold: float = 0.5,
                max_detections: int = 20, class_aware: bool = True):
    """Decoded normalized predictions -> pixel-space detections.

    boxes_xywh (N,4) normalized center-format; conf (N,); class_probs (N,C).
    Mirrors utils.py:30: scale to pixels, clip to the image, class-specific
    score = conf * max class prob, threshold, NMS.
    """
    h, w = image_shape
    scores_all = conf[:, None] * class_probs
    labels = np.argmax(scores_all, axis=-1).astype(np.int32)
    scores = scores_all[np.arange(len(labels)), labels]

    half = boxes_xywh[:, 2:4] / 2
    xyxy = np.concatenate([boxes_xywh[:, :2] - half,
                           boxes_xywh[:, :2] + half], axis=1)
    xyxy = xyxy * np.asarray([w, h, w, h], np.float32)
    xyxy[:, 0::2] = np.clip(xyxy[:, 0::2], 0, w)
    xyxy[:, 1::2] = np.clip(xyxy[:, 1::2], 0, h)

    return greedy_nms(xyxy, scores, labels, conf_threshold=conf_threshold,
                      iou_threshold=iou_threshold,
                      max_detections=max_detections, class_aware=class_aware)
