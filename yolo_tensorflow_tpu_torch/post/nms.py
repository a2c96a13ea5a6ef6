"""Fixed-shape batched NMS: top-K candidates, then greedy NMS on the device.

Counterpart of yolo_tensorflow_tpu/post/nms.py, which was XLA (top-k plus a
``lax.while_loop``), not a Pallas kernel. For the whole batch at once:
  1. exact top-K candidates of each image's scores (scores at or below the
     confidence threshold are sunk to -1), tied scores in index order as
     ``lax.top_k`` gives them: a stable ``torch.sort`` and gathers,
  2. exact greedy NMS of the K ranked candidates and the first
     ``max_detections`` kept ones, with a valid mask and count in place of
     dynamic shapes: ``ops.kernels.nms.greedy_select``, the CUDA kernel on a
     CUDA input (one launch, no host sync), the plain batched fixpoint on a
     CPU one.
``batched_nms_scored_plain`` runs step 2 as the plain version on any device
(the card's tests compare the kernel with it). ``batched_nms`` (and its
``batched_nms_plain`` twin) scores a materialized decode first: label =
argmax of the class probabilities, score = conf * their max in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from yolo_tensorflow_tpu_torch.ops.kernels import nms as K


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, D, 4) xmin, ymin, xmax, ymax (normalized)
    scores: torch.Tensor   # (B, D)
    classes: torch.Tensor  # (B, D) int32
    valid: torch.Tensor    # (B, D) bool
    num: torch.Tensor      # (B,) int32 valid count


def pack_detections(d: Detections):
    """Detections -> ONE (B, 7*D+1) float32 tensor, so the host reads them
    back in one transfer (class ids, flags and counts are exact in f32)."""
    B, M, _ = d.boxes.shape
    return torch.cat([
        d.boxes.reshape(B, 4 * M), d.scores,
        d.classes.to(torch.float32), d.valid.to(torch.float32),
        d.num[:, None].to(torch.float32)], dim=1)


def unpack_detections(arr) -> Detections:
    """Inverse of pack_detections on a host array -> numpy Detections."""
    arr = np.asarray(arr)
    M = (arr.shape[1] - 1) // 7
    return Detections(
        boxes=arr[:, :4 * M].reshape(-1, M, 4),
        scores=arr[:, 4 * M:5 * M],
        classes=arr[:, 5 * M:6 * M].astype(np.int32),
        valid=arr[:, 6 * M:7 * M] > 0.5,
        num=arr[:, 7 * M].astype(np.int32))


def fetch_detections(dets: Detections) -> Detections:
    """Device Detections -> numpy Detections in one device-to-host copy."""
    return unpack_detections(pack_detections(dets).cpu().numpy())


def select_candidates(boxes_xyxy, scores, labels, *,
                      conf_threshold: float, num_candidates: int):
    """(B, N, 4), (B, N), (B, N) -> the top K = min(num_candidates, N)
    candidates of each image in descending order of their masked scores:
    boxes (B, K, 4), scores (B, K), labels (B, K). Equal scores keep their
    index order, as the TPU package's ``lax.top_k`` does (``torch.topk``
    promises no order among them, and bf16 scores tie often)."""
    k = min(num_candidates, scores.shape[1])
    masked = torch.where(scores > conf_threshold, scores,
                         torch.full_like(scores, -1.0))
    top_scores, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = boxes_xyxy.gather(1, idx[:, :, None].expand(-1, -1, 4))
    return top_boxes, top_scores, labels.gather(1, idx)


def _nms(select, boxes_xyxy, scores, labels, *, conf_threshold,
         iou_threshold, max_detections, num_candidates, class_aware):
    candidates = select_candidates(boxes_xyxy, scores, labels,
                                   conf_threshold=conf_threshold,
                                   num_candidates=num_candidates)
    return Detections(*select(*candidates, conf_threshold=conf_threshold,
                              iou_threshold=iou_threshold,
                              max_detections=max_detections,
                              class_aware=class_aware))


def batched_nms_scored(boxes_xyxy, scores, labels, *, conf_threshold=0.5,
                       iou_threshold=0.5, max_detections=20,
                       num_candidates=256, class_aware=False) -> Detections:
    """NMS on already-scored boxes (B, N, 4), (B, N), (B, N) int32: top-k,
    then the greedy NMS kernel (or its plain version on the CPU)."""
    return _nms(K.greedy_select, boxes_xyxy, scores, labels,
                conf_threshold=conf_threshold, iou_threshold=iou_threshold,
                max_detections=max_detections,
                num_candidates=num_candidates, class_aware=class_aware)


def batched_nms_scored_plain(boxes_xyxy, scores, labels, *,
                             conf_threshold=0.5, iou_threshold=0.5,
                             max_detections=20, num_candidates=256,
                             class_aware=False) -> Detections:
    """``batched_nms_scored`` with the plain greedy step on any device."""
    return _nms(K.greedy_select_plain, boxes_xyxy, scores, labels,
                conf_threshold=conf_threshold, iou_threshold=iou_threshold,
                max_detections=max_detections,
                num_candidates=num_candidates, class_aware=class_aware)


def score_classes(conf, class_probs):
    """The TPU package's factored scoring: label = argmax (first index on
    ties), score = conf * max class probability, in float32. Exact: conf >=
    0 and rounding is monotone, so max(conf * p) == conf * max(p)."""
    labels = class_probs.argmax(dim=-1).to(torch.int32)
    scores = (conf * class_probs.amax(dim=-1)).to(torch.float32)
    return scores, labels


def batched_nms(boxes_xyxy, conf, class_probs, *, conf_threshold=0.5,
                iou_threshold=0.5, max_detections=20, num_candidates=256,
                class_aware=False) -> Detections:
    """Score (B, N) conf and (B, N, C) class probabilities, then
    ``batched_nms_scored``: top-k and the greedy NMS kernel (its plain
    version on the CPU)."""
    scores, labels = score_classes(conf, class_probs)
    return batched_nms_scored(boxes_xyxy, scores, labels,
                              conf_threshold=conf_threshold,
                              iou_threshold=iou_threshold,
                              max_detections=max_detections,
                              num_candidates=num_candidates,
                              class_aware=class_aware)


def batched_nms_plain(boxes_xyxy, conf, class_probs, *, conf_threshold=0.5,
                      iou_threshold=0.5, max_detections=20,
                      num_candidates=256, class_aware=False) -> Detections:
    """``batched_nms`` with the plain greedy step on any device."""
    scores, labels = score_classes(conf, class_probs)
    return batched_nms_scored_plain(boxes_xyxy, scores, labels,
                                    conf_threshold=conf_threshold,
                                    iou_threshold=iou_threshold,
                                    max_detections=max_detections,
                                    num_candidates=num_candidates,
                                    class_aware=class_aware)
