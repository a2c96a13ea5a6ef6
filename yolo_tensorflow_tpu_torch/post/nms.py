"""Fixed-shape batched NMS in plain PyTorch.

Counterpart of yolo_tensorflow_tpu/post/nms.py, which was XLA (top-k plus a
``lax.while_loop``), not a Pallas kernel. Per image:
  1. exact top-K candidates of the scores (scores at or below the
     confidence threshold are sunk to -1),
  2. exact greedy NMS as a monotone fixpoint over the K x K IoU matrix: box
     j is suppressed iff some higher-ranked kept box overlaps it; iterating
     from keep = active converges to the sequential greedy result,
  3. top ``max_detections`` of the kept scores, with a valid mask and count
     in place of dynamic shapes.
PyTorch has no loop that stays on the device, so the fixpoint's convergence
test is a host sync per iteration, and the batch is a Python loop. A device
NMS kernel is ROADMAP Queue 2 item 2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


def iou_matrix(boxes):
    """Pairwise IoU for (K, 4) xyxy boxes -> (K, K)."""
    x0, y0, x1, y1 = boxes.unbind(dim=1)
    area = (x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0)
    ix0 = torch.maximum(x0[:, None], x0[None, :])
    iy0 = torch.maximum(y0[:, None], y0[None, :])
    ix1 = torch.minimum(x1[:, None], x1[None, :])
    iy1 = torch.minimum(y1[:, None], y1[None, :])
    inter = (ix1 - ix0).clamp(min=0) * (iy1 - iy0).clamp(min=0)
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp(min=1e-9)


def _greedy_keep(iou, active, iou_threshold):
    """Exact greedy NMS for candidates sorted by descending score:
    keep[j] = active[j] and no i < j with keep[i] and iou[i, j] > thr.
    Fixpoint iteration from keep = active (suppressed suppressors release
    their victims each round); one host sync per round."""
    k = iou.shape[0]
    higher = torch.ones((k, k), dtype=torch.bool,
                        device=iou.device).triu(diagonal=1)  # i < j
    overlap = (iou > iou_threshold) & higher
    keep = active
    while True:
        suppressed = (overlap & keep[:, None]).any(dim=0)
        new_keep = active & ~suppressed
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def _nms_single(boxes, scores, labels, *, conf_threshold, iou_threshold,
                max_detections, num_candidates, class_aware):
    """boxes (N, 4) xyxy, scores (N,), labels (N,) int32 -> fixed-size
    (boxes, scores, labels, valid, num) for one image."""
    n = scores.shape[0]
    k = min(num_candidates, n)
    masked = torch.where(scores > conf_threshold, scores,
                         torch.full_like(scores, -1.0))
    top_scores, idx = torch.topk(masked, k)
    top_boxes = boxes[idx]
    top_labels = labels[idx]
    active = top_scores > conf_threshold

    iou = iou_matrix(top_boxes)
    if class_aware:
        iou = torch.where(top_labels[:, None] == top_labels[None, :], iou,
                          torch.zeros_like(iou))
    keep = _greedy_keep(iou, active, iou_threshold)

    final = torch.where(keep, top_scores, torch.full_like(top_scores, -1.0))
    if max_detections > k:
        # fewer candidates than output slots: pad the candidate set
        pad = max_detections - k
        final = torch.cat([final, final.new_full((pad,), -1.0)])
        top_boxes = torch.cat([top_boxes, top_boxes.new_zeros((pad, 4))])
        top_labels = torch.cat([top_labels, top_labels.new_zeros((pad,))])
    out_scores, sel = torch.topk(final, max_detections)
    valid = out_scores > conf_threshold
    out_boxes = torch.where(valid[:, None], top_boxes[sel],
                            torch.zeros_like(top_boxes[sel]))
    out_labels = torch.where(valid, top_labels[sel],
                             torch.zeros_like(top_labels[sel]))
    out_scores = torch.where(valid, out_scores, torch.zeros_like(out_scores))
    return (out_boxes, out_scores, out_labels, valid,
            valid.sum(dtype=torch.int32))


def batched_nms_scored(boxes_xyxy, scores, labels, *, conf_threshold=0.5,
                       iou_threshold=0.5, max_detections=20,
                       num_candidates=256, class_aware=False) -> Detections:
    """NMS on already-scored boxes (B, N, 4), (B, N), (B, N) int32, one
    image at a time."""
    per_image = [_nms_single(b, s, c, conf_threshold=conf_threshold,
                             iou_threshold=iou_threshold,
                             max_detections=max_detections,
                             num_candidates=num_candidates,
                             class_aware=class_aware)
                 for b, s, c in zip(boxes_xyxy, scores, labels)]
    return Detections(*(torch.stack(f) for f in zip(*per_image)))
