"""Fixed-shape batched NMS: top-K candidates, then greedy NMS on the device.

Counterpart of yolo_tensorflow_tpu/post/nms.py, which was XLA (top-k plus a
``lax.while_loop``), not a Pallas kernel. For the whole batch at once, with
a valid mask and count in place of dynamic shapes:
  1. the exact top-K candidates of each image's scores (scores at or below
     the confidence threshold are inactive), tied scores in index order as
     ``lax.top_k`` gives them,
  2. exact greedy NMS of the K ranked candidates and the first
     ``max_detections`` kept ones.
``batched_nms_scored`` does both in one call of ``ops.kernels.nms.
greedy_nms``: on a CUDA input one launch of the NMS kernel (no sort, no
gather, no host sync), on a CPU one the plain version. The plain version
(``batched_nms_scored_plain``, on any device; the card's tests compare the
kernel with it) is ``ops.kernels.nms.select_candidates``, a stable
``torch.sort`` of the masked scores and gathers, then
``greedy_select_plain``, the batched fixpoint. ``batched_nms`` (and its
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


def batched_nms_scored(boxes_xyxy, scores, labels, *, conf_threshold=0.5,
                       iou_threshold=0.5, max_detections=20,
                       num_candidates=256, class_aware=False) -> Detections:
    """NMS on already-scored boxes (B, N, 4), (B, N), (B, N) int32: one
    call of the NMS operator (the kernel on a CUDA input, its plain version
    on a CPU one)."""
    return Detections(*K.greedy_nms(
        boxes_xyxy, scores, labels, conf_threshold=conf_threshold,
        iou_threshold=iou_threshold, max_detections=max_detections,
        num_candidates=num_candidates, class_aware=class_aware))


def batched_nms_scored_plain(boxes_xyxy, scores, labels, *,
                             conf_threshold=0.5, iou_threshold=0.5,
                             max_detections=20, num_candidates=256,
                             class_aware=False) -> Detections:
    """``batched_nms_scored``'s plain version on any device:
    ``select_candidates``, then ``greedy_select_plain``."""
    return Detections(*K.nms_plain(
        boxes_xyxy, scores, labels, conf_threshold=conf_threshold,
        iou_threshold=iou_threshold, max_detections=max_detections,
        num_candidates=num_candidates, class_aware=class_aware))


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
    ``batched_nms_scored``: the NMS kernel (its plain version on the
    CPU)."""
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
    """``batched_nms``'s plain version on any device."""
    scores, labels = score_classes(conf, class_probs)
    return batched_nms_scored_plain(boxes_xyxy, scores, labels,
                                    conf_threshold=conf_threshold,
                                    iou_threshold=iou_threshold,
                                    max_detections=max_detections,
                                    num_candidates=num_candidates,
                                    class_aware=class_aware)
