"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference.

``frame_gap``: the worst of the checked frames' gaps. A frame's gap is the
larger of two parts.

* The served detections' worst gap. For each, the reference's anchor that
  matches the served box best (largest IoU) is the one it came from; its
  gap is the largest of 1 - that IoU, how far the served score lies from
  the reference's score for the served class at that anchor, and how far
  the reference's best class score there lies above the served class's.
  A detection right to rounding reads near 0 however NMS ordered it; an
  answer altered where it is produced reads near 1.
* The reference's detections missed. One that no served detection covers
  (IoU at least ``COVER_IOU``, any class, as NMS suppresses across
  classes) reads (its score - the served floor) / (its score - the
  confidence threshold), the served floor being the lowest served score
  where the port filled every slot and the threshold where it did not. A
  detection that fell out only at the edge of the list reads near 0, a
  frame whose answer is missing reads 1.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.detect import iou

COVER_IOU = 0.45


def frame_parts(served, candidates, kept, cfg) -> dict:
    """The parts of one frame's gap. ``served``: numpy (boxes (D, 4),
    scores (D,), classes (D,), valid (D,)) as the port returned them;
    ``candidates``: the reference's (boxes (N, 4), objectness (N,), class
    probabilities (N, C)) in the same frame; ``kept``: the reference's NMS
    (boxes, scores, labels). Returns {"det": the served detections' worst
    gap, "iou", "score", "cls": the worst of each of its three terms,
    "miss": the worst missed reference detection, "n": detections
    served}."""
    boxes, obj, probs = candidates
    dev = boxes.device
    s_boxes, s_scores, s_classes, s_valid = (np.asarray(v) for v in served)
    s_valid = s_valid.astype(bool)
    n = int(s_valid.sum())
    sb = torch.as_tensor(s_boxes[s_valid], dtype=torch.float32, device=dev)
    ss = torch.as_tensor(s_scores[s_valid], dtype=torch.float32, device=dev)
    sc = torch.as_tensor(s_classes[s_valid], dtype=torch.long, device=dev)
    out = {"det": 0.0, "iou": 0.0, "score": 0.0, "cls": 0.0, "miss": 0.0,
           "n": n}
    if n:
        best, a = iou(sb, boxes).max(dim=1)
        rs = obj[a, None] * probs[a]                     # (n, C)
        known = (sc >= 0) & (sc < rs.shape[1])
        own = rs.gather(1, sc.clamp(0, rs.shape[1] - 1)[:, None])[:, 0]
        own = torch.where(known, own, torch.full_like(own, -1.0))
        terms = torch.stack([1.0 - best, (ss - own).abs(),
                             rs.max(dim=1).values - own]).clamp(max=1.0)
        worst = terms.max(dim=1).values
        out["det"] = float(worst.max())
        out["iou"], out["score"], out["cls"] = worst.tolist()
    k_boxes, k_scores, _ = kept
    if len(k_scores):
        thr = cfg["conf_threshold"]
        floor = float(ss.min()) if n == cfg["max_detections"] else thr
        if n:
            covered = iou(k_boxes, sb).max(dim=1).values >= COVER_IOU
        else:
            covered = torch.zeros_like(k_scores, dtype=torch.bool)
        rel = ((k_scores - floor).clamp(min=0)
               / (k_scores - thr).clamp(min=1e-12)).clamp(max=1.0)
        out["miss"] = float(torch.where(covered, torch.zeros_like(rel),
                                        rel).max())
    return out


def frame_gap(parts) -> float:
    """One frame's gap from its ``frame_parts``."""
    return max(parts["det"], parts["miss"])

