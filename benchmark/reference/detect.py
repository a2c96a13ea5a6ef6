"""The plain reference of detection around the network: the input's
normalization, the v3 (yolo layer) and v2 (region layer) decode and greedy
NMS. On any device; it imports nothing of the program under test."""

from __future__ import annotations

import torch


def normalize(frames_u8, divisor: float):
    """uint8 (B, H, W, 3) -> bfloat16 (B, 3, H, W) = pixels / divisor."""
    return frames_u8.permute(0, 3, 1, 2).to(torch.bfloat16) / divisor


def decode(heads, cfg):
    """[(raw map (B, A*(5+C), G, G), anchor mask)] -> every anchor's
    (boxes xyxy normalized (B, N, 4), objectness (B, N), class
    probabilities (B, N, C)), the scales in layer order, each scale's rows
    cell-major then anchor."""
    C = cfg["num_classes"]
    S = cfg["input_size"]
    boxes, objs, probs = [], [], []
    for raw, mask in heads:
        B, _, G, _ = raw.shape
        A = len(mask)
        d = raw.to(torch.float32).permute(0, 2, 3, 1).reshape(
            B, G * G, A, 5 + C)
        if cfg["anchor_units"] == "pixel":
            anchors = torch.tensor([cfg["anchors"][m] for m in mask],
                                   dtype=torch.float32, device=raw.device) / S
        else:
            anchors = torch.tensor([cfg["anchors"][m] for m in mask],
                                   dtype=torch.float32,
                                   device=raw.device) / G
        cell = torch.arange(G * G, device=raw.device)
        col = (cell % G).to(torch.float32)[None, :, None]
        row = (cell // G).to(torch.float32)[None, :, None]
        cx = (col + torch.sigmoid(d[..., 0])) / G
        cy = (row + torch.sigmoid(d[..., 1])) / G
        bw = torch.exp(d[..., 2]) * anchors[:, 0]
        bh = torch.exp(d[..., 3]) * anchors[:, 1]
        xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                            cy + bh / 2], dim=-1)
        boxes.append(xyxy.reshape(B, G * G * A, 4))
        objs.append(torch.sigmoid(d[..., 4]).reshape(B, G * G * A))
        cls = d[..., 5:]
        p = (torch.softmax(cls, dim=-1) if cfg["class_softmax"]
             else torch.sigmoid(cls))
        probs.append(p.reshape(B, G * G * A, C))
    return (torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(probs, 1))


def iou(a, b):
    """IoU of xyxy boxes a (..., M, 4) against b (..., N, 4) -> (..., M,
    N)."""
    ax0, ay0, ax1, ay1 = (a[..., i, None] for i in range(4))
    bx0, by0, bx1, by1 = (b[..., None, :, i] for i in range(4))
    area_a = (ax1 - ax0).clamp(min=0) * (ay1 - ay0).clamp(min=0)
    area_b = (bx1 - bx0).clamp(min=0) * (by1 - by0).clamp(min=0)
    iw = (torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0)).clamp(min=0)
    ih = (torch.minimum(ay1, by1) - torch.maximum(ay0, by0)).clamp(min=0)
    inter = iw * ih
    return inter / (area_a + area_b - inter).clamp(min=1e-9)


def nms(boxes, scores, labels, cfg):
    """Greedy NMS of one image's scored candidates (N, 4), (N,), (N,):
    the top ``num_candidates`` above the threshold in descending score
    (ties in index order), each kept unless a kept one before it overlaps
    it by more than the IoU threshold (any class, or its own with
    class-aware NMS), the first ``max_detections`` kept. Returns (boxes
    (D, 4), scores (D,), labels (D,)), D <= max_detections."""
    active = scores > cfg["conf_threshold"]
    masked = torch.where(active, scores, torch.full_like(scores, -1.0))
    order = torch.sort(masked, descending=True, stable=True).indices
    order = order[:cfg["num_candidates"]]
    order = order[active[order]]
    b, s, lab = boxes[order], scores[order], labels[order]
    ious = iou(b, b).cpu()
    same = (lab[:, None] == lab[None, :]).cpu()
    kept = []
    for j in range(len(order)):
        if all(not (ious[i, j] > cfg["iou_threshold"]
                    and (same[i, j] or not cfg["class_aware_nms"]))
               for i in kept):
            kept.append(j)
            if len(kept) == cfg["max_detections"]:
                break
    idx = torch.tensor(kept, dtype=torch.long, device=boxes.device)
    return b[idx], s[idx], lab[idx]

