"""Grid and anchor decode for v1, v2 and v3 heads in PyTorch: the plain
decode path.

Counterpart of yolo_tensorflow_tpu/models/heads.py, with the same math and
layouts: v2/v3 head outputs are NHWC (B, G, G, A*(5+C)) with anchor-major
(x, y, w, h, obj, classes) blocks, the v1 head is the connected layer's flat
(B, S*S*(C + 5*boxes)); boxes come out in normalized image coordinates,
(B, N, 4) center-x, center-y, w, h. Everything is computed in float32
whatever the head's dtype.
"""

from __future__ import annotations

import torch

from yolo_tensorflow_tpu_torch.config import ModelConfig


def decode_v1(pred_flat, cfg: ModelConfig):
    """pred_flat: (B, S*S*(C + boxes + 4*boxes)) from the connected head ->
    (boxes_xywh (B, N, 4), conf (B, N), class values (B, N, C)), N =
    S*S*boxes.

    Layout: the class values first (S*S*C), then the confidences
    (S*S*boxes), then the boxes (S*S*boxes*4) as (x, y, sqrt-w, sqrt-h); x
    and y are offsets within the cell, w and h square roots of the
    normalized size. The outputs are raw: nothing is squashed."""
    S, Bx, C = cfg.grid, cfg.boxes_per_cell, cfg.num_classes
    pred = pred_flat.to(torch.float32)
    batch = pred.shape[0]
    i1 = S * S * C
    i2 = i1 + S * S * Bx
    class_probs = pred[:, :i1].reshape(batch, S, S, 1, C)
    confs = pred[:, i1:i2].reshape(batch, S * S * Bx)
    boxes = pred[:, i2:].reshape(batch, S, S, Bx, 4)
    cells = torch.arange(S, device=pred.device, dtype=torch.float32)
    x = (boxes[..., 0] + cells.view(1, 1, S, 1)) / S      # column offset
    y = (boxes[..., 1] + cells.view(1, S, 1, 1)) / S      # row offset
    w = torch.square(boxes[..., 2])
    h = torch.square(boxes[..., 3])
    boxes_xywh = torch.stack([x, y, w, h], dim=-1).reshape(batch, S * S * Bx,
                                                           4)
    class_probs = class_probs.expand(batch, S, S, Bx, C).reshape(
        batch, S * S * Bx, C)
    return boxes_xywh, confs, class_probs


def _rows(feat, num_anchors: int, num_classes: int):
    """(B, G, G, A*(5+C)) -> f32 (B, G*G, A, 5+C)."""
    B, Gh, Gw, _ = feat.shape
    if Gh != Gw:
        raise ValueError(f"square grids only, got {Gh}x{Gw}")
    return feat.to(torch.float32).reshape(B, Gh * Gw, num_anchors,
                                          5 + num_classes)


def _boxes_xywh(det, G: int, anchors_px, input_size: int):
    """Box slice of the decode (det (B, G*G, A, 5+C) f32): centers =
    (cell + sigmoid) / G, sizes = exp * anchor_in_grid_units / G."""
    stride = input_size // G
    cells = torch.arange(G * G, device=det.device)
    col = (cells % G).to(torch.float32).reshape(1, G * G, 1)
    row = (cells // G).to(torch.float32).reshape(1, G * G, 1)
    anchors = torch.tensor([[w / stride, h / stride] for w, h in anchors_px],
                           dtype=torch.float32, device=det.device)
    xy = torch.sigmoid(det[..., 0:2])
    wh = torch.exp(det[..., 2:4])
    bx = (col + xy[..., 0]) / G
    by = (row + xy[..., 1]) / G
    bw = anchors[:, 0] * wh[..., 0] / G
    bh = anchors[:, 1] * wh[..., 1] / G
    B, n = det.shape[0], det.shape[1] * det.shape[2]
    return torch.stack([bx, by, bw, bh], dim=-1).reshape(B, n, 4)


def decode_v3_scale(feat, anchors_px, input_size: int, num_classes: int):
    """One FPN scale -> (boxes_xywh (B, N, 4), conf (B, N), class_probs
    (B, N, C)), sigmoid classes."""
    d = _rows(feat, len(anchors_px), num_classes)
    B, n = d.shape[0], d.shape[1] * d.shape[2]
    return (_boxes_xywh(d, feat.shape[1], anchors_px, input_size),
            torch.sigmoid(d[..., 4]).reshape(B, n),
            torch.sigmoid(d[..., 5:]).reshape(B, n, num_classes))


def decode_scale_scored(feat, anchors_px, input_size: int, num_classes: int,
                        *, class_softmax: bool = False):
    """One scale, scored without the (N, C) class tensor -> (boxes_xywh
    (B, N, 4), scores (B, N), labels (B, N) int32).

    Exact, not approximate: for sigmoid classes max_c s(l_c) == s(max_c
    l_c) and the argmax is the same, since s is monotone; for softmax
    classes the best probability is 1 / sum_c exp(l_c - max_c l_c).
    Ties in the argmax go to the lowest class index."""
    d = _rows(feat, len(anchors_px), num_classes)
    B, n = d.shape[0], d.shape[1] * d.shape[2]
    logits = d[..., 5:]
    m = logits.amax(dim=-1)
    labels = logits.argmax(dim=-1).to(torch.int32)
    if class_softmax:
        best = 1.0 / torch.exp(logits - m[..., None]).sum(dim=-1)
    else:
        best = torch.sigmoid(m)
    scores = torch.sigmoid(d[..., 4]) * best
    return (_boxes_xywh(d, feat.shape[1], anchors_px, input_size),
            scores.reshape(B, n), labels.reshape(B, n))


def head_scales(detections, cfg: ModelConfig):
    """[(feat, anchors_px, class_softmax)] per head scale, in spec order.
    v2 anchors are in grid units; they go to pixels here so both heads share
    the per-scale interface (which divides by the stride again), as the TPU
    package's fused decode does."""
    if cfg.head == 3:
        return [(feat, [cfg.anchors[i] for i in det.anchor_mask], False)
                for feat, det in detections]
    if cfg.head == 2:
        (feat, _), = detections
        stride = cfg.input_size // feat.shape[1]
        return [(feat, [(w * stride, h * stride) for w, h in cfg.anchors],
                 cfg.class_softmax)]
    raise NotImplementedError("the per-scale decode covers v2/v3 heads; the "
                              "v1 head goes through decode_scored")


def decode_scored(detections, cfg: ModelConfig):
    """All scales of a head, concatenated in spec order (v3: 13² then 26²
    then 52²) -> (boxes_xywh, scores, labels int32). The v1 head's class
    values are raw, so max and argmax apply to them directly."""
    if cfg.head == 1:
        (feat, _), = detections
        boxes, conf, raw = decode_v1(feat, cfg)
        return (boxes, conf * raw.amax(dim=-1),
                raw.argmax(dim=-1).to(torch.int32))
    parts = [decode_scale_scored(f, a, cfg.input_size, cfg.num_classes,
                                 class_softmax=sm)
             for f, a, sm in head_scales(detections, cfg)]
    return tuple(torch.cat([p[k] for p in parts], dim=1) for k in range(3))


def xywh_to_xyxy(boxes_xywh):
    xy, wh = boxes_xywh[..., :2], boxes_xywh[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)
