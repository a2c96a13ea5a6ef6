"""Grid and anchor decode for v1, v2 and v3 heads in PyTorch: the plain
decode path.

Counterpart of yolo_tensorflow_tpu/models/heads.py, with the same math and
layouts: v2/v3 head outputs are NHWC (B, G, G, A*(5+C)) with anchor-major
(x, y, w, h, obj, classes) blocks, the v1 head is the connected layer's flat
(B, S*S*(C + 5*boxes)); boxes come out in normalized image coordinates,
(B, N, 4) center-x, center-y, w, h. Everything is computed in float32
whatever the head's dtype, except the scores of ``score_dtype=bfloat16``.

Flip-TTA and the rolling average work on ACTIVATED head outputs (the
``l.output`` buffers darknet averages): ``activate_v2`` / ``activate_v3``,
``region_flip_tta`` / ``yolo_flip_tta`` (both ``tta_mode``s), and the
decodes that do not activate again, ``decode_v2_activated`` and
``decode_v3_scale_activated``. ``decode`` is the materializing decode
(boxes, conf, class probabilities (B, N, C)) that ``post.nms.batched_nms``
scores.
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


def _boxes(xy, wh, G: int, anchors_grid):
    """Boxes (B, G*G*A, 4) of cell offsets xy and size factors wh, each
    (B, G*G, A, 2) f32: centers = (cell + xy) / G, sizes = wh * anchor in
    grid cells / G."""
    cells = torch.arange(G * G, device=xy.device)
    col = (cells % G).to(torch.float32).reshape(1, G * G, 1)
    row = (cells // G).to(torch.float32).reshape(1, G * G, 1)
    # non_blocking: a serving forward on the card must not sync the host
    anchors = torch.tensor(anchors_grid, dtype=torch.float32).to(
        xy.device, non_blocking=True)
    bx = (col + xy[..., 0]) / G
    by = (row + xy[..., 1]) / G
    bw = anchors[:, 0] * wh[..., 0] / G
    bh = anchors[:, 1] * wh[..., 1] / G
    B, n = xy.shape[0], xy.shape[1] * xy.shape[2]
    return torch.stack([bx, by, bw, bh], dim=-1).reshape(B, n, 4)


def _grid_anchors(anchors_px, G: int, input_size: int):
    stride = input_size // G
    return [[w / stride, h / stride] for w, h in anchors_px]


def _boxes_xywh(det, G: int, anchors_px, input_size: int):
    """Box slice of the decode (det (B, G*G, A, 5+C) f32): centers =
    (cell + sigmoid) / G, sizes = exp * anchor_in_grid_units / G."""
    return _boxes(torch.sigmoid(det[..., 0:2]), torch.exp(det[..., 2:4]), G,
                  _grid_anchors(anchors_px, G, input_size))


def softmax(x, dim: int = -1):
    """exp(x - max) / sum, as jax.nn.softmax writes it (torch.softmax
    multiplies by the sum's reciprocal instead)."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def sigmoid_bf16(x):
    """The logistic function of a bfloat16 tensor as the TPU package's bf16
    scoring computes it: 1 / (1 + exp(-x)) with every step rounded to
    bfloat16 (XLA's expansion of the bf16 logistic)."""
    x = x.to(torch.bfloat16)
    return 1.0 / (1.0 + torch.exp(-x))


def check_score_dtype(score_dtype):
    if score_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"score_dtype is float32 or bfloat16, not "
                        f"{score_dtype}")
    return score_dtype == torch.bfloat16


def decode_v3_scale(feat, anchors_px, input_size: int, num_classes: int,
                    score_dtype=None):
    """One FPN scale -> (boxes_xywh (B, N, 4), conf (B, N), class_probs
    (B, N, C)), sigmoid classes. ``score_dtype=torch.bfloat16`` computes
    conf and the class sigmoids in bf16 (``sigmoid_bf16``); boxes stay
    float32."""
    bf16 = check_score_dtype(score_dtype)
    d = _rows(feat, len(anchors_px), num_classes)
    B, n = d.shape[0], d.shape[1] * d.shape[2]
    act = sigmoid_bf16 if bf16 else torch.sigmoid
    return (_boxes_xywh(d, feat.shape[1], anchors_px, input_size),
            act(d[..., 4]).reshape(B, n),
            act(d[..., 5:]).reshape(B, n, num_classes))


def decode_v2(feat, cfg: ModelConfig):
    """Region head (B, G, G, A*(5+C)) -> (boxes_xywh (B, N, 4), conf (B, N),
    class_probs (B, N, C)): sigmoid xy and conf, exp wh times the anchors
    (grid units), softmax classes."""
    A, C = cfg.num_anchors, cfg.num_classes
    d = _rows(feat, A, C)
    G = feat.shape[1]
    B, n = d.shape[0], d.shape[1] * A
    return (_boxes(torch.sigmoid(d[..., 0:2]), torch.exp(d[..., 2:4]), G,
                   cfg.anchors),
            torch.sigmoid(d[..., 4]).reshape(B, n),
            softmax(d[..., 5:]).reshape(B, n, C))


def decode(detections, cfg: ModelConfig, score_dtype=None):
    """The engine's [(feat, Detect)] -> (boxes_xywh, conf, class_probs
    (B, N, C)), the scales concatenated in spec order: the materializing
    decode that ``post.nms.batched_nms`` scores. ``score_dtype`` applies to
    the v3 head only, as in the TPU package."""
    if cfg.head == 1:
        (feat, _), = detections
        return decode_v1(feat, cfg)
    if cfg.head == 2:
        (feat, _), = detections
        return decode_v2(feat, cfg)
    parts = [decode_v3_scale(feat, [cfg.anchors[i] for i in det.anchor_mask],
                             cfg.input_size, cfg.num_classes,
                             score_dtype=score_dtype)
             for feat, det in detections]
    return tuple(torch.cat([p[k] for p in parts], dim=1) for k in range(3))


def decode_scale_scored(feat, anchors_px, input_size: int, num_classes: int,
                        *, class_softmax: bool = False, score_dtype=None):
    """One scale, scored without the (N, C) class tensor -> (boxes_xywh
    (B, N, 4), scores (B, N), labels (B, N) int32).

    Exact, not approximate: for sigmoid classes max_c s(l_c) == s(max_c
    l_c) and the argmax is the same, since s is monotone; for softmax
    classes the best probability is 1 / sum_c exp(l_c - max_c l_c).
    Ties in the argmax go to the lowest class index.

    ``score_dtype=torch.bfloat16`` (sigmoid classes only; the softmax branch
    ignores it, as the TPU package does): the conf and class logits are
    rounded to bf16, the label is the argmax of the rounded logits, and the
    score is bf16(sigmoid_bf16(conf) * sigmoid_bf16(max)), returned as
    float32."""
    bf16 = check_score_dtype(score_dtype) and not class_softmax
    d = _rows(feat, len(anchors_px), num_classes)
    B, n = d.shape[0], d.shape[1] * d.shape[2]
    logits = d[..., 5:].to(torch.bfloat16) if bf16 else d[..., 5:]
    m = logits.amax(dim=-1)
    labels = logits.argmax(dim=-1).to(torch.int32)
    if bf16:
        scores = (sigmoid_bf16(d[..., 4]) * sigmoid_bf16(m)).float()
    else:
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


def decode_scored(detections, cfg: ModelConfig, score_dtype=None):
    """All scales of a head, concatenated in spec order (v3: 13² then 26²
    then 52²) -> (boxes_xywh, scores, labels int32). The v1 head's class
    values are raw, so max and argmax apply to them directly.
    ``score_dtype`` applies to the v3 head only, as in the TPU package."""
    if cfg.head == 1:
        (feat, _), = detections
        boxes, conf, raw = decode_v1(feat, cfg)
        return (boxes, conf * raw.amax(dim=-1),
                raw.argmax(dim=-1).to(torch.int32))
    sd = score_dtype if cfg.head == 3 else None
    parts = [decode_scale_scored(f, a, cfg.input_size, cfg.num_classes,
                                 class_softmax=sm, score_dtype=sd)
             for f, a, sm in head_scales(detections, cfg)]
    return tuple(torch.cat([p[k] for p in parts], dim=1) for k in range(3))


def xywh_to_xyxy(boxes_xywh):
    xy, wh = boxes_xywh[..., :2], boxes_xywh[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)


# ------------------------------ activated outputs (TTA, smoothing)

def activate_v2(feat, cfg: ModelConfig):
    """Region-layer activation (darknet's forward_region_layer): sigmoid xy
    and obj, softmax classes per anchor, raw wh. (B, H, W, A*(5+C)) -> the
    same shape, float32."""
    A, C = cfg.num_anchors, cfg.num_classes
    B, H, W, _ = feat.shape
    det = feat.to(torch.float32).reshape(B, H, W, A, 5 + C)
    out = torch.cat([torch.sigmoid(det[..., 0:2]), det[..., 2:4],
                     torch.sigmoid(det[..., 4:5]), softmax(det[..., 5:])],
                    dim=-1)
    return out.reshape(B, H, W, A * (5 + C))


def activate_v3(feat, num_anchors: int, num_classes: int):
    """Yolo-layer activation (darknet's forward_yolo_layer): sigmoid xy, obj
    and classes, raw wh. (B, H, W, A*(5+C)) -> the same shape, float32."""
    A, C = num_anchors, num_classes
    B, H, W, _ = feat.shape
    det = feat.to(torch.float32).reshape(B, H, W, A, 5 + C)
    out = torch.cat([torch.sigmoid(det[..., 0:2]), det[..., 2:4],
                     torch.sigmoid(det[..., 4:])], dim=-1)
    return out.reshape(B, H, W, A * (5 + C))


def _negate_flip_planes(flip, A: int, E: int, W: int):
    """Darknet's flip loops' negation (region_layer.c:379, yolo_layer.c:303)
    on flip (B, H, W, A, E): the planes p = a*E + e with p < A (its 'z == 0'
    under a [entry][anchor] indexing of an [anchor][entry] buffer), except
    the middle column of an odd width, which its ``i < w/2`` loop never
    reaches."""
    plane = torch.arange(A * E, device=flip.device).reshape(A, E)
    neg = (plane < A).reshape(1, 1, 1, A, E)
    if W % 2 == 1:
        col = torch.arange(W, device=flip.device)
        neg = neg & (col != W // 2).reshape(1, 1, W, 1, 1)
    return torch.where(neg, -flip, flip)


def _flip_average(act, act_flipped, A: int, C: int, mode: str):
    B, H, W, _ = act.shape
    E = 5 + C
    flip = torch.flip(act_flipped.reshape(B, H, W, A, E), dims=[2])
    if mode == "darknet":
        flip = _negate_flip_planes(flip, A, E, W)
    elif mode == "corrected":
        flip = torch.cat([1.0 - flip[..., :1], flip[..., 1:]], dim=-1)
    else:
        raise ValueError(f"tta_mode is 'darknet' or 'corrected', not "
                         f"{mode!r}")
    return ((act.reshape(B, H, W, A, E) + flip) / 2.0).reshape(B, H, W,
                                                                A * E)


def region_flip_tta(act, act_flipped, cfg: ModelConfig,
                    mode: str = "darknet"):
    """Average an activated region output with the activated output of the
    horizontally flipped image: get_region_detections' batch == 2 path
    (region_layer.c:368-390). Both (B, H, W, A*(5+C)).

    'darknet' is the C loop with its three quirks: it negates the planes
    p < A of the [anchor][entry] buffer (anchor 0's first A entries, not
    every anchor's x), it negates values that are already activated, and
    for an odd width it skips the middle column (13 at 416). 'corrected'
    mirrors properly: every anchor's x becomes 1 - x, nothing is
    negated."""
    return _flip_average(act, act_flipped, cfg.num_anchors, cfg.num_classes,
                         mode)


def yolo_flip_tta(act, act_flipped, num_anchors: int, num_classes: int,
                  mode: str = "darknet"):
    """avg_flipped_yolo (yolo_layer.c:290-313) on one activated yolo scale:
    the same loop and quirks as ``region_flip_tta``."""
    return _flip_average(act, act_flipped, num_anchors, num_classes, mode)


def decode_v2_activated(act, cfg: ModelConfig):
    """``decode_v2`` of an activated (possibly averaged) region output:
    get_region_box without activating again -> (boxes_xywh, conf,
    class_probs)."""
    A, C = cfg.num_anchors, cfg.num_classes
    d = _rows(act, A, C)
    G = act.shape[1]
    B, n = d.shape[0], d.shape[1] * A
    return (_boxes(d[..., 0:2], torch.exp(d[..., 2:4]), G, cfg.anchors),
            d[..., 4].reshape(B, n), d[..., 5:].reshape(B, n, C))


def decode_v3_scale_activated(act, anchors_px, input_size: int,
                              num_classes: int):
    """``decode_v3_scale`` of an activated (possibly averaged) yolo scale ->
    (boxes_xywh, scores, labels int32), score = conf * best class
    probability (get_yolo_detections' objectness * prob)."""
    A, C = len(anchors_px), num_classes
    d = _rows(act, A, C)
    G = act.shape[1]
    B, n = d.shape[0], d.shape[1] * A
    probs = d[..., 5:]
    return (_boxes(d[..., 0:2], torch.exp(d[..., 2:4]), G,
                   _grid_anchors(anchors_px, G, input_size)),
            (d[..., 4] * probs.amax(dim=-1)).reshape(B, n),
            probs.argmax(dim=-1).to(torch.int32).reshape(B, n))
