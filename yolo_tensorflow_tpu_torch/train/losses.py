"""Training losses with darknet-exact gradients, in PyTorch.

Counterpart of yolo_tensorflow_tpu/train/losses.py:
- v3 (src/yolo_layer.c:132-240), v2 region (src/region_layer.c:158
  forward_region_layer: rescore, the seen < 12800 bias-match warm-up) and
  v1 detection (src/detection_layer.c:50): darknet builds a ``delta``
  tensor (target - output on the activated outputs, on the raw logits for
  tw/th) and backpropagates it directly, so its gradient with respect to
  the raw head output is exactly -delta. Each loss reproduces that with a
  linear surrogate, -sum(delta * raw) / batch with delta detached, whose
  value is replaced by darknet's printed cost sum(delta^2).
- the v2 ``tf`` variant (the TF reference's Loss.py weighted MSE) and the
  classifier's softmax cross-entropy are ordinary differentiable losses.

Batched over images with an explicit batch dimension (the TPU package vmaps
one image). Truths are (B, T, 5) normalized (cx, cy, w, h, class), padded
with w == 0 rows. Nothing here syncs with the host. Where darknet walks the
truths in order and overwrites a cell (the TPU package's ``fori_loop``),
every truth's row is computed at once: no row depends on an earlier write,
so the loop's result at each (cell, anchor) is the last valid writer's row
(the first one's, for v1's truth grid), which one scatter writes; the
others go to a scratch row past the real ones. The sequential "scan" form
of the v3 assignment and the YOLO9000 softmax tree are not ported
(ROADMAP.md, Queue 1 items 14 and 13).
"""

from __future__ import annotations

import dataclasses

import torch


def _box_iou_xywh(a, b):
    """IoU of boxes in (cx, cy, w, h); broadcasts."""
    ax0, ay0 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax1, ay1 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx0, by0 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx1, by1 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    iw = torch.clamp(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay1, by1) - torch.maximum(ay0, by0),
                     min=0.0)
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / torch.clamp(union, min=1e-9)


def _one_hot(idx, n, dtype):
    """jax.nn.one_hot: rows of ``dtype``, all zero for an index outside [0, n)
    (F.one_hot would check the range on the host)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).to(
        dtype)


def _trunc_int(x):
    """float -> int64 toward zero, as JAX's astype(int32)."""
    return x.to(torch.int32).long()


def _sqrt_rn(x):
    """float32 sqrt rounded correctly, as XLA's is: through float64, whose
    sqrt rounded to float32 is the correctly rounded float32 sqrt. PyTorch's
    vectorized CPU float32 sqrt is not (1 ulp off for 15 % of values in
    [0.04, 0.6], torch 2.13 on AVX2 and AVX-512 CPUs)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _winners(key, do, last: bool = True):
    """(B, T) mask of the truths whose row a sequential walk leaves in place:
    among the applied truths (``do``) with the same ``key`` in an image, the
    last one (``last``) or the first one."""
    T = key.shape[1]
    order = torch.arange(T, device=key.device)
    later = (order.view(1, 1, T) > order.view(1, T, 1) if last
             else order.view(1, 1, T) < order.view(1, T, 1))
    beaten = ((key.unsqueeze(1) == key.unsqueeze(2)) & later
              & do.unsqueeze(1)).any(dim=-1)
    return do & ~beaten


def _scatter_rows(target, key, win, rows):
    """target (B, ..., D) with its rows at flat index ``key`` (B, T) set to
    ``rows`` (B, T, D) where ``win``; the other truths write a scratch row
    past the real ones, which is dropped, so the indices written are
    unique and nothing is filtered on the host."""
    B, D = target.shape[0], target.shape[-1]
    cells = target[0].numel() // D
    flat = torch.cat([target.reshape(B, cells, D),
                      target.new_zeros((B, 1, D))], 1)
    b = torch.arange(B, device=key.device).view(B, 1)
    flat[b, torch.where(win, key, cells)] = rows.to(flat.dtype)
    return flat[:, :cells].reshape(target.shape)


def _v3_scale_delta(raw, truths, anchors_all, mask, input_size,
                    ignore_thresh, truth_thresh, num_classes):
    """Delta (B, G, G, A, 5+C) and metric sums of one scale.

    raw: (B, G, G, A*(5+C)) raw head (NHWC cell layout, anchor-major),
    already detached; truths (B, T, 5); anchors_all (N, 2) pixels; mask the
    anchor indices this scale owns."""
    B, G = raw.shape[0], raw.shape[1]
    A, C = len(mask), num_classes
    dev = raw.device
    p = raw.reshape(B, G, G, A, 5 + C)
    txy = torch.sigmoid(p[..., 0:2])
    tobj = torch.sigmoid(p[..., 4])
    tcls = torch.sigmoid(p[..., 5:])

    # decoded pred boxes, normalized (get_yolo_box, yolo_layer.c:85-91)
    grid = torch.arange(G, device=dev, dtype=raw.dtype)
    col = grid.view(1, 1, G, 1)
    row = grid.view(1, G, 1, 1)
    mask_arr = torch.tensor(mask, dtype=torch.long).to(dev, non_blocking=True)
    anchors_px = anchors_all[mask_arr]
    bx = (col + txy[..., 0]) / G
    by = (row + txy[..., 1]) / G
    # exp clamped at 10, as the TPU package does
    bw = torch.exp(torch.clamp(p[..., 2], max=10.0)) * anchors_px[:, 0] \
        / input_size
    bh = torch.exp(torch.clamp(p[..., 3], max=10.0)) * anchors_px[:, 1] \
        / input_size
    pred = torch.stack([bx, by, bw, bh], -1)                  # (B,G,G,A,4)

    tvalid = truths[..., 2] > 0                               # (B, T)
    ious = _box_iou_xywh(pred.unsqueeze(-2),
                         truths[:, None, None, None, :, :4])  # (B,G,G,A,T)
    ious = torch.where(tvalid[:, None, None, None, :], ious, -1.0)
    best_iou = ious.amax(dim=-1)

    delta = raw.new_zeros((B, G, G, A, 5 + C))
    # noobj delta everywhere, zeroed where best_iou > ignore (yolo:178-183)
    delta[..., 4] = torch.where(best_iou > ignore_thresh, 0.0, 0.0 - tobj)
    if truth_thresh < 1.0:
        # yolo:184-193, inert at the default 1.0
        best_t = torch.argmax(ious, dim=-1)   # first maximum, as jnp's
        over = best_iou > truth_thresh
        t_sel = torch.gather(
            truths, 1, best_t.reshape(B, -1, 1).expand(-1, -1, 5)
        ).reshape(B, G, G, A, 5)
        onehot = _one_hot(_trunc_int(t_sel[..., 4]), C, raw.dtype)
        delta[..., 4] = torch.where(over, 1.0 - tobj, delta[..., 4])
        delta[..., 5:] += torch.where(over.unsqueeze(-1), onehot - tcls, 0.0)

    return _assign_vectorized(delta, truths, anchors_all,
                              anchors_all / input_size, mask_arr, G, A, C,
                              input_size, txy, p, tobj, tcls, pred)


def _assign_vectorized(delta, truths, anchors_all, anchors_norm, mask_arr,
                       G, A, C, input_size, txy, p, tobj, tcls, pred):
    """Per-truth assignment (yolo_layer.c:196-240), all truths at once: each
    truth's best anchor over the full table by wh-only IoU, applied only if
    this scale owns it, the later truth winning a shared (cell, anchor)."""
    B, T = truths.shape[:2]
    dev = truths.device
    t = truths
    valid = t[..., 2] > 0
    wh = torch.cat([torch.zeros_like(t[..., :2]), t[..., 2:4]], -1)
    anc = torch.cat([torch.zeros_like(anchors_norm), anchors_norm], -1)
    wh_iou = _box_iou_xywh(wh[:, :, None, :], anc[None, None])   # (B,T,N)
    best_n = torch.argmax(wh_iou, dim=-1)                        # (B,T)
    hit = mask_arr.view(1, 1, -1) == best_n.unsqueeze(-1)        # (B,T,A)
    in_scale = hit.any(dim=-1)
    slot = torch.argmax(hit.to(torch.uint8), dim=-1)
    ci = torch.clamp(_trunc_int(t[..., 0] * G), 0, G - 1)
    cj = torch.clamp(_trunc_int(t[..., 1] * G), 0, G - 1)
    do = valid & in_scale

    scale = 2.0 - t[..., 2] * t[..., 3]
    tx = t[..., 0] * G - ci
    ty = t[..., 1] * G - cj
    tw = torch.log(torch.clamp(t[..., 2] * input_size
                               / anchors_all[best_n, 0], min=1e-9))
    th = torch.log(torch.clamp(t[..., 3] * input_size
                               / anchors_all[best_n, 1], min=1e-9))
    b = torch.arange(B, device=dev).view(B, 1)
    txy_sel = txy[b, cj, ci, slot]                               # (B,T,2)
    p_sel = p[b, cj, ci, slot]                                   # (B,T,5+C)
    tobj_sel = tobj[b, cj, ci, slot]                             # (B,T)
    tcls_sel = tcls[b, cj, ci, slot]                             # (B,T,C)
    dbox = torch.stack([scale * (tx - txy_sel[..., 0]),
                        scale * (ty - txy_sel[..., 1]),
                        scale * (tw - p_sel[..., 2]),
                        scale * (th - p_sel[..., 3])], -1)
    cls = _trunc_int(t[..., 4])
    donehot = _one_hot(cls, C, tcls_sel.dtype) - tcls_sel
    new = torch.cat([dbox, (1.0 - tobj_sel).unsqueeze(-1), donehot], -1)

    key = (cj * G + ci) * A + slot
    delta = _scatter_rows(delta, key, _winners(key, do), new)

    # metrics count every applied truth, overwritten or not (yolo:232-238)
    iou_k = _box_iou_xywh(pred[b, cj, ci, slot], t[..., :4])
    # a class index outside [0, C) reads the nearest class, as a JAX gather
    cls_p = torch.gather(tcls_sel, -1, cls.clamp(0, C - 1).unsqueeze(-1))
    metrics = {"count": do.float().sum(),
               "iou_sum": torch.where(do, iou_k, 0.0).sum(),
               "obj_sum": torch.where(do, tobj_sel, 0.0).sum(),
               "cls_sum": torch.where(do, cls_p[..., 0], 0.0).sum()}
    return delta, metrics


def yolo_v3_loss(raw_scales, truths, cfg, *, anchor_masks,
                 ignore_thresh=0.5, truth_thresh=1.0,
                 truth_assign: str = "vectorized"):
    """Full v3 loss over all FPN scales.

    raw_scales: (B, G, G, A*(5+C)) float32 raw maps in spec order; truths
    (B, T, 5). Returns (loss, metrics): the loss's value is darknet's cost
    sum(delta^2) and its gradient with respect to each raw map is
    -delta / batch; metrics are 0-d tensors (cost, avg_iou, avg_obj,
    avg_cat, count) that stay on the device."""
    if truth_assign != "vectorized":
        raise NotImplementedError(
            f"truth_assign={truth_assign!r}: the sequential scan is left "
            "out of the port (ROADMAP.md, Queue 1 item 14); use the "
            "equal 'vectorized' form")
    dev = raw_scales[0].device
    anchors_all = torch.tensor(cfg.anchors, dtype=torch.float32).to(
        dev, non_blocking=True)
    truths = torch.as_tensor(truths, dtype=torch.float32, device=dev)
    batch = raw_scales[0].shape[0]
    surrogate = total_cost = agg = None
    for raw, mask in zip(raw_scales, anchor_masks):
        with torch.no_grad():
            delta, m = _v3_scale_delta(
                raw.detach(), truths, anchors_all, tuple(mask),
                cfg.input_size, ignore_thresh, truth_thresh, cfg.num_classes)
        # 1/batch: darknet applies learning_rate/batch at update time
        s = -(delta.reshape(batch, -1) * raw.reshape(batch, -1)).sum() / batch
        c = (delta * delta).sum()
        surrogate = s if surrogate is None else surrogate + s
        total_cost = c if total_cost is None else total_cost + c
        agg = m if agg is None else {k: agg[k] + m[k] for k in m}
    count = torch.clamp(agg["count"], min=1.0)
    metrics = {"cost": total_cost,
               "avg_iou": agg["iou_sum"] / count,
               "avg_obj": agg["obj_sum"] / count,
               "avg_cat": agg["cls_sum"] / count,
               "count": agg["count"]}
    # value = darknet cost; gradient = darknet -delta (via the surrogate)
    loss = surrogate - surrogate.detach() + total_cost
    return loss, metrics


def _tree_not_ported(tree):
    if tree is not None:
        raise NotImplementedError(
            "the YOLO9000 softmax-tree branch of the region loss is not "
            "ported (ROADMAP.md, Queue 1 item 13: models/tree.py)")


# --------------------------------------------------------------------------
# YOLOv2, the TF reference's Loss.py
# --------------------------------------------------------------------------

def build_v2_targets(truths, cfg, grid: int):
    """The (coords, confs, probs) targets of Loss.py from padded truths:
    the cell of each valid truth gets, at every anchor, coords (cell-offset
    x, y, sqrt w, sqrt h), conf 1 and the one-hot class; a later truth in
    the same cell wins."""
    H = W = grid
    A, C = cfg.num_anchors, cfg.num_classes
    t = torch.as_tensor(truths, dtype=torch.float32)
    B = t.shape[0]
    valid = t[..., 2] > 0
    ci = torch.clamp(_trunc_int(t[..., 0] * W), 0, W - 1)
    cj = torch.clamp(_trunc_int(t[..., 1] * H), 0, H - 1)
    cell = cj * W + ci
    xy = torch.stack([t[..., 0] * W - ci, t[..., 1] * H - cj], -1)
    wh = _sqrt_rn(torch.clamp(t[..., 2:4], min=1e-9))
    onehot = _one_hot(_trunc_int(t[..., 4]), C, torch.float32)
    row = torch.cat([xy, wh, torch.ones_like(xy[..., :1]), onehot], -1)
    rows = row.unsqueeze(2).expand(-1, -1, A, -1).reshape(B, -1, A * (5 + C))
    win = _winners(cell, valid)
    grid_rows = _scatter_rows(t.new_zeros((B, H * W, A * (5 + C))), cell,
                              win, rows).reshape(B, H * W, A, 5 + C)
    return {"coords": grid_rows[..., :4], "confs": grid_rows[..., 4],
            "probs": grid_rows[..., 5:]}


def yolo_v2_loss(raw, targets, cfg, *, grid: int = 13,
                 scales=(1.0, 5.0, 1.0, 1.0)):
    """Loss.py:10-79. raw (B, H, W, A*(5+C)); targets from
    build_v2_targets; scales = (sprob, sconf, snoob, scoor), Loss.py's
    weights of each term. Returns (loss, {"cost", "avg_iou"}), the metrics
    detached."""
    H = W = grid
    A, C = cfg.num_anchors, cfg.num_classes
    B = raw.shape[0]
    sprob, sconf, snoob, scoor = scales
    dev = raw.device
    anchors = torch.as_tensor(cfg.anchors, dtype=torch.float32,
                              device=dev).reshape(1, 1, A, 2)
    hw = torch.tensor([W, H], dtype=torch.float32).to(dev, non_blocking=True)

    p = raw.reshape(B, H * W, A, 5 + C)
    coords_xy = torch.sigmoid(p[..., 0:2])
    coords_wh = torch.sqrt(torch.exp(p[..., 2:4]) * anchors / hw)
    coords = torch.cat([coords_xy, coords_wh], -1)
    confs = torch.sigmoid(p[..., 4:5])
    probs = torch.softmax(p[..., 5:], dim=-1)
    _coords, _confs, _probs = (targets["coords"], targets["confs"],
                               targets["probs"])

    def corners(c):
        wh = torch.square(c[..., 2:4]) * hw
        ctr = c[..., 0:2]
        return ctr - wh * 0.5, ctr + wh * 0.5, wh[..., 0] * wh[..., 1]

    ul, dr, area = corners(coords)
    _ul, _dr, _area = corners(_coords)
    iw = torch.clamp(torch.minimum(dr, _dr) - torch.maximum(ul, _ul),
                     min=0.0)
    inter = iw[..., 0] * iw[..., 1]
    ious = inter / torch.clamp(area + _area - inter, min=1e-9)

    best = (ious >= ious.amax(dim=2, keepdim=True)).to(torch.float32)
    mask = (best * _confs).unsqueeze(-1)                    # (B,HW,A,1)
    confs_w = snoob * (1.0 - mask) + sconf * mask
    weights = torch.cat([(scoor * mask).expand_as(coords),
                         confs_w.expand_as(confs),
                         (sprob * mask).expand_as(probs)], -1)
    preds = torch.cat([coords, confs, probs], -1)
    truths_cat = torch.cat([_coords, _confs.unsqueeze(-1), _probs], -1)
    per_image = (torch.square(preds - truths_cat) * weights).sum(
        dim=(1, 2, 3))
    loss = 0.5 * per_image.mean()
    with torch.no_grad():
        avg_iou = (ious * mask[..., 0]).sum() / torch.clamp(mask.sum(),
                                                             min=1.0)
    return loss, {"cost": loss.detach(), "avg_iou": avg_iou}


# --------------------------------------------------------------------------
# YOLOv2, darknet's region layer
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RegionHyper:
    """[region] section options (parse_region, src/parser.c:341-391).
    Defaults are upstream yolov2.cfg's trained values."""
    thresh: float = 0.6
    object_scale: float = 5.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    bias_match: bool = True
    rescore: bool = True
    softmax: bool = True
    warmup_seen: int = 12800

    @classmethod
    def from_options(cls, opts):
        """Build from a parsed [region] cfg section dict."""
        kw = {}
        for field in ("thresh", "object_scale", "noobject_scale",
                      "class_scale", "coord_scale"):
            if field in opts:
                kw[field] = float(opts[field])
        for field in ("bias_match", "rescore", "softmax"):
            if field in opts:
                kw[field] = bool(int(opts[field]))
        return cls(**kw)


def _region_delta(raw, truths, anchors, seen, hyper: RegionHyper,
                  num_classes: int):
    """Delta (B, H, W, A, 5+C) and metric sums of forward_region_layer
    (src/region_layer.c:158-320). raw (B, H, W, A*(5+C)) anchor-major
    (tx, ty, tw, th, obj, classes) blocks, detached; truths (B, T, 5);
    anchors (A, 2) in grid units; seen a 0-d tensor, the images processed so
    far, which turns the bias-match warm-up on below hyper.warmup_seen."""
    B, H, W = raw.shape[:3]
    A, C = anchors.shape[0], num_classes
    dev = raw.device
    p = raw.reshape(B, H, W, A, 5 + C)
    sxy = torch.sigmoid(p[..., 0:2])
    sobj = torch.sigmoid(p[..., 4])
    cls_out = (torch.softmax(p[..., 5:], dim=-1) if hyper.softmax
               else torch.sigmoid(p[..., 5:]))

    # decoded boxes, normalized (get_region_box, region_layer.c:76-84)
    col = torch.arange(W, device=dev, dtype=raw.dtype).view(1, 1, W, 1)
    row = torch.arange(H, device=dev, dtype=raw.dtype).view(1, H, 1, 1)
    bx = (col + sxy[..., 0]) / W
    by = (row + sxy[..., 1]) / H
    bw = torch.exp(torch.clamp(p[..., 2], max=10.0)) * anchors[:, 0] / W
    bh = torch.exp(torch.clamp(p[..., 3], max=10.0)) * anchors[:, 1] / H
    pred = torch.stack([bx, by, bw, bh], -1)                  # (B,H,W,A,4)

    t = truths
    valid = t[..., 2] > 0                                     # (B, T)
    ious = _box_iou_xywh(pred.unsqueeze(-2), t[:, None, None, None, :, :4])
    ious = torch.where(valid[:, None, None, None, :], ious, -1.0)
    best_iou = ious.amax(dim=-1)

    delta = raw.new_zeros((B, H, W, A, 5 + C))
    # noobject everywhere, zeroed above thresh (region_layer.c:243-250)
    delta[..., 4] = torch.where(best_iou > hyper.thresh, 0.0,
                                hyper.noobject_scale * (0.0 - sobj))
    # bias-match warm-up (region_layer.c:256-263): every box pulled toward
    # its cell-centred anchor with scale .01 while seen < 12800
    warm = (seen < hyper.warmup_seen).to(raw.dtype) * 0.01
    delta[..., 0:2] = warm * (0.5 - sxy)
    delta[..., 2:4] = warm * (0.0 - p[..., 2:4])

    # per truth (region_layer.c:265-318): the best anchor at the truth's
    # cell by origin-shifted IoU, with the anchors' wh (bias_match) or the
    # predicted wh there
    ci = torch.clamp(_trunc_int(t[..., 0] * W), 0, W - 1)
    cj = torch.clamp(_trunc_int(t[..., 1] * H), 0, H - 1)
    b = torch.arange(B, device=dev).view(B, 1)
    if hyper.bias_match:
        wh_grid = torch.tensor([W, H], dtype=torch.float32).to(
            dev, non_blocking=True)
        cand = (anchors / wh_grid).expand(B, t.shape[1], A, 2)
    else:
        cand = pred[b, cj, ci][..., 2:4]                      # (B,T,A,2)
    zeros = torch.zeros_like(cand)
    twh = torch.cat([torch.zeros_like(t[..., :2]), t[..., 2:4]], -1)
    wh_iou = _box_iou_xywh(twh.unsqueeze(2), torch.cat([zeros, cand], -1))
    best_n = torch.argmax(wh_iou, dim=-1)                     # (B, T)

    # delta_region_box (region_layer.c:87-104) at (cj, ci, best_n)
    scale = hyper.coord_scale * (2.0 - t[..., 2] * t[..., 3])
    tx = t[..., 0] * W - ci
    ty = t[..., 1] * H - cj
    tw = torch.log(torch.clamp(t[..., 2] * W / anchors[best_n, 0], min=1e-9))
    th = torch.log(torch.clamp(t[..., 3] * H / anchors[best_n, 1], min=1e-9))
    sxy_sel = sxy[b, cj, ci, best_n]                          # (B,T,2)
    p_sel = p[b, cj, ci, best_n]                              # (B,T,5+C)
    dbox = torch.stack([scale * (tx - sxy_sel[..., 0]),
                        scale * (ty - sxy_sel[..., 1]),
                        scale * (tw - p_sel[..., 2]),
                        scale * (th - p_sel[..., 3])], -1)
    iou = _box_iou_xywh(pred[b, cj, ci, best_n], t[..., :4])
    # objectness (region_layer.c:300-308)
    obj = sobj[b, cj, ci, best_n]
    dobj = hyper.object_scale * ((iou if hyper.rescore else 1.0) - obj)
    # class (delta_region_class: the full one-hot row)
    cls = _trunc_int(t[..., 4])
    cls_sel = cls_out[b, cj, ci, best_n]                      # (B,T,C)
    dcls = hyper.class_scale * (_one_hot(cls, C, raw.dtype) - cls_sel)
    new = torch.cat([dbox, dobj.unsqueeze(-1), dcls], -1)

    key = (cj * W + ci) * A + best_n
    delta = _scatter_rows(delta, key, _winners(key, valid), new)

    do = valid.to(raw.dtype)
    # a class index outside [0, C) reads the nearest class, as a JAX gather
    cat = torch.gather(cls_sel, -1, cls.clamp(0, C - 1).unsqueeze(-1))[..., 0]
    metrics = {"count": do.sum(), "iou_sum": (do * iou).sum(),
               "recall": (do * (iou > 0.5).to(raw.dtype)).sum(),
               "obj_sum": (do * obj).sum(), "cls_sum": (do * cat).sum(),
               "avg_anyobj": sobj.mean(dim=(1, 2, 3)).mean()}
    return delta, metrics


def _delta_loss(raw, delta):
    """(loss, cost): the value is darknet's cost sum(delta^2), the gradient
    with respect to raw -delta / batch (1/batch: darknet applies
    learning_rate / batch at update time)."""
    B = raw.shape[0]
    surrogate = -(delta.reshape(B, -1) * raw.reshape(B, -1)).sum() / B
    cost = (delta * delta).sum()
    return surrogate - surrogate.detach() + cost, cost


def yolo_v2_region_loss(raw, truths, cfg, *, seen=None,
                        hyper: RegionHyper = RegionHyper(), tree=None):
    """Darknet-exact v2 training loss (forward_region_layer). raw (B, H, W,
    A*(5+C)); truths (B, T, 5); seen: the images processed so far (a tensor
    on raw's device, or an int), which drives the warm-up; None means past
    it. cfg.anchors are in grid units. Returns (loss, metrics): cost,
    avg_iou, avg_cat, avg_obj, avg_anyobj, recall, count, 0-d tensors on
    the device. ``tree`` (YOLO9000) raises."""
    _tree_not_ported(tree)
    dev = raw.device
    anchors = torch.tensor(cfg.anchors, dtype=torch.float32).to(
        dev, non_blocking=True)
    truths = torch.as_tensor(truths, dtype=torch.float32, device=dev)
    # a 0-d CPU tensor (an int seen) enters the device arithmetic as a
    # scalar, with no copy
    seen = torch.as_tensor(hyper.warmup_seen if seen is None else seen)
    with torch.no_grad():
        delta, m = _region_delta(raw.detach(), truths, anchors, seen, hyper,
                                 cfg.num_classes)
    loss, cost = _delta_loss(raw, delta)
    count = torch.clamp(m["count"], min=1.0)
    metrics = {"cost": cost, "avg_iou": m["iou_sum"] / count,
               "avg_cat": m["cls_sum"] / count,
               "avg_obj": m["obj_sum"] / count,
               "avg_anyobj": m["avg_anyobj"], "recall": m["recall"] / count,
               "count": m["count"]}
    return loss, metrics


# --------------------------------------------------------------------------
# YOLOv1, darknet's detection layer
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DetectionHyper:
    """[detection] section options (parse_detection, src/parser.c:393-415).
    Defaults are upstream yolov1.cfg's trained values. ``forced`` pins
    responsibility by truth area (detection_layer.c:137-142); ``random``
    draws it while seen < 64000 (:143-145), here from a torch.Generator
    where the TPU package uses a JAX PRNG keyed by ``seen``: the same
    distribution, not the same draw."""
    object_scale: float = 1.0
    noobject_scale: float = 0.5
    class_scale: float = 1.0
    coord_scale: float = 5.0
    sqrt: bool = True
    rescore: bool = True
    softmax: bool = False
    forced: bool = False
    random: bool = False

    @classmethod
    def from_options(cls, opts):
        kw = {}
        for field in ("object_scale", "noobject_scale", "class_scale",
                      "coord_scale"):
            if field in opts:
                kw[field] = float(opts[field])
        for field in ("sqrt", "rescore", "softmax", "forced", "random"):
            if field in opts:
                kw[field] = bool(int(opts[field]))
        return cls(**kw)


def build_v1_truth_grid(truths, num_classes: int, side: int):
    """(B, T, 5) padded truths -> (B, S*S, 1+C+4) grid targets
    (fill_truth_region, src/data.c:254-300): the cell (int(x*S), int(y*S))
    of each box; the first box of a cell wins; boxes with w or h below
    .005 are skipped; rows [is_obj, one-hot class, x and y cell offsets,
    w, h]."""
    S, C = side, num_classes
    t = torch.as_tensor(truths, dtype=torch.float32)
    valid = (t[..., 2] >= 0.005) & (t[..., 3] >= 0.005)
    col = torch.clamp(_trunc_int(t[..., 0] * S), 0, S - 1)
    row = torch.clamp(_trunc_int(t[..., 1] * S), 0, S - 1)
    cell = row * S + col
    rows = torch.cat([torch.ones_like(t[..., :1]),
                      _one_hot(_trunc_int(t[..., 4]), C, torch.float32),
                      torch.stack([t[..., 0] * S - col, t[..., 1] * S - row,
                                   t[..., 2], t[..., 3]], -1)], -1)
    return _scatter_rows(t.new_zeros((t.shape[0], S * S, 1 + C + 4)), cell,
                         _winners(cell, valid, last=False), rows)


def _v1_delta(pred, truth_grid, rand_idx, use_random, hyper: DetectionHyper,
              side: int, num_boxes: int, num_classes: int):
    """Delta (B, S*S*(C+n*5)) and metric sums of forward_detection_layer
    (src/detection_layer.c:50-222). pred (B, S*S*C + S*S*n + S*S*n*4) raw
    output in darknet order [class probs | confidences | boxes];
    truth_grid from build_v1_truth_grid; rand_idx (B, S*S) and use_random
    (a 0-d bool tensor) drive the ``random`` responsibility override."""
    S, n, C = side, num_boxes, num_classes
    B, locs = pred.shape[0], side * side
    probs = pred[:, :locs * C].reshape(B, locs, C)
    if hyper.softmax:
        probs = torch.softmax(probs, dim=-1)
    confs = pred[:, locs * C:locs * (C + n)].reshape(B, locs, n)
    boxes = pred[:, locs * (C + n):].reshape(B, locs, n, 4)

    is_obj = truth_grid[..., 0]                               # (B, locs)
    t_cls = truth_grid[..., 1:1 + C]
    t_box = truth_grid[..., 1 + C:]
    # class deltas of object cells (detection_layer.c:98-104)
    dprobs = hyper.class_scale * (t_cls - probs) * is_obj.unsqueeze(-1)

    # responsibility: the best of n boxes by IoU, by rmse while every IoU
    # is 0 (detection_layer.c:106-136); xy as cell offset / side, wh
    # squared under sqrt
    truth_cmp = torch.cat([t_box[..., 0:2] / S, t_box[..., 2:4]], -1)
    wh = torch.square(boxes[..., 2:4]) if hyper.sqrt else boxes[..., 2:4]
    out_cmp = torch.cat([boxes[..., 0:2] / S, wh], -1)        # (B,locs,n,4)
    ious = _box_iou_xywh(out_cmp, truth_cmp.unsqueeze(2))     # (B,locs,n)
    rmses = torch.sqrt(torch.square(out_cmp - truth_cmp.unsqueeze(2)).sum(-1))

    # the C's scan, not an argmax: once an IoU > 0 has been seen the rmse
    # branch is dead; best_index starts at -1 (clamped to 0 after)
    best_index = torch.full((B, locs), -1, dtype=torch.long,
                            device=pred.device)
    best_iou = torch.zeros((B, locs), dtype=pred.dtype, device=pred.device)
    best_rmse = torch.full((B, locs), 20.0, dtype=pred.dtype,
                           device=pred.device)
    for j in range(n):
        iou_j, rmse_j = ious[..., j], rmses[..., j]
        cond = (best_iou > 0) | (iou_j > 0)
        pick = torch.where(cond, iou_j > best_iou, rmse_j < best_rmse)
        best_index = torch.where(pick, j, best_index)
        best_iou = torch.where(pick & cond, iou_j, best_iou)
        best_rmse = torch.where(pick & ~cond, rmse_j, best_rmse)
    best = torch.clamp(best_index, min=0)
    # overrides, before the selected box's IoU and confidence are read
    if hyper.forced:
        best = torch.where(t_box[..., 2] * t_box[..., 3] < 0.1, 1, 0)
    if hyper.random:
        best = torch.where(use_random, rand_idx, best)

    sel = _one_hot(best, n, pred.dtype) * is_obj.unsqueeze(-1)  # (B,locs,n)
    iou_best = torch.gather(ious, -1, best.unsqueeze(-1))[..., 0]
    conf_best = torch.gather(confs, -1, best.unsqueeze(-1))[..., 0]
    # confidence deltas: noobject everywhere, object / rescore at the
    # responsible box (detection_layer.c:85, :160-168)
    tgt = iou_best if hyper.rescore else torch.ones_like(iou_best)
    dconfs = torch.where(
        sel > 0, (hyper.object_scale * (tgt - conf_best)).unsqueeze(-1),
        hyper.noobject_scale * (0.0 - confs))
    # coordinate deltas at the responsible box (detection_layer.c:170-177)
    twh = torch.sqrt(t_box[..., 2:4]) if hyper.sqrt else t_box[..., 2:4]
    t_enc = torch.cat([t_box[..., 0:2], twh], -1)
    dboxes = (hyper.coord_scale * (t_enc.unsqueeze(2) - boxes)
              * sel.unsqueeze(-1))
    delta = torch.cat([dprobs.reshape(B, -1), dconfs.reshape(B, -1),
                       dboxes.reshape(B, -1)], -1)
    metrics = {
        "count": is_obj.sum(),
        "iou_sum": (iou_best * is_obj).sum(),
        "cat_sum": (probs * t_cls * is_obj.unsqueeze(-1)).sum(),
        "allcat_sum": (probs * is_obj.unsqueeze(-1)).sum(),
        "obj_sum": (conf_best * is_obj).sum(),
        "anyobj_sum": confs.sum(),
    }
    return delta, metrics


def yolo_v1_loss(pred_flat, truths, cfg, *,
                 hyper: DetectionHyper = DetectionHyper(), seen=None,
                 generator=None):
    """Darknet-exact v1 training loss (forward_detection_layer). pred_flat
    (B, S*S*(C+n*5)) raw connected output; truths (B, T, 5). The value is
    sum(delta^2), the gradient -delta / batch. ``hyper.random`` needs
    ``seen`` (it gates the draw while seen < 64000) and ``generator``, the
    torch.Generator on pred's device that the responsibility is drawn
    from."""
    B = pred_flat.shape[0]
    S, n, C = cfg.grid, cfg.boxes_per_cell, cfg.num_classes
    dev = pred_flat.device
    pred = pred_flat.to(torch.float32)
    grid = build_v1_truth_grid(torch.as_tensor(truths, device=dev), C, S)
    if hyper.random:
        if seen is None or generator is None:
            raise ValueError(
                "hyper.random=True needs the `seen` counter (it gates the "
                "seen < 64000 warm-up, detection_layer.c:143-145) and a "
                "torch.Generator to draw the responsibility from")
        rand_idx = torch.randint(0, n, (B, S * S), generator=generator,
                                 device=dev)
        use_random = torch.as_tensor(seen).to(dev) < 64000
    else:
        rand_idx, use_random = None, None
    with torch.no_grad():
        delta, m = _v1_delta(pred.detach(), grid, rand_idx, use_random,
                             hyper, S, n, C)
    loss, cost = _delta_loss(pred, delta)
    count = torch.clamp(m["count"], min=1.0)
    metrics = {
        "cost": cost,
        "avg_iou": m["iou_sum"] / count,
        "avg_cat": m["cat_sum"] / count,
        "avg_allcat": m["allcat_sum"] / (count * C),
        "avg_obj": m["obj_sum"] / count,
        "avg_anyobj": m["anyobj_sum"] / (B * S * S * n),
        "count": m["count"],
    }
    return loss, metrics


# --------------------------------------------------------------------------
# Classifier (darknet's softmax + cost layers, examples/classifier.c)
# --------------------------------------------------------------------------

def classifier_loss(logits_or_probs, labels, *, from_probs: bool = True):
    """Softmax cross-entropy of head-0 models. Their specs end in a Softmax
    layer (darknet's [softmax] + [cost]), so by default this takes
    probabilities; from_probs=False takes logits. labels (B,) class ids.
    Returns (loss, {"cost", "accuracy"}), the metrics detached."""
    x = logits_or_probs.to(torch.float32)
    if from_probs:
        logp = torch.log(torch.clamp(x, min=1e-12))
    else:
        logp = torch.log_softmax(x, dim=-1)
    labels = torch.as_tensor(labels, device=x.device).long()
    # a label outside [0, C) reads the nearest class, as a JAX gather does
    nll = -torch.gather(logp, 1, labels.clamp(0, x.shape[1] - 1)
                        .unsqueeze(1))[:, 0]
    loss = nll.mean()
    acc = (torch.argmax(logp.detach(), -1) == labels).to(torch.float32).mean()
    return loss, {"cost": loss.detach(), "accuracy": acc}
