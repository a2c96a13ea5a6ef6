"""The YOLOv3 training loss with darknet-exact gradients, in PyTorch.

Counterpart of yolo_tensorflow_tpu/train/losses.py for the v3 family
(src/yolo_layer.c:132-240 semantics). Darknet builds a ``delta`` tensor
(target - output on the activated xy/obj/class outputs, on the raw logits
for tw/th) and backpropagates it directly, so its gradient with respect to
the raw feature map is exactly -delta. The loss reproduces that with a
linear surrogate, -sum(delta * raw) / batch with delta detached, whose value
is replaced by darknet's printed cost sum(delta^2).

Batched over images with an explicit batch dimension (the TPU package vmaps
one image). Truths are (B, T, 5) normalized (cx, cy, w, h, class), padded
with w == 0 rows. Nothing here syncs with the host: the last-writer-wins
scatter routes losing truths to a scratch row instead of filtering them.
The sequential "scan" assignment, and the v2, v1 and classifier losses, are
not ported (ROADMAP.md).
"""

from __future__ import annotations

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
    mask_arr = torch.as_tensor(mask, device=dev, dtype=torch.long)
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

    # last writer wins: truth k loses to any later applied truth j > k with
    # the same (cell, anchor)
    key = (cj * G + ci) * A + slot
    order = torch.arange(T, device=dev)
    beaten = ((key.unsqueeze(1) == key.unsqueeze(2))
              & (order.view(1, 1, T) > order.view(1, T, 1))
              & do.unsqueeze(1)).any(dim=-1)
    win = do & ~beaten
    # losers go to a scratch row past the real ones, which is dropped
    cells = G * G * A
    flat = torch.cat([delta.reshape(B, cells, 5 + C),
                      delta.new_zeros((B, 1, 5 + C))], 1)
    flat[b, torch.where(win, key, cells)] = new
    delta = flat[:, :cells].reshape(delta.shape)

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
    anchors_all = torch.as_tensor(cfg.anchors, dtype=torch.float32,
                                  device=dev)
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
