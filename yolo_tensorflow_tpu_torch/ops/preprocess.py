"""Darknet-exact letterbox on the device, batched, and the box un-mapping.

Counterpart of yolo_tensorflow_tpu/ops/preprocess.py (letterbox_geometry,
letterbox_device, letterbox_device_batch, resize_device, unmap_boxes_device). The host only
copies raw uint8 pixels into the top-left corner of a fixed canvas; the
aspect-preserving resize and pad, the per-model normalization and, after
detection, the un-mapping of the boxes into each image's own pixels run on
the device, with each image's size as a tensor, so no step reads it back.

Semantics, as the TPU package's (tests/test_preprocess.py pins it to the C):
  - new_w, new_h by integer division (letterbox_image, src/image.c:960),
  - resize_image's align-corners bilinear (src/image.c:1347), horizontal
    pass first, with its two edge rules: the last output column copies the
    source's last column, and the last output row keeps its (1 - dy) weight
    but skips the dy term,
  - pad value 0.5 (in [0, 1] pixels), embed offset (S - new)/2 by integer
    division.

Form. On the TPU the separable bilinear was two one-hot matmuls, because
gathers were slow there; each output value has at most two source weights,
so the matmul is the two-term gather it stands for, and on this card it is
written as one: ``x[:, ix]*(1-dx) + x[:, ix1]*dx``, then the same over the
rows, as eager ops. The second product and the sum are one
``torch.addcmul``: the TPU package's dot, run by XLA on the CPU, adds each
term to its running sum with a fused multiply-add, and addcmul on the CPU
rounds the same way, so the f32 form is bit for bit the JAX one there. In
bf16 every product is exact in float32, so only the sums round.
"""

from __future__ import annotations

import numpy as np
import torch

_INV_255 = 1.0 / 255.0


def letterbox_geometry(img_w, img_h, out_size: int):
    """(new_w, new_h, px, py) as int32 tensors (letterbox_image,
    src/image.c:960-978); img_w and img_h are ints or int32 tensors of any
    shape, at least 1."""
    img_w = torch.as_tensor(img_w, dtype=torch.int32)
    img_h = torch.as_tensor(img_h, dtype=torch.int32)
    s = out_size
    wide = img_w > img_h            # (float)S/w < (float)S/h  <=>  w > h
    new_w = torch.where(wide, s, (img_w * s) // img_h).to(torch.int32)
    new_h = torch.where(wide, (img_h * s) // img_w, s).to(torch.int32)
    return new_w, new_h, (s - new_w) // 2, (s - new_h) // 2


def _axis(size, new, pad, out_size: int, canvas: int):
    """One axis of the resize for every image: for (B,) int32 image sizes,
    resized sizes and pads -> (i0, i1, w0, w1, inside), each (B, S): the two
    source indices of every output index, their weights (1 - d) and d
    (d = 0 on the last index: resize_image's last column), and whether the
    index lies in the resized image."""
    out = torch.arange(out_size, dtype=torch.int32, device=size.device)
    pos = out[None, :] - pad[:, None]               # index in the resized
    inside = (pos >= 0) & (pos < new[:, None])
    scale = ((size - 1).to(torch.float32)
             / torch.clamp(new - 1, min=1).to(torch.float32))
    src = pos.to(torch.float32) * scale[:, None]
    i0 = torch.floor(src).to(torch.int32)
    d = src - i0.to(torch.float32)
    last = (pos == new[:, None] - 1) | (size[:, None] == 1)
    return (torch.clamp(i0, 0, canvas - 1).long(),
            torch.clamp(i0 + 1, 0, canvas - 1).long(), 1 - d, d, last,
            inside)


def _bilinear(canvas_u8, cols, rows, compute_dtype, rescale):
    """The separable bilinear of every image from its two source indices
    and weights per output column and row: ``cols`` = (ix, ix1, wl, wr),
    (B, out_w) each, ``rows`` = (iy, iy1, wt, wb), (B, out_h) each ->
    float32 (B, out_h, out_w, 3) = rescale * the resize of canvas / 255.
    Horizontal pass first, each pass's second product and sum one
    ``torch.addcmul`` (the TPU package's dot on its CPU backend)."""
    ix, ix1, wl, wr = cols
    iy, iy1, wt, wb = rows
    B, Hc = canvas_u8.shape[:2]
    b = torch.arange(B, device=canvas_u8.device)[:, None, None]
    r = torch.arange(Hc, device=canvas_u8.device)[None, :, None]
    left = canvas_u8[b, r, ix[:, None, :]]          # (B, Hc, out_w, 3)
    right = canvas_u8[b, r, ix1[:, None, :]]
    narrow = compute_dtype is not None and compute_dtype != torch.float32
    if narrow:
        wl, wr = ((v * (rescale / 255.0)).to(compute_dtype).float()
                  for v in (wl, wr))
        wt, wb = (v.to(compute_dtype).float() for v in (wt, wb))
        part = torch.addcmul(left.float() * wl[:, None, :, None],
                             right.float(), wr[:, None, :, None])
        part = part.to(compute_dtype)
    else:
        # x / 255 as the TPU package's program computes it: XLA turns a
        # division by a constant into a product with its reciprocal
        part = torch.addcmul(left.float() * _INV_255 * wl[:, None, :, None],
                             right.float() * _INV_255, wr[:, None, :, None])
    b = b[:, :, 0]
    top = part[b, iy].float()                        # (B, out_h, out_w, 3)
    bottom = part[b, iy1].float()
    val = torch.addcmul(top * wt[:, :, None, None], bottom,
                        wb[:, :, None, None])
    if not narrow and rescale != 1.0:
        # post-multiplied, as the TPU package's f32 path does
        val = val * rescale
    return val


def letterbox_device_batch(canvas_u8, sizes, out_size: int,
                           compute_dtype=None, rescale: float = 1.0,
                           offset: float = 0.0):
    """uint8 canvases (B, Hc, Wc, 3) whose top-left [0:h, 0:w] holds each
    image, and int32 sizes (B, 2) [h, w] on the same device -> float32
    (B, 3, S, S) in channels-last memory (the NHWC bytes, as
    ``pipeline.normalize_images`` gives): rescale * letterbox_image(
    resize_image(im / 255)) + offset, the pad 0.5 * rescale + offset.

    ``compute_dtype=torch.bfloat16`` is the serving form of the TPU
    package: the raw uint8 pixels (exact in bf16) times the column weights
    (1 - dx) and dx folded with rescale / 255 and rounded to bf16, the two
    exact products summed in float32, that row rounded to bf16; then the row
    weights rounded to bf16 and the column pass in float32."""
    _, Hc, Wc, _ = canvas_u8.shape
    S = out_size
    sizes = sizes.to(torch.int32)
    h, w = sizes[:, 0], sizes[:, 1]
    new_w, new_h, px, py = letterbox_geometry(w, h, S)
    ix, ix1, wl, wr, last_col, in_c = _axis(w, new_w, px, S, Wc)
    iy, iy1, wt, wb, last_row, in_r = _axis(h, new_h, py, S, Hc)
    # the last column copies the source's last column outright; the last
    # row keeps (1 - dy) and skips the dy term (image.c:1380)
    ix = torch.where(last_col, (w - 1).long()[:, None].clamp(0, Wc - 1), ix)
    wl = torch.where(last_col, 1.0, wl)
    wr = torch.where(last_col, 0.0, wr)
    wb = torch.where(last_row, 0.0, wb)
    # zero weights outside the resized image, as the TPU package's matrices
    wl, wr = (torch.where(in_c, v, 0.0) for v in (wl, wr))
    wt, wb = (torch.where(in_r, v, 0.0) for v in (wt, wb))
    val = _bilinear(canvas_u8, (ix, ix1, wl, wr), (iy, iy1, wt, wb),
                    compute_dtype, rescale)
    inside = in_r[:, :, None, None] & in_c[:, None, :, None]
    out = torch.where(inside, val, 0.5 * rescale)
    if offset != 0.0:
        out = out + offset
    return out.permute(0, 3, 1, 2)


def _resize_axis(size, out: int):
    """One axis of resize_image from each image's true size (B,) int32 to
    the static ``out``: (i0, 1 - d, d, last), each (B, out): the first
    source index, the two weights, whether it is the last index. The scale
    (size - 1) / (out - 1) divides by a constant, which the TPU package's
    compiled program turns into a product with its float32 reciprocal."""
    idx = torch.arange(out, dtype=torch.int32, device=size.device)
    inv = float(np.float32(1.0) / np.float32(max(out - 1, 1)))
    scale = (size - 1).to(torch.float32) * inv
    src = idx.to(torch.float32)[None, :] * scale[:, None]
    i0 = torch.floor(src).to(torch.int32)
    d = src - i0.to(torch.float32)
    last = (idx[None, :] == out - 1) | (size[:, None] == 1)
    return i0, 1 - d, d, last


def resize_device_batch(canvas_u8, sizes, out_h: int, out_w: int,
                        compute_dtype=None, rescale: float = 1.0,
                        offset: float = 0.0):
    """darknet's stretch resize_image (src/image.c:1347) of every image on
    its device: uint8 canvases (B, Hc, Wc, 3) whose top-left [0:h, 0:w]
    holds each image, and int32 sizes (B, 2) [h, w] -> float32 (B, 3,
    out_h, out_w) in channels-last memory = rescale * resize_image(im,
    out_w, out_h) / 255 + offset. The counterpart of the TPU package's
    ``resize_device`` (one image, vmapped by its callers): the classifier's
    evaluation modes, stretch to the net size, the 10-crop base of side
    S + 32 and the full / multi modes' resize_min / resize_max shapes. Both
    edge rules of ``letterbox_device_batch``, no pad; ``compute_dtype`` as
    there."""
    _, Hc, Wc, _ = canvas_u8.shape
    sizes = sizes.to(torch.int32)
    h, w = sizes[:, 0], sizes[:, 1]
    ix, wl, wr, last_col = _resize_axis(w, out_w)
    iy, wt, wb, last_row = _resize_axis(h, out_h)
    ix = torch.where(last_col, (w - 1)[:, None], ix)
    wl = torch.where(last_col, 1.0, wl)
    wr = torch.where(last_col, 0.0, wr)
    wb = torch.where(last_row, 0.0, wb)
    cols = (ix.clamp(0, Wc - 1).long(), (ix + 1).clamp(0, Wc - 1).long(),
            wl, wr)
    rows = (iy.clamp(0, Hc - 1).long(), (iy + 1).clamp(0, Hc - 1).long(),
            wt, wb)
    val = _bilinear(canvas_u8, cols, rows, compute_dtype, rescale)
    if offset != 0.0:
        val = val + offset
    return val.permute(0, 3, 1, 2)


def resize_device(canvas_u8, img_h, img_w, out_h: int, out_w: int, **kw):
    """One image: (Hc, Wc, 3) uint8 canvas and its size -> (3, out_h,
    out_w)."""
    sizes = torch.as_tensor([[img_h, img_w]], dtype=torch.int32,
                            device=canvas_u8.device)
    return resize_device_batch(canvas_u8[None], sizes, out_h, out_w,
                               **kw)[0]


def letterbox_device(canvas_u8, img_h, img_w, out_size: int, **kw):
    """One image: (Hc, Wc, 3) uint8 canvas and its size -> (3, S, S)."""
    sizes = torch.as_tensor([[img_h, img_w]], dtype=torch.int32,
                            device=canvas_u8.device)
    return letterbox_device_batch(canvas_u8[None], sizes, out_size, **kw)[0]


def unmap_boxes_device(boxes_xyxy_norm, img_h, img_w, out_size: int):
    """Normalized network-space xyxy boxes (..., D, 4) -> each image's own
    pixels: the inverse of the letterbox (correct_yolo_boxes with the
    integral embed offsets), clipped to the image. ``img_h`` and ``img_w``
    are ints or int32 tensors of the boxes' leading shape."""
    h = torch.as_tensor(img_h, dtype=torch.int32,
                        device=boxes_xyxy_norm.device)
    w = torch.as_tensor(img_w, dtype=torch.int32,
                        device=boxes_xyxy_norm.device)
    new_w, new_h, px, py = (v[..., None] for v in
                            letterbox_geometry(w, h, out_size))
    wf = w.to(torch.float32)[..., None]
    hf = h.to(torch.float32)[..., None]
    bx = boxes_xyxy_norm * out_size
    x0 = (bx[..., 0] - px) * wf / new_w.to(torch.float32)
    y0 = (bx[..., 1] - py) * hf / new_h.to(torch.float32)
    x1 = (bx[..., 2] - px) * wf / new_w.to(torch.float32)
    y1 = (bx[..., 3] - py) * hf / new_h.to(torch.float32)
    zero = torch.zeros_like(wf)
    return torch.stack([torch.clamp(x0, zero, wf), torch.clamp(y0, zero, hf),
                        torch.clamp(x1, zero, wf), torch.clamp(y1, zero, hf)],
                       dim=-1)
