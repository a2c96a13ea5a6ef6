"""Detection augmentation — the semantics of src/data.c:957
(load_data_detection): jitter crop/place, HSV distortion, horizontal flip,
with box labels remapped. Host-side numpy/cv2; the threaded loader
(data/loader.py, native/yolodata.cpp) runs it in parallel off the TPU path.
"""

from __future__ import annotations

import numpy as np


def _rand_scale(rng, s):
    """darknet rand_scale: uniform in [1, s], inverted half the time."""
    scale = rng.uniform(1.0, s)
    return scale if rng.random() < 0.5 else 1.0 / scale


def sample_hsv(rng, hue=0.1, sat=1.5, exposure=1.5):
    """Sample HSV distortion params (data.c random_distort_image)."""
    return (float(rng.uniform(-hue, hue)), float(_rand_scale(rng, sat)),
            float(_rand_scale(rng, exposure)))


def apply_hsv(image_u8, dhue, dsat, dexp):
    """Apply an HSV distortion (python/cv2 path; the native kernel fuses
    the same transform per pixel)."""
    import cv2
    hsv = cv2.cvtColor(image_u8, cv2.COLOR_RGB2HSV).astype(np.float32)
    hsv[..., 0] = (hsv[..., 0] + dhue * 180.0) % 180.0
    hsv[..., 1] = np.clip(hsv[..., 1] * dsat, 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * dexp, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def distort_hsv(image_u8, rng, hue=0.1, sat=1.5, exposure=1.5):
    """Random HSV distortion (sample + apply)."""
    return apply_hsv(image_u8, *sample_hsv(rng, hue, sat, exposure))


def sample_crop(rng, h, w, jitter=0.3):
    """Sample a jittered crop window (data.c:957-1010 semantics: each edge
    moves by up to +-jitter of the image size; the window may extend outside
    the image, padded gray). Returns dict(crop_x0, crop_y0, crop_w, crop_h).
    """
    dw, dh = int(w * jitter), int(h * jitter)
    left = int(rng.integers(-dw, dw + 1))
    right = int(rng.integers(-dw, dw + 1))
    top = int(rng.integers(-dh, dh + 1))
    bottom = int(rng.integers(-dh, dh + 1))
    return {"crop_x0": left, "crop_y0": top,
            "crop_w": max(w - right - left, 1),
            "crop_h": max(h - bottom - top, 1)}


def crop_boxes(boxes, crop, h, w):
    """Remap normalized (N,5) boxes into the crop window; drop degenerates."""
    if len(boxes) == 0:
        return boxes.reshape(0, 5).astype(np.float32)
    x0, y0 = crop["crop_x0"], crop["crop_y0"]
    cw, ch = crop["crop_w"], crop["crop_h"]
    b = boxes.copy()
    bx0 = np.clip((b[:, 0] - b[:, 2] / 2) * w - x0, 0, cw)
    bx1 = np.clip((b[:, 0] + b[:, 2] / 2) * w - x0, 0, cw)
    by0 = np.clip((b[:, 1] - b[:, 3] / 2) * h - y0, 0, ch)
    by1 = np.clip((b[:, 1] + b[:, 3] / 2) * h - y0, 0, ch)
    keep = (bx1 - bx0 > 1) & (by1 - by0 > 1)
    nb = np.stack([(bx0 + bx1) / 2 / cw, (by0 + by1) / 2 / ch,
                   (bx1 - bx0) / cw, (by1 - by0) / ch, b[:, 4]], axis=1)
    return nb[keep].astype(np.float32)


def apply_crop_pixels(image_u8, crop, out_size):
    """Python/cv2 pixel path for a sampled crop: pad-crop + stretch resize.
    (The native kernel yolodata.cpp fuses this with HSV/flip.)"""
    import cv2
    h, w = image_u8.shape[:2]
    x0, y0 = crop["crop_x0"], crop["crop_y0"]
    cw, ch = crop["crop_w"], crop["crop_h"]
    canvas = np.full((ch, cw, 3), 128, np.uint8)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x0 + cw, w), min(y0 + ch, h)
    if sx1 > sx0 and sy1 > sy0:
        canvas[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = \
            image_u8[sy0:sy1, sx0:sx1]
    return cv2.resize(canvas, (out_size, out_size),
                      interpolation=cv2.INTER_LINEAR)


def random_crop_place(image_u8, boxes, rng, out_size, jitter=0.3):
    """Jittered crop + resize to out_size; boxes remapped and clipped."""
    h, w = image_u8.shape[:2]
    crop = sample_crop(rng, h, w, jitter)
    return (apply_crop_pixels(image_u8, crop, out_size),
            crop_boxes(boxes, crop, h, w))


def random_flip(image_u8, boxes, rng):
    """Horizontal flip with probability 0.5 (data.c flip)."""
    if rng.random() < 0.5:
        image_u8 = image_u8[:, ::-1].copy()
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, 0] = 1.0 - boxes[:, 0]
    return image_u8, boxes


def augment_detection(image_u8, boxes, rng, out_size, *, jitter=0.3,
                      hue=0.1, sat=1.5, exposure=1.5, flip=True):
    """Full darknet-style train-time augmentation chain."""
    img, b = random_crop_place(image_u8, boxes, rng, out_size, jitter)
    img = distort_hsv(img, rng, hue, sat, exposure)
    if flip:
        img, b = random_flip(img, b, rng)
    return img, b


def letterbox(image_u8, out_size, pad_value=128):
    """Aspect-preserving resize + pad (src/image.c:960 letterbox_image).
    Returns (image, scale, pad_x, pad_y) for box un-mapping
    (correct_yolo_boxes, src/yolo_layer.c:247)."""
    import cv2
    h, w = image_u8.shape[:2]
    scale = min(out_size / w, out_size / h)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    resized = cv2.resize(image_u8, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = np.full((out_size, out_size, 3), pad_value, np.uint8)
    px, py = (out_size - nw) // 2, (out_size - nh) // 2
    out[py:py + nh, px:px + nw] = resized
    return out, scale, px, py


def unletterbox_boxes(boxes_xyxy_norm, orig_w, orig_h, out_size, scale,
                      px, py):
    """Map normalized network-space boxes back to original pixels after
    letterboxing (correct_yolo_boxes equivalent)."""
    b = np.asarray(boxes_xyxy_norm, np.float32) * out_size
    b[:, [0, 2]] = (b[:, [0, 2]] - px) / scale
    b[:, [1, 3]] = (b[:, [1, 3]] - py) / scale
    b[:, [0, 2]] = np.clip(b[:, [0, 2]], 0, orig_w)
    b[:, [1, 3]] = np.clip(b[:, [1, 3]], 0, orig_h)
    return b


def pad_truths(boxes, max_boxes):
    """(N,5) -> (max_boxes,5) with zero padding (darknet's fixed-size truth
    buffer, w==0 marks padding)."""
    out = np.zeros((max_boxes, 5), np.float32)
    n = min(len(boxes), max_boxes)
    if n:
        out[:n] = boxes[:n]
    return out
