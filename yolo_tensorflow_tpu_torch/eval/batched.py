"""Batched, prefetching detection over an image list: the evaluation path.

Counterpart of yolo_tensorflow_tpu/eval/batched.py. The reference's
validate_detector pipelines buffered images through loader threads while
the GPU runs the current batch (examples/detector.c:388-430). Here:

  - a thread pool decodes and preprocesses images with a bounded lookahead
    of ``prefetch_batches`` batches,
  - the card runs full ``Detector.detect_batch`` (or
    ``detect_batch_fused``) batches, the tail padded to ``batch_size``,
  - each batch's Detections are packed into one float32 tensor on the card
    (``post.nms.pack_detections``) and read back in one copy, up to
    ``INFLIGHT`` batches behind the dispatch: PyTorch queues the card's work
    without waiting, so the host prepares later batches meanwhile.

The three preprocessing branches of the Detector: stretch (cv2.resize on
the host), the host letterbox (``data.augment.letterbox``, cv2) and the
fused letterbox (raw pixels into one canvas a batch, its side the
``pipeline.canvas_side`` bucket of the batch's largest image). Box
un-scaling is ``Detector.detect``'s, so batched results equal the serial
path's. ``read_fn`` (path -> RGB uint8 (H, W, 3)) replaces ``read_rgb``,
which needs cv2: on a host without cv2, images get in through it, and the
fused Detector preprocesses them on the card.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

# device batches queued before the oldest one's Detections are fetched
INFLIGHT = 3


def read_rgb(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8, or raise FileNotFoundError: the
    one reader of every evaluation and serving path (needs cv2)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def detect_images(det, images: Sequence[np.ndarray], *, batch_size: int = 32,
                  num_workers: int = 8, prefetch_batches: int = 3,
                  progress=None):
    """Batched detection over in-memory HWC uint8 RGB images: a list (one
    per image) of ``Detector.detect``-style lists of dicts, boxes in each
    image's pixels, equal to the serial ``det.detect``'s."""
    return _detect(det, list(images), None, batch_size=batch_size,
                   num_workers=num_workers,
                   prefetch_batches=prefetch_batches, progress=progress)


def detect_paths(det, paths: Sequence[str], *, batch_size: int = 32,
                 num_workers: int = 8, prefetch_batches: int = 3,
                 read_fn=read_rgb, progress=None):
    """Batched detection over image files, decoded by ``read_fn`` on the
    worker pool. Returns (results_per_image, sizes), sizes a list of (h, w)
    so that callers (mAP evaluation) scale the ground truth without reading
    the images again."""
    return _detect(det, None, list(paths), batch_size=batch_size,
                   num_workers=num_workers,
                   prefetch_batches=prefetch_batches, read_fn=read_fn,
                   progress=progress, return_sizes=True)


def _detect(det, images, paths, *, batch_size, num_workers,
            prefetch_batches, read_fn=read_rgb, progress=None,
            return_sizes=False):
    from yolo_tensorflow_tpu_torch.data.augment import (letterbox,
                                                        unletterbox_boxes)
    from yolo_tensorflow_tpu_torch.pipeline import canvas_side
    from yolo_tensorflow_tpu_torch.post.nms import (pack_detections,
                                                    unpack_detections)

    S = det.cfg.input_size
    fused = det.fused
    use_letterbox = det.letterbox
    n = len(images) if images is not None else len(paths)
    if n == 0:
        return ([], []) if return_sizes else []

    def prep(i):
        """Decode and per-image preprocessing (a worker thread)."""
        img = images[i] if images is not None else read_fn(paths[i])
        h, w = img.shape[:2]
        if fused:
            # raw pixels: the canvas is assembled per batch, so that the
            # whole batch shares one side
            return img, ("fused", h, w)
        if use_letterbox:
            resized, scale, px, py = letterbox(img, S)
            return resized, ("letterbox", h, w, scale, px, py)
        import cv2
        resized = cv2.resize(img, (S, S), interpolation=cv2.INTER_LINEAR)
        return resized, ("stretch", h, w)

    def assemble(items):
        """prep() outputs -> the batch's uint8 arrays, padded to batch_size
        (the tail too), and their metas."""
        metas = [m for _, m in items]
        if fused:
            side = max(canvas_side(m[1], m[2], S) for m in metas)
            canvas = np.zeros((batch_size, side, side, 3), np.uint8)
            sizes = np.ones((batch_size, 2), np.int32)
            for b, (img, m) in enumerate(items):
                canvas[b, :m[1], :m[2]] = img
                sizes[b] = (m[1], m[2])
            return (canvas, sizes), metas
        batch = np.zeros((batch_size, S, S, 3), np.uint8)
        for b, (img, _) in enumerate(items):
            batch[b] = img
        return (batch,), metas

    def finalize(packed, metas):
        """One batch's packed Detections, read back in one copy -> per-image
        lists of dicts, un-scaled as Detector.detect does."""
        d = unpack_detections(packed.cpu().numpy())
        out = []
        for b, m in enumerate(metas):
            nb = int(d.num[b])
            boxes = d.boxes[b, :nb]
            if m[0] == "fused":
                boxes_px = boxes
            elif m[0] == "letterbox":
                _, h, w, scale, px, py = m
                boxes_px = (unletterbox_boxes(boxes, w, h, S, scale, px, py)
                            if nb else boxes)
            else:
                _, h, w = m
                boxes_px = boxes * np.asarray([w, h, w, h], np.float32)
            out.append([{
                "class_id": int(d.classes[b, i]),
                "class": det.cfg.classes[int(d.classes[b, i])],
                "score": float(d.scores[b, i]),
                "box": tuple(float(v) for v in boxes_px[i]),
            } for i in range(nb)])
        return out

    results: List[list] = []
    sizes_out: List[tuple] = []
    done = 0
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        window = batch_size * max(prefetch_batches, 1)
        futs: deque = deque()
        next_i = 0

        def fill():
            nonlocal next_i
            while next_i < n and len(futs) < window:
                futs.append(ex.submit(prep, next_i))
                next_i += 1

        pending: deque = deque()   # (packed Detections on the card, metas)

        def drain_one():
            nonlocal done
            packed, metas = pending.popleft()
            results.extend(finalize(packed, metas))
            done += len(metas)
            if progress:
                progress(done, n)

        fill()
        while futs:
            items = []
            while futs and len(items) < batch_size:
                items.append(futs.popleft().result())
                fill()
            arrays, metas = assemble(items)
            with torch.inference_mode():
                dets = (det.detect_batch_fused(*arrays) if fused
                        else det.detect_batch(*arrays))
                pending.append((pack_detections(dets), metas))
            sizes_out.extend((m[1], m[2]) for m in metas)
            if len(pending) > INFLIGHT:
                drain_one()
        while pending:
            drain_one()
    if return_sizes:
        return results, sizes_out
    return results


def evaluate_samples(det, samples, *, batch_size: int = 32,
                     num_workers: int = 8, limit: int = 0, read_fn=read_rgb,
                     progress=None):
    """Batched detection over dataset samples (data.datasets.Sample: the
    image path and normalized xywh + class ground-truth boxes), images read
    by ``read_fn``. Returns (dets, gts, results_per_image, sizes) in
    eval.map.evaluate_detections' input format."""
    if limit:
        samples = samples[:limit]
    results, sizes = detect_paths(det, [s.image_path for s in samples],
                                  batch_size=batch_size,
                                  num_workers=num_workers, read_fn=read_fn,
                                  progress=progress)
    dets, gts = [], []
    for res, (h, w), s in zip(results, sizes, samples):
        dets.append({
            "boxes": np.asarray([r["box"] for r in res],
                                np.float32).reshape(-1, 4),
            "scores": np.asarray([r["score"] for r in res], np.float32),
            "classes": np.asarray([r["class_id"] for r in res], np.int32),
        })
        gb = s.boxes
        gts.append({
            "boxes": np.stack([(gb[:, 0] - gb[:, 2] / 2) * w,
                               (gb[:, 1] - gb[:, 3] / 2) * h,
                               (gb[:, 0] + gb[:, 2] / 2) * w,
                               (gb[:, 1] + gb[:, 3] / 2) * h], 1)
            if len(gb) else np.zeros((0, 4), np.float32),
            "classes": gb[:, 4].astype(np.int32) if len(gb)
            else np.zeros((0,), np.int32),
        })
    return dets, gts, results, sizes
