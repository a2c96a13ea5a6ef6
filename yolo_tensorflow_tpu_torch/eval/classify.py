"""Classifier validation: top-1 / top-k accuracy over a path list.

Counterpart of yolo_tensorflow_tpu/eval/classify.py, the
validate_classifier_* flows of examples/classifier.c: the ground-truth class
from a substring match of the label names on the image path, the mode's
preprocessing (on the device, ``pipeline.Classifier``), predict, top_k,
running top-1 / top-k accuracy. Images are decoded on a worker pool while
the card classifies the previous chunk. ``read_fn`` (path -> RGB uint8 (H,
W, 3)) replaces ``eval.batched.read_rgb``, which needs cv2.

The C's top_k (src/utils.c) picks the k largest probs, the first index
winning ties: a stable argsort of the negated probs.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from yolo_tensorflow_tpu_torch.eval.batched import read_rgb


def read_validation_list(list_file: str,
                         class_names: Sequence[str]) -> list:
    """(path, class_id) pairs with the C's label rule for validation lists
    (examples/classifier.c:340-346): the first class name that is a
    substring of the path, -1 where none is (the image then counts as a
    miss)."""
    out = []
    with open(list_file) as f:
        for line in f:
            path = line.strip()
            if not path:
                continue
            cls = -1
            for j, name in enumerate(class_names):
                if name in path:
                    cls = j
                    break
            out.append((path, cls))
    return out


def topk_indices(probs: np.ndarray, k: int) -> np.ndarray:
    """(B, C) probs -> (B, k) class ids, ties to the lowest index (top_k,
    src/utils.c)."""
    return np.argsort(-probs, axis=1, kind="stable")[:, :k]


# scales of validate_classifier_multi (examples/classifier.c:437)
MULTI_SCALES = (224, 256, 288, 320)


def snap_shape_32(oh: int, ow: int, lo: int = 32,
                  hi: int = 2048) -> Tuple[int, int]:
    """A fully convolutional resize target snapped to the stride-32 grid
    (clamped to [lo, hi]): with ``shape_buckets="snap32"`` the full and
    multi modes run O(buckets) distinct shapes instead of one per aspect
    ratio, each side at most 16 pixels off the C's exact geometry."""
    def snap(v):
        return min(max(lo, int(round(v / 32.0)) * 32), hi)
    return snap(oh), snap(ow)


def _to_numpy(probs) -> np.ndarray:
    return probs.float().cpu().numpy()


def _chunk_probs(clf, imgs, mode: str,
                 shape_buckets: Optional[str] = None) -> np.ndarray:
    """(B, classes) probs of one decoded chunk under an evaluation mode:
      single - center_crop_image, validate_classifier_single (:361)
      crop   - the stretch of load_data_old, validate_classifier_crop (:170)
      10crop - ten summed crops of the (S + 32) stretch,
               validate_classifier_10 (:234)
      full   - resize_min and a fully convolutional forward at that shape,
               validate_classifier_full (:303), one sub-batch per shape
      multi  - resize_max at MULTI_SCALES and the mirror, probs summed over
               the 8 views, validate_classifier_multi (:419)
    ``shape_buckets`` (full and multi): None is the C's exact geometry,
    "snap32" ``snap_shape_32``."""
    if mode == "single":
        return _to_numpy(clf.classify_batch_center_crop(imgs))
    if mode == "crop":
        return _to_numpy(clf.classify_batch_resize(imgs))
    if mode == "10crop":
        return _to_numpy(clf.classify_batch_10crop(imgs))
    if mode not in ("full", "multi"):
        raise ValueError(f"unknown classifier eval mode {mode!r}")
    if shape_buckets not in (None, "snap32"):
        raise ValueError(f"unknown shape_buckets {shape_buckets!r}")
    out = np.zeros((len(imgs), len(clf.cfg.classes)), np.float32)
    scales = MULTI_SCALES if mode == "multi" else (clf.cfg.input_size,)
    shape_of = (clf._resize_max_shape if mode == "multi"
                else clf._resize_min_shape)
    for scale in scales:
        groups: dict = {}
        for i, im in enumerate(imgs):
            hw = shape_of(im.shape[0], im.shape[1], scale)
            if shape_buckets == "snap32":
                hw = snap_shape_32(*hw)
            groups.setdefault(hw, []).append(i)
        for out_hw, idxs in groups.items():
            probs = clf.classify_group_fullconv([imgs[i] for i in idxs],
                                                out_hw,
                                                flip=(mode == "multi"))
            out[np.asarray(idxs)] += _to_numpy(probs)
    return out


def validate_classifier(clf, samples: Sequence[Tuple[str, int]], *,
                        top_k: int = 5, batch_size: int = 32,
                        num_workers: int = 4, mode: str = "single",
                        shape_buckets: Optional[str] = None,
                        read_fn=read_rgb,
                        progress: Optional[Callable] = None) -> dict:
    """samples: (image_path, class_id) pairs. Returns the running
    accuracies as the C accumulates them: top1 = mean(argmax == class),
    top{k} = mean(class in top k); a class_id < 0 counts as a miss.
    ``mode`` picks the validate_classifier_* flow (``_chunk_probs``); the
    next chunk is decoded by ``read_fn`` on the worker pool while the card
    classifies this one."""
    chunks = [samples[s:s + batch_size]
              for s in range(0, len(samples), batch_size)]
    n = t1 = tk = 0
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        def decode(chunk):
            return list(pool.map(read_fn, [p for p, _ in chunk]))

        imgs = decode(chunks[0]) if chunks else None
        for ci, chunk in enumerate(chunks):
            probs = _chunk_probs(clf, imgs, mode, shape_buckets)
            imgs = decode(chunks[ci + 1]) if ci + 1 < len(chunks) else None
            idx = topk_indices(probs, top_k)
            for (_, cls), row in zip(chunk, idx):
                t1 += int(row[0] == cls)
                tk += int((row == cls).any())
                n += 1
            if progress is not None:
                progress(n, len(samples))
    return {"top1": t1 / max(n, 1), f"top{top_k}": tk / max(n, 1),
            "images": n, "mode": mode}
