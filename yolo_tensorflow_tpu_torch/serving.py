"""Streaming/batched serving driver, the src/demo.c:185 equivalent.

Counterpart of yolo_tensorflow_tpu/serving.py. Darknet's demo runs a
2-thread fetch/detect pipeline (pthread_create at demo.c:252-253) with a
rolling FPS print. Here: a host prefetch thread reads and resizes frames
into fixed batches while the card runs the previous batch (the same
overlap, plus batching: darknet is batch-1). Sources: a video file or
camera index (cv2.VideoCapture), or a directory of images looped ``loops``
times, read by ``read_fn`` (default: cv2.imread, BGR to RGB).

The card's machine has no cv2: a directory source with a ``read_fn`` of its
own (``np.load`` of .npy frames, say) whose frames are already at the
model's input size needs none, since a frame of that size is not resized
(cv2.resize to the same size returns its input bit for bit, so the TPU
package's results do not change).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from yolo_tensorflow_tpu_torch.post import nms as NMS

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not "
                          "installed; a directory source with read_fn= and "
                          "frames at the input size does not") from e
    return cv2


def read_bgr_as_rgb(path: str) -> Optional[np.ndarray]:
    """The default frame reader: cv2.imread, BGR to RGB; None where cv2
    cannot decode the file."""
    cv2 = _cv2("reading image files")
    img = cv2.imread(path)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _sized(rgb: np.ndarray, size: int) -> np.ndarray:
    if rgb.shape[:2] == (size, size):
        return rgb
    return _cv2("resizing a frame").resize(rgb, (size, size))


def _capture(source, size: int) -> Iterator[np.ndarray]:
    cv2 = _cv2("a video or camera source")
    cap = cv2.VideoCapture(int(source) if str(source).isdigit() else source)
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield cv2.cvtColor(cv2.resize(frame, (size, size)),
                               cv2.COLOR_BGR2RGB)
    finally:
        cap.release()  # free the camera even on generator close


def frame_source(source, size: int, loops: int = 1,
                 read_fn: Optional[Callable] = None) -> Iterator[np.ndarray]:
    """Yield (size, size, 3) uint8 RGB frames from a video path, camera
    index, or image directory. A directory's files are read in sorted
    order by ``read_fn(path) -> RGB uint8 or None`` (None skips the file);
    with the default reader only image files (IMAGE_EXTS) are read."""
    if isinstance(source, int) or (isinstance(source, str)
                                   and source.isdigit()):
        yield from _capture(source, size)
    elif os.path.isdir(source):
        paths = sorted(glob.glob(os.path.join(source, "*")))
        if read_fn is None:
            read_fn = read_bgr_as_rgb
            paths = [p for p in paths if p.lower().endswith(IMAGE_EXTS)]
        paths = [p for p in paths if os.path.isfile(p)]
        for _ in range(loops):
            for p in paths:
                img = read_fn(p)
                if img is not None:
                    yield _sized(img, size)
    else:
        yield from _capture(source, size)


def stream_detect(detector, source, *, batch_size: int = 8, loops: int = 1,
                  prefetch: int = 3, on_batch=None, max_batches: int = 0,
                  avg_frames: int = 0, read_fn: Optional[Callable] = None):
    """Run the fetch/detect pipeline. ``on_batch(dets, images)`` is called
    per batch with numpy Detections (one device-to-host copy,
    post/nms.fetch_detections) and the batch's valid frames; returns
    (frames, wall_seconds, fps).

    ``avg_frames`` >= 2 enables demo.c's rolling prediction average
    (src/demo.c:31,67-78, demo_frame=3) through
    ``Detector.detect_batch_smoothed``: each frame is decoded from the mean
    of the last N activated head outputs, the tail state carried on the
    card across batches. The last batch is padded with zero frames to
    ``batch_size``; its padding is neither counted nor handed on."""
    size = detector.cfg.input_size
    # Queue(maxsize<=0) would be UNBOUNDED: a fetcher outrunning the
    # detector would buffer the whole video; prefetch floors at 1
    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    SENTINEL = None
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that aborts when the consumer stopped early, so the
        fetcher (and its video capture) never blocks forever."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def fetcher():
        try:
            batch = []
            for frame in frame_source(source, size, loops, read_fn):
                if stop.is_set():
                    return
                batch.append(frame)
                if len(batch) == batch_size:
                    if not put(np.stack(batch)):
                        return
                    batch = []
            if batch:  # pad the tail to the batch size
                pad = np.zeros((batch_size - len(batch), size, size, 3),
                               np.uint8)
                put((np.concatenate([np.stack(batch), pad]), len(batch)))
        finally:
            # always unblock the consumer, even if the source raised
            stop.is_set() or put(SENTINEL)

    t = threading.Thread(target=fetcher, daemon=True)
    t.start()

    frames = 0
    batches = 0
    smooth_state = None
    t0 = time.perf_counter()
    try:
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            if isinstance(item, tuple):
                images, valid = item
            else:
                images, valid = item, item.shape[0]
            if avg_frames and avg_frames > 1:
                dets, smooth_state = detector.detect_batch_smoothed(
                    images, smooth_state, avg_frames=avg_frames)
            else:
                dets = detector.detect_batch(images)
            # one device-to-host copy a batch, which also makes the FPS
            # honest (the card has finished the batch)
            host = NMS.fetch_detections(dets)
            if on_batch is not None:
                on_batch(host, images[:valid])
            frames += valid
            batches += 1
            if max_batches and batches >= max_batches:
                break
    finally:
        # release the fetcher (and its capture source) on ANY exit: early
        # stop, source end, or a detect/on_batch exception; without this a
        # raising consumer leaks the thread and holds the camera open for
        # the life of the process
        stop.set()
    dt = time.perf_counter() - t0
    t.join(timeout=2.0)
    fps = frames / dt if dt > 0 else 0.0
    return frames, dt, fps
