"""Threaded, prefetching detection data loader: the port's copy of
yolo_tensorflow_tpu/data/loader.py, batch for batch the same.

Replaces darknet's 64-pthread producer/consumer (src/data.c:1062
load_threads + the buffer-swap convention in examples/detector.c:83-86)
with a worker pool + bounded queue. Decode/augment runs on host threads
(cv2 releases the GIL for the heavy ops; the native C++ kernel in
native/yolodata.cpp, built at first use, takes over crop/resize/HSV) while
the device step consumes the previous batch — the same overlap darknet gets, without the
raw-pointer buffer swap races.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from yolo_tensorflow_tpu_torch.data import augment as A
from yolo_tensorflow_tpu_torch.data.datasets import Sample


def _read_image_rgb(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class DetectionLoader:
    """Iterable over (images (B,S,S,3) uint8, truths (B,T,5) f32) batches.

    size is mutable between epochs/batches (set_size) to support darknet's
    multi-scale training (random 320..608 resize every 10 batches,
    examples/detector.c:63-82).
    """

    def __init__(self, samples: Sequence[Sample], batch_size: int, size: int,
                 *, train: bool = True, max_boxes: int = 30,
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0,
                 jitter: float = 0.3, hue: float = 0.1, sat: float = 1.5,
                 exposure: float = 1.5,
                 read_fn: Callable[[str], np.ndarray] = _read_image_rgb,
                 cache_images: bool = False,
                 cache_bytes: int = 4 << 30):
        self.samples = list(samples)
        self.batch_size = batch_size
        self._size = size
        self.train = train
        self.max_boxes = max_boxes
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.aug = dict(jitter=jitter, hue=hue, sat=sat, exposure=exposure)
        self.read_fn = read_fn
        self._epoch = 0
        # opt-in decoded-pixel cache: darknet re-decodes every image every
        # epoch (load_data_detection -> load_image, src/data.c:957); next
        # to a TPU the host cores are the scarce resource, so for datasets
        # that fit in RAM we keep decoded uint8 frames (read-only — the
        # augmenters write into fresh canvases, never the source) and pay
        # the codec once. Bounded by cache_bytes; past the budget reads
        # fall through to the codec.
        self._cache = {} if cache_images else None
        self._cache_budget = cache_bytes
        self._cache_used = 0
        self._cache_lock = threading.Lock()

    def set_size(self, size: int):
        self._size = size

    def _read(self, path: str) -> np.ndarray:
        if self._cache is None:
            return self.read_fn(path)
        img = self._cache.get(path)
        if img is None:
            img = self.read_fn(path)
            img.setflags(write=False)
            with self._cache_lock:
                if (path not in self._cache
                        and self._cache_used + img.nbytes
                        <= self._cache_budget):
                    self._cache[path] = img
                    self._cache_used += img.nbytes
        return img

    def _use_native(self) -> bool:
        """Training pixels go through the native kernel when
        YOLO_NATIVE_LOADER=1, through cv2 when it is set to anything else,
        and, unset, through the native kernel on hosts with more than two
        cores. The port builds the kernel from the repository's source at
        first use (``data/native.py``), so where the JAX package asks
        whether its prebuilt library loads, a failed build raises here."""
        if not self.train:
            return False
        import os
        forced = os.environ.get("YOLO_NATIVE_LOADER")
        if forced is not None:
            return forced == "1"
        return (os.cpu_count() or 1) > 2

    def _load_batch(self, idx, size: int, rng):
        """Assemble one batch: geometry + boxes in python, pixels via the
        native kernel when it pays (multi-core hosts) else cv2."""
        imgs_out = np.empty((len(idx), size, size, 3), np.uint8)
        truths = np.empty((len(idx), self.max_boxes, 5), np.float32)
        raws, params = [], []
        for k, si in enumerate(idx):
            sample = self.samples[si]
            img = self._read(sample.image_path)
            boxes = sample.boxes
            if self.train:
                h, w = img.shape[:2]
                crop = A.sample_crop(rng, h, w, self.aug["jitter"])
                dhue, dsat, dexp = A.sample_hsv(
                    rng, self.aug["hue"], self.aug["sat"], self.aug["exposure"])
                flip = bool(rng.random() < 0.5)
                boxes = A.crop_boxes(boxes, crop, h, w)
                if flip and len(boxes):
                    boxes = boxes.copy()
                    boxes[:, 0] = 1.0 - boxes[:, 0]
                raws.append(img)
                params.append(dict(crop, dhue=dhue, dsat=dsat, dexp=dexp,
                                   flip=int(flip)))
            else:
                import cv2
                imgs_out[k] = cv2.resize(img, (size, size),
                                         interpolation=cv2.INTER_LINEAR)
            truths[k] = A.pad_truths(boxes, self.max_boxes)
        if self.train:
            if self._use_native():
                from yolo_tensorflow_tpu_torch.data import native
                imgs_out = native.process_batch(raws, params, size)
            else:
                for k, (img, p) in enumerate(zip(raws, params)):
                    out = A.apply_crop_pixels(img, p, size)
                    out = A.apply_hsv(out, p["dhue"], p["dsat"], p["dexp"])
                    if p["flip"]:
                        out = out[:, ::-1]
                    imgs_out[k] = out
        return imgs_out, truths

    def epoch(self, shuffle: Optional[bool] = None):
        """Generator over one epoch of batches with background prefetch."""
        shuffle = self.train if shuffle is None else shuffle
        order = np.arange(len(self.samples))
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        if shuffle:
            rng.shuffle(order)
        n_batches = len(order) // self.batch_size
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        work_q: "queue.Queue" = queue.Queue()
        for bi in range(n_batches):
            work_q.put(bi)
        stop = threading.Event()
        results = {}
        cond = threading.Condition()
        next_emit = [0]
        errors = []
        # workers may run at most this far ahead of the consumer — bounds
        # memory without ever blocking a worker on out_q (a blocked worker
        # can't observe stop, and under backpressure every worker would
        # serialize behind the slot — the old head-of-line design)
        window = self.prefetch + self.num_workers

        epoch_id = self._epoch

        def worker(wid):
            try:
                while not stop.is_set():
                    try:
                        bi = work_q.get_nowait()
                    except queue.Empty:
                        return
                    with cond:
                        while (bi >= next_emit[0] + window
                               and not stop.is_set()):
                            cond.wait(timeout=0.1)
                    if stop.is_set():
                        return
                    size = self._size  # snapshot (multi-scale changes it)
                    idx = order[bi * self.batch_size:
                                (bi + 1) * self.batch_size]
                    # per-BATCH rng: augmentation is a pure function of
                    # (seed, epoch, batch index), independent of which worker
                    # runs it or how many there are
                    brng = np.random.default_rng((self.seed, epoch_id, bi))
                    imgs, tr = self._load_batch(idx, size, brng)
                    with cond:
                        results[bi] = (imgs, tr)
                        cond.notify_all()
            except Exception as e:  # surface in the consumer, don't hang it
                with cond:
                    errors.append(e)
                    stop.set()
                    cond.notify_all()

        def emitter():
            """Single thread owns the ordered handoff to out_q; its blocking
            put is outside any lock and re-checks stop every 100 ms."""
            while next_emit[0] < n_batches and not stop.is_set():
                with cond:
                    while (next_emit[0] not in results
                           and not stop.is_set()):
                        cond.wait(timeout=0.1)
                    if stop.is_set():
                        return
                    item = results.pop(next_emit[0])
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                with cond:
                    next_emit[0] += 1
                    cond.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        threads.append(threading.Thread(target=emitter, daemon=True))
        for t in threads:
            t.start()
        try:
            for _ in range(n_batches):
                while True:
                    try:
                        item = out_q.get(timeout=0.5)
                        break
                    except queue.Empty:
                        if errors:
                            raise errors[0]
                yield item
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            for t in threads:
                t.join(timeout=1.0)

    def __len__(self):
        return len(self.samples) // self.batch_size
