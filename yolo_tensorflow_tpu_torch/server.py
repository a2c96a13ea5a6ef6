"""HTTP detection server with dynamic micro-batching.

Counterpart of yolo_tensorflow_tpu/server.py, on the port's fused
letterbox Detector:

* **Fixed batch, dynamic load**: concurrent requests are coalesced by a
  batcher thread. The first request opens a window of ``max_wait_ms``; the
  batch ships when it fills or the window closes, padded to ``batch_size``
  (a fixed shape per canvas bucket, as the TPU package compiles once per
  pair; the pad rows cost little at small batch, one launch per request
  far more).
* **Any input size**: images ride the fused-letterbox path
  (``Detector.detect_batch_fused``): each image is copied into a shared
  256-px-bucketed canvas, and resize, normalize, backbone, decode (the
  decode kernel), NMS (the NMS kernel) and box un-mapping all run on the
  card; boxes come back in original pixel coordinates. Oversized images
  are host-downscaled to the ``max_canvas`` bucket first (per-axis ratios
  un-map the boxes: the int() floor makes x and y ratios differ).
* **Single-transfer readback** per batch (post/nms.fetch_detections): one
  device-to-host copy a batch, not five per image.

Endpoints:
  POST /detect      image bytes -> {"detections": [...]}; the bytes are
                    decoded by ``decode_fn`` (default: cv2.imdecode of
                    jpeg/png/bmp, BGR to RGB)
  GET  /healthz     liveness + model info
  GET  /stats       request/batch counters, occupancy, latency quantiles

Run: ``python -m yolo_tensorflow_tpu_torch serve-http --model yolov3
--weights yolov3.weights --port 8000 --batch 8 --bf16``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

import numpy as np

from yolo_tensorflow_tpu_torch.pipeline import canvas_side
from yolo_tensorflow_tpu_torch.post import nms as NMS


class Overloaded(RuntimeError):
    """The request queue is full: the server is taking work faster than
    the device drains it. Raised immediately (fail-fast load shedding —
    blocking the client until the 30 s timeout would just stack up more
    work behind a device that is already behind); the HTTP layer maps it
    to 503 + Retry-After."""


class _Pending:
    """One in-flight request: the decoded image in, results out."""

    __slots__ = ("image", "event", "results", "error", "t_enqueue",
                 "occupancy")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.results: Optional[list] = None
        self.error: Optional[str] = None
        self.t_enqueue = time.perf_counter()
        self.occupancy = 0


class BatchingDetector:
    """Coalesces concurrent detect() calls into fixed-shape device batches.

    Thread-safe; one batcher thread owns the device. ``detector`` must be
    a fused-letterbox Detector (``Detector(..., letterbox=True,
    fused=True)``) so that one batch shape per canvas bucket serves every
    image size."""

    def __init__(self, detector, *, batch_size: int = 8,
                 max_wait_ms: float = 5.0, max_canvas: int = 1024,
                 queue_depth: int = 64):
        if not getattr(detector, "fused", False):
            raise ValueError("BatchingDetector needs a fused-letterbox "
                             "Detector (letterbox=True, fused=True)")
        self.det = detector
        self.batch_size = int(batch_size)
        self.max_wait = max_wait_ms / 1e3
        self.max_canvas = int(max_canvas)
        self.queue_depth = int(queue_depth)
        self._q: "queue.Queue[_Pending]" = queue.Queue(
            maxsize=self.queue_depth)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "images": 0,
                      "errors": 0, "rejected": 0}
        self._lat_ring: List[float] = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------------
    def detect(self, image: np.ndarray, timeout: float = 30.0) -> list:
        """Blocking single-image detect through the shared batcher.

        Raises :class:`Overloaded` immediately when ``queue_depth``
        requests are already waiting (``timeout`` bounds only the wait
        for an *accepted* request's batch to complete)."""
        p = _Pending(image)
        try:
            self._q.put_nowait(p)
        except queue.Full:
            with self._lock:
                self.stats["rejected"] += 1
            raise Overloaded(
                f"request queue full ({self.queue_depth} deep); retry "
                "later") from None
        if not p.event.wait(timeout):
            raise TimeoutError("detection batch did not complete in time")
        if p.error is not None:
            raise RuntimeError(p.error)
        return p.results

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    # -- batcher -------------------------------------------------------------
    def _collect(self) -> List[_Pending]:
        """Block for the first request, then drain until the batch fills
        or the wait window closes — the dynamic part of the batching."""
        try:
            first = self._q.get(timeout=0.2)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _prescale(self, img: np.ndarray):
        """Host-downscale images whose canvas bucket would exceed
        max_canvas. Returns (image, (sx, sy)) where boxes multiply by
        (sx, sy) to return to true original pixels — per-axis ratios,
        since int() flooring makes them differ."""
        h, w = img.shape[:2]
        if max(h, w, self.det.cfg.input_size) <= self.max_canvas:
            return img, (1.0, 1.0)
        import cv2
        k = self.max_canvas / max(h, w)
        rw, rh = max(int(w * k), 1), max(int(h * k), 1)
        small = cv2.resize(img, (rw, rh), interpolation=cv2.INTER_AREA)
        return small, (w / rw, h / rh)

    def _loop(self):
        cfg = self.det.cfg
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                imgs, rescales = [], []
                for p in batch:
                    im, rs = self._prescale(p.image)
                    imgs.append(im)
                    rescales.append(rs)
                side = canvas_side(*(max(i.shape[:2]) for i in imgs),
                                   cfg.input_size)
                canvas = np.zeros((self.batch_size, side, side, 3),
                                  np.uint8)
                sizes = np.full((self.batch_size, 2), side, np.int32)
                for i, im in enumerate(imgs):
                    h, w = im.shape[:2]
                    canvas[i, :h, :w] = im
                    sizes[i] = (h, w)
                dets = NMS.fetch_detections(
                    self.det.detect_batch_fused(canvas, sizes))
                now = time.perf_counter()
                for i, p in enumerate(batch):
                    sx, sy = rescales[i]
                    n = int(dets.num[i])
                    p.results = [{
                        "class_id": int(dets.classes[i, j]),
                        "class": cfg.classes[int(dets.classes[i, j])],
                        "score": float(dets.scores[i, j]),
                        "box": (float(dets.boxes[i, j, 0]) * sx,
                                float(dets.boxes[i, j, 1]) * sy,
                                float(dets.boxes[i, j, 2]) * sx,
                                float(dets.boxes[i, j, 3]) * sy),
                    } for j in range(n)]
                    p.occupancy = len(batch)
                    self._record_latency(now - p.t_enqueue)
                with self._lock:
                    self.stats["batches"] += 1
                    self.stats["images"] += len(batch)
                    self.stats["requests"] += len(batch)
            except Exception as e:  # surface to every waiter, keep serving
                with self._lock:
                    self.stats["errors"] += len(batch)
                for p in batch:
                    p.error = f"{type(e).__name__}: {e}"
            finally:
                for p in batch:
                    p.event.set()

    def _record_latency(self, dt: float):
        with self._lock:
            self._lat_ring.append(dt)
            if len(self._lat_ring) > 1024:
                del self._lat_ring[:512]

    def snapshot(self) -> dict:
        with self._lock:
            lats = sorted(self._lat_ring)
            s = dict(self.stats)
        if lats:
            s["latency_ms_p50"] = round(lats[len(lats) // 2] * 1e3, 2)
            s["latency_ms_p95"] = round(
                lats[min(int(len(lats) * 0.95), len(lats) - 1)] * 1e3, 2)
        s["mean_batch_occupancy"] = round(
            s["images"] / s["batches"], 2) if s["batches"] else 0.0
        s["batch_size"] = self.batch_size
        s["queue_depth"] = self.queue_depth
        return s


def decode_image(body: bytes) -> Optional[np.ndarray]:
    """The default request decoder: cv2.imdecode (jpeg/png/bmp), BGR to
    RGB; None for bytes cv2 cannot decode."""
    import cv2
    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def make_handler(batcher: BatchingDetector, model_name: str,
                 max_body_bytes: int = 32 << 20,
                 decode_fn: Optional[Callable] = None):
    """The request handler class. ``decode_fn(body) -> RGB uint8 (H, W, 3)
    or None`` (None: 400 undecodable); default ``decode_image``."""
    decode = decode_image if decode_fn is None else decode_fn

    class Handler(BaseHTTPRequestHandler):
        # one detection line per request is plenty; BaseHTTPRequestHandler
        # logs every request to stderr by default
        def log_message(self, fmt, *a):
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._send(200, {"status": "ok", "model": model_name,
                                 "classes": len(batcher.det.cfg.classes)})
            elif self.path.startswith("/stats"):
                self._send(200, batcher.snapshot())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/detect"):
                return self._send(404, {"error": "unknown path"})
            try:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    return self._send(400, {"error": "bad Content-Length"})
                if length <= 0:
                    return self._send(400, {"error": "empty body"})
                if length > max_body_bytes:
                    # bound per-request host memory: without this one
                    # multi-GB POST buffers wholesale before decode. The
                    # connection is closed unread (reading the oversized
                    # body to "drain" it would be the same buffering).
                    self.close_connection = True
                    return self._send(413, {
                        "error": f"body {length} bytes exceeds limit "
                                 f"{max_body_bytes}"})
                img = decode(self.rfile.read(length))
                if img is None:
                    return self._send(400, {"error": "undecodable image"})
            except Exception as e:
                return self._send(400, {"error": str(e)})
            try:
                t0 = time.perf_counter()
                results = batcher.detect(img)
                self._send(200, {
                    "detections": results,
                    "ms": round((time.perf_counter() - t0) * 1e3, 1),
                })
            except Overloaded as e:
                # load shedding: tell the client to back off, not to wait
                self.send_response(503)
                body = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(body)
            except TimeoutError as e:
                self._send(503, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": str(e)})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 resets connections as
    # soon as more clients connect at once than the accept loop takes up
    request_queue_size = 256


def serve_http(detector, *, host: str = "0.0.0.0", port: int = 8000,
               batch_size: int = 8, max_wait_ms: float = 5.0,
               max_canvas: int = 1024, model_name: str = "model",
               max_body_bytes: int = 32 << 20, queue_depth: int = 64,
               ready_event: Optional[threading.Event] = None,
               decode_fn: Optional[Callable] = None):
    """Run the server until interrupted. Returns (server, batcher) when
    called with ready_event (test mode: caller drives shutdown).
    ``max_body_bytes`` caps a single POST body (413 beyond it) so one
    oversized upload cannot balloon host memory; ``queue_depth`` caps
    waiting requests (503 + Retry-After beyond it); ``decode_fn`` as
    ``make_handler``'s."""
    batcher = BatchingDetector(detector, batch_size=batch_size,
                               max_wait_ms=max_wait_ms,
                               max_canvas=max_canvas,
                               queue_depth=queue_depth)
    httpd = _HTTPServer(
        (host, port),
        make_handler(batcher, model_name, max_body_bytes=max_body_bytes,
                     decode_fn=decode_fn))
    if ready_event is not None:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        ready_event.set()
        return httpd, batcher
    print(f"serving {model_name} on {host}:{httpd.server_address[1]} "
          f"(batch {batch_size}, window {max_wait_ms} ms)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        batcher.close()
