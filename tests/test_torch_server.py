"""The port's HTTP micro-batching server (yolo_tensorflow_tpu_torch/
server.py) on the CPU, against the JAX package's (server.py) on the same
narrow v3 net, parameters and images: the cases of tests/test_server.py.

- Results through the port's batcher equal the port's own per-image fused
  ``Detector.detect`` exactly (classes, boxes, scores), with oneDNN's
  batch-dependent CPU convolution off (``torch_parity.
  batch_invariant_conv``): the batch pads with empty canvases, which must
  change nothing.
- Against the JAX ``BatchingDetector`` on the same image: classes exact,
  boxes (pixels) within rtol 1e-4 / atol 1e-3 and scores within rtol 1e-4
  / atol 1e-5 (float32 conv sums in another order; measured below 1e-4 px).
- Every thread join and event wait has a timeout. The two soaks are
  ``slow`` and run 3 s at most each.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from yolo_tensorflow_tpu.pipeline import Detector as JaxDetector
from yolo_tensorflow_tpu.server import BatchingDetector as JaxBatching
from yolo_tensorflow_tpu_torch.cli import decode_npy
from yolo_tensorflow_tpu_torch.ops import quant as TQ
from yolo_tensorflow_tpu_torch.io.weights import params_to_jax
from yolo_tensorflow_tpu_torch.pipeline import Detector
from yolo_tensorflow_tpu_torch.server import (BatchingDetector, Overloaded,
                                              serve_http)

from torch_parity import (batch_invariant_conv, folded_params, jax_model,
                          model)

SIZE = 64
OPTS = dict(conf_threshold=0.3, max_detections=10, num_candidates=64)
BOX_TOL = dict(rtol=1e-4, atol=1e-3)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
JOIN_S = 60


def _pair(params=None, **kw):
    cfg, specs = model("narrow", SIZE)
    jcfg, jspecs = jax_model("narrow", SIZE)
    if params is None:
        port, jaxp = folded_params(specs, SIZE)
    else:
        port, jaxp = params, params_to_jax(params)
    opts = {**OPTS, **kw}
    return (Detector(cfg, params=port, specs=specs, device="cpu", **opts),
            JaxDetector(jcfg, params=jaxp, specs=jspecs, **opts))


@pytest.fixture(scope="module")
def detectors():
    return _pair(letterbox=True, fused=True)


@pytest.fixture(autouse=True)
def _invariant():
    with batch_invariant_conv():
        yield


def _img(seed, h=50, w=70):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)


def _npy(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def assert_like_jax(got, want):
    assert [d["class_id"] for d in got] == [d["class_id"] for d in want]
    np.testing.assert_allclose(
        np.asarray([d["box"] for d in got], np.float64).reshape(-1, 4),
        np.asarray([d["box"] for d in want], np.float64).reshape(-1, 4),
        **BOX_TOL)
    np.testing.assert_allclose([d["score"] for d in got],
                               [d["score"] for d in want], **SCORE_TOL)


def _jax_batched(jdet, img, **kw):
    jb = JaxBatching(jdet, **kw)
    try:
        return jb.detect(img, timeout=JOIN_S)
    finally:
        jb.close()


def test_batcher_requires_fused():
    det, _ = _pair()
    with pytest.raises(ValueError, match="fused"):
        BatchingDetector(det)


def test_batched_equals_single_detect(detectors):
    """A request through the batcher returns exactly what the fused
    per-image path returns (padding rows change nothing), and what the JAX
    batcher returns."""
    det, jdet = detectors
    b = BatchingDetector(det, batch_size=4, max_wait_ms=1.0)
    try:
        img = _img(1)
        got = b.detect(img, timeout=JOIN_S)
        assert got == det.detect(img)
        assert len(got) > 0
        assert_like_jax(got, _jax_batched(jdet, img, batch_size=4,
                                          max_wait_ms=1.0))
    finally:
        b.close()


def test_concurrent_requests_coalesce(detectors):
    """N parallel requests inside one window ride fewer device batches
    than N, and every caller gets its own image's results."""
    det, jdet = detectors
    b = BatchingDetector(det, batch_size=8, max_wait_ms=200.0)
    try:
        imgs = [_img(i, 40 + i, 60 + i) for i in range(6)]
        results = [None] * 6

        def call(i):
            results[i] = b.detect(imgs[i], timeout=JOIN_S)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        snap = b.snapshot()
        assert snap["requests"] == 6
        assert snap["batches"] < 6          # coalesced
        assert snap["mean_batch_occupancy"] > 1
        for i in range(6):
            assert results[i] == det.detect(imgs[i]), i
        assert_like_jax(results[2], jdet._detect_fused(imgs[2]))
    finally:
        b.close()


def test_oversize_image_downscales_with_per_axis_ratios(detectors):
    """Images past max_canvas are host-downscaled (cv2 INTER_AREA); boxes
    multiply back by per-axis ratios, as in the JAX package."""
    det, jdet = detectors
    b = BatchingDetector(det, batch_size=2, max_wait_ms=1.0, max_canvas=256)
    try:
        img = _img(3, h=301, w=517)        # bucket would be 768
        res = b.detect(img, timeout=JOIN_S)
        for r in res:
            x0, y0, x1, y1 = r["box"]
            assert -5 <= x0 <= 517 + 5 and -5 <= y0 <= 301 + 5
        assert_like_jax(res, _jax_batched(jdet, img, batch_size=2,
                                          max_wait_ms=1.0, max_canvas=256))
    finally:
        b.close()


def test_http_endpoints(detectors):
    import cv2
    det, jdet = detectors
    ready = threading.Event()
    httpd, batcher = serve_http(det, host="127.0.0.1", port=0,
                                batch_size=4, max_wait_ms=1.0,
                                model_name="narrow", ready_event=ready)
    assert ready.wait(5)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["model"] == "narrow"
        assert h["classes"] == 4

        ok, buf = cv2.imencode(".png", _img(5)[..., ::-1])
        assert ok
        req = urllib.request.Request(base + "/detect", data=buf.tobytes(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        assert "detections" in out and "ms" in out
        want = json.loads(json.dumps(det.detect(_img(5))))
        assert out["detections"] == want
        assert_like_jax(out["detections"], jdet._detect_fused(_img(5)))

        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            st = json.loads(r.read())
        assert st["requests"] >= 1 and st["batches"] >= 1
        assert "latency_ms_p50" in st

        # bad body -> 400, unknown path -> 404
        req = urllib.request.Request(base + "/detect", data=b"not an image",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        batcher.close()


def test_post_body_cap_413_and_npy_bodies(detectors):
    """A POST whose Content-Length exceeds max_body_bytes is refused with
    413 before any read; under the cap the server serves, here with the
    .npy body decoder (``decode_fn``) that needs no cv2."""
    det, _ = detectors
    ready = threading.Event()
    httpd, batcher = serve_http(det, host="127.0.0.1", port=0,
                                batch_size=2, max_wait_ms=1.0,
                                max_body_bytes=10_000, model_name="narrow",
                                ready_event=ready, decode_fn=decode_npy)
    assert ready.wait(5)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        req = urllib.request.Request(base + "/detect",
                                     data=b"x" * 20_000, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 413
        body = _npy(_img(9, 32, 32))
        assert len(body) < 10_000
        req = urllib.request.Request(base + "/detect", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["detections"] == json.loads(
                json.dumps(det.detect(_img(9, 32, 32))))
        # a .npy of the wrong dtype -> 400
        req = urllib.request.Request(base + "/detect",
                                     data=_npy(np.zeros((4, 4, 3))),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        batcher.close()


def test_serve_http_int8_params():
    """The batcher over int8 (w_q) parameters: batched int8 results equal
    the port's fused int8 path and the JAX batcher's."""
    cfg, specs = model("narrow", SIZE)
    port, _ = folded_params(specs, SIZE, seed=21)
    scales = {k: 0.05 for k in port}
    qparams = TQ.quantize_params(specs, port, scales)
    det, jdet = _pair(qparams, conf_threshold=0.05, letterbox=True,
                      fused=True)
    b = BatchingDetector(det, batch_size=4, max_wait_ms=1.0)
    try:
        img = _img(31)
        got = b.detect(img, timeout=JOIN_S)
        assert got == det.detect(img) and len(got) > 0
        assert_like_jax(got, _jax_batched(jdet, img, batch_size=4,
                                          max_wait_ms=1.0))
    finally:
        b.close()


class _GatedDetector:
    """Wraps a fused Detector so the batcher's device call blocks until
    the test opens the gate: makes queue saturation deterministic."""

    fused = True

    def __init__(self, det):
        self._det = det
        self.cfg = det.cfg
        self.gate = threading.Event()

    def detect_batch_fused(self, canvas, sizes):
        assert self.gate.wait(JOIN_S), "test gate never opened"
        return self._det.detect_batch_fused(canvas, sizes)


def test_queue_overload_sheds_immediately(detectors):
    """With the device stalled, requests beyond queue_depth raise
    Overloaded at once (fail-fast load shedding, not a 30 s block), the
    rejected counter records them, and accepted requests all complete
    once the device drains."""
    det, _ = detectors
    gated = _GatedDetector(det)
    depth, batch_size = 4, 2
    b = BatchingDetector(gated, batch_size=batch_size, max_wait_ms=1.0,
                         queue_depth=depth)
    accepted, rejected, results = [], [], {}

    def client(i):
        try:
            results[i] = b.detect(_img(200 + i, 40, 40), timeout=JOIN_S)
            accepted.append(i)
        except Overloaded:
            rejected.append(i)

    try:
        n = batch_size + depth + 5
        threads = []
        for i in range(n):
            t = threading.Thread(target=client, args=(i,))
            t.start()
            threads.append(t)
            time.sleep(0.05)   # let each enqueue (or shed) in order
        assert len(rejected) >= 5 - 1, (rejected, accepted)
        gated.gate.set()
        for t in threads:
            t.join(timeout=JOIN_S)
        snap = b.snapshot()
        assert len(accepted) + len(rejected) == n
        assert snap["rejected"] == len(rejected) >= 4
        assert snap["requests"] == len(accepted)
        assert snap["errors"] == 0
        for i in accepted:
            assert results[i] == det.detect(_img(200 + i, 40, 40))
    finally:
        gated.gate.set()
        b.close()


def test_http_503_under_overload(detectors):
    """Flooding the HTTP server past queue_depth yields 503 responses with
    Retry-After, and the server keeps serving after the overload drains;
    /stats reconciles: requests = images = the 200 responses."""
    det, jdet = detectors
    gated = _GatedDetector(det)
    ready = threading.Event()
    httpd, batcher = serve_http(gated, host="127.0.0.1", port=0,
                                batch_size=2, max_wait_ms=1.0,
                                queue_depth=2, model_name="narrow",
                                ready_event=ready, decode_fn=decode_npy)
    assert ready.wait(5)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = _npy(_img(7, 32, 32))
    codes, retry_after = [], []

    def post():
        req = urllib.request.Request(base + "/detect", data=body,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=JOIN_S) as r:
                codes.append(r.status)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
            if e.code == 503:
                retry_after.append(e.headers.get("Retry-After"))

    try:
        threads = []
        for _ in range(12):     # in-flight 2 + queued 2 -> >=8 shed
            t = threading.Thread(target=post)
            t.start()
            threads.append(t)
            time.sleep(0.05)
        gated.gate.set()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert codes.count(503) >= 6, codes
        assert codes.count(200) >= 2, codes
        assert all(ra == "1" for ra in retry_after)
        req = urllib.request.Request(base + "/detect", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            got = json.loads(r.read())["detections"]
        assert got == json.loads(json.dumps(det.detect(_img(7, 32, 32))))
        assert_like_jax(got, jdet._detect_fused(_img(7, 32, 32)))
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            st = json.loads(r.read())
        assert st["rejected"] >= 6
        assert st["requests"] == st["images"] == codes.count(200) + 1
        assert st["errors"] == 0
    finally:
        gated.gate.set()
        httpd.shutdown()
        batcher.close()


@pytest.mark.slow
def test_sustained_soak_latency(detectors):
    """A 3 s soak at steady offered load: every request inside
    queue_depth completes, p95 wait stays bounded well below the timeout,
    and stats reconcile after the drain."""
    det, _ = detectors
    b = BatchingDetector(det, batch_size=4, max_wait_ms=2.0, queue_depth=32)
    b.detect(_img(299, 40, 44), timeout=JOIN_S)
    warm = b.snapshot()["requests"]
    stop = time.perf_counter() + 3.0
    lat, errors = [], []

    def client(i):
        k = 0
        while time.perf_counter() < stop:
            t0 = time.perf_counter()
            try:
                res = b.detect(_img(300 + i * 97 + k, 40, 44),
                               timeout=JOIN_S)
                assert isinstance(res, list)
                lat.append(time.perf_counter() - t0)
            except Overloaded:
                time.sleep(0.05)    # honest client: back off and retry
            except Exception as e:  # failure evidence
                errors.append(repr(e))
            k += 1

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not errors, errors[:3]
        assert len(lat) >= 8, "soak produced too few completions"
        lat.sort()
        p95 = lat[min(int(len(lat) * 0.95), len(lat) - 1)]
        assert p95 < 30.0, f"p95 {p95:.1f}s indistinguishable from timeout"
        snap = b.snapshot()
        assert snap["requests"] == len(lat) + warm
        assert snap["errors"] == 0
    finally:
        b.close()


@pytest.mark.slow
def test_sustained_concurrency_load(detectors):
    """Client threads each firing a stream of requests (3 s at most):
    every request completes, none error, the stats add up, and results
    under load equal the per-image path."""
    det, _ = detectors
    n_threads, n_each = 6, 4
    b = BatchingDetector(det, batch_size=4, max_wait_ms=2.0, queue_depth=16)
    imgs = [_img(100 + i, 40 + (i % 5) * 4, 50 + (i % 7) * 2)
            for i in range(n_threads)]
    errors, done = [], [0] * n_threads
    stop = time.perf_counter() + 3.0

    def client(i):
        for _ in range(n_each):
            if time.perf_counter() > stop:
                return
            try:
                res = b.detect(imgs[i], timeout=JOIN_S)
                assert res == det.detect(imgs[i])
                done[i] += 1
            except Exception as e:  # failure evidence
                errors.append((i, repr(e)))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not errors, errors[:3]
        snap = b.snapshot()
        assert snap["requests"] == snap["images"] == sum(done) > 0
        assert snap["errors"] == 0
        assert snap["mean_batch_occupancy"] >= 1.0
    finally:
        b.close()
