"""The port's streaming driver (yolo_tensorflow_tpu_torch/serving.py) on
the CPU, against the JAX package's ``stream_detect`` on the same directory
of PNG frames at the input size and the same narrow v3 parameters.

- Plain and smoothed (avg_frames=3): the same frame count, and per batch
  the same num and classes as the JAX driver's, boxes and scores within
  rtol 1e-4 / atol 1e-5 (float32 conv sums in another order); the tail
  batch padded (5 frames at batch 2) and its padding not counted.
- The port alone: each plain batch equals ``detect_batch`` of its frames,
  bit for bit; a directory read through ``read_fn`` (.npy frames, no
  cv2); a frame already at the input size is not resized (cv2.resize to
  the same size returns its input); an early stop (max_batches) and a
  consumer that raises release the fetcher thread; a source that raises
  ends the stream with the frames read so far.
"""

import threading
import time

import cv2
import numpy as np
import pytest

from yolo_tensorflow_tpu.pipeline import Detector as JaxDetector
from yolo_tensorflow_tpu.serving import stream_detect as jax_stream
from yolo_tensorflow_tpu_torch.pipeline import Detector
from yolo_tensorflow_tpu_torch.post import nms as NMS
from yolo_tensorflow_tpu_torch.serving import frame_source, stream_detect

from torch_parity import (batch_invariant_conv, folded_params, images,
                          jax_model, model)

SIZE = 64
OPTS = dict(conf_threshold=0.3, num_candidates=64, max_detections=10)
PARITY = dict(rtol=1e-4, atol=1e-5)
JOIN_S = 30


@pytest.fixture(scope="module")
def detectors():
    cfg, specs = model("narrow", SIZE)
    jcfg, jspecs = jax_model("narrow", SIZE)
    port, jaxp = folded_params(specs, SIZE)
    return (Detector(cfg, params=port, specs=specs, device="cpu", **OPTS),
            JaxDetector(jcfg, params=jaxp, specs=jspecs, **OPTS))


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """5 seeded RGB frames as PNG files (and .npy twins in a sibling)."""
    root = tmp_path_factory.mktemp("frames")
    npy = tmp_path_factory.mktemp("npy")
    frames = images(5, SIZE, seed=7)
    for i, f in enumerate(frames):
        cv2.imwrite(str(root / f"f{i}.png"), cv2.cvtColor(f,
                                                          cv2.COLOR_RGB2BGR))
        np.save(str(npy / f"f{i}.npy"), f)
    return str(root), str(npy), frames


def _collect(fn, det, source, **kw):
    got = []
    n, dt, fps = fn(det, source, batch_size=2,
                    on_batch=lambda d, im: got.append(
                        (NMS.Detections(*(np.asarray(f) for f in d)),
                         im.copy())), **kw)
    return n, got


@pytest.mark.parametrize("avg", [0, 3])
def test_stream_matches_jax(detectors, frames_dir, avg):
    det, jdet = detectors
    root, _, frames = frames_dir
    n, got = _collect(stream_detect, det, root, avg_frames=avg)
    jn, want = _collect(jax_stream, jdet, root, avg_frames=avg)
    assert n == jn == 5 and len(got) == len(want) == 3
    assert got[-1][1].shape[0] == 1               # the padded tail
    np.testing.assert_array_equal(np.concatenate([im for _, im in got]),
                                  frames)
    total = 0
    for (d, _), (w, _) in zip(got, want):
        for name in ("num", "classes", "valid"):
            np.testing.assert_array_equal(getattr(d, name),
                                          getattr(w, name), err_msg=name)
        for name in ("boxes", "scores"):
            np.testing.assert_allclose(getattr(d, name), getattr(w, name),
                                       **PARITY, err_msg=name)
        total += int(d.num[:2].sum())
    assert total > 0


def test_plain_batches_equal_detect_batch(detectors, frames_dir):
    det, _ = detectors
    root, npy, frames = frames_dir
    for source, read_fn in ((root, None), (npy, np.load)):
        n, got = _collect(stream_detect, det, source, read_fn=read_fn)
        assert n == 5
        for b, (d, im) in enumerate(got):
            batch = frames[2 * b:2 * b + 2]
            np.testing.assert_array_equal(im, batch)
            if len(batch) < 2:
                batch = np.concatenate([batch, np.zeros_like(batch)])
            want = NMS.fetch_detections(det.detect_batch(batch))
            assert all(np.array_equal(x, y) for x, y in zip(d, want))


def test_smoothed_stream_equals_frame_by_frame(detectors, frames_dir):
    """avg_frames=3 over batches of 2, the state carried, against
    detect_batch_smoothed frame by frame (bit for bit with oneDNN's
    batch-dependent CPU conv off)."""
    det, _ = detectors
    root, _, frames = frames_dir
    with batch_invariant_conv():
        _, got = _collect(stream_detect, det, root, avg_frames=3)
        state = None
        for i in range(5):
            w, state = det.detect_batch_smoothed(frames[i:i + 1], state)
            w = NMS.fetch_detections(w)
            d = got[i // 2][0]
            assert all(np.array_equal(x[i % 2], y[0])
                       for x, y in zip(d, w)), i


def test_frame_at_input_size_is_not_resized(frames_dir, tmp_path):
    """A frame at the input size comes through as it is, which is what
    cv2.resize to the same size returns; another size is resized."""
    _, npy, frames = frames_dir
    got = list(frame_source(npy, SIZE, read_fn=np.load))
    assert all(np.array_equal(g, f) for g, f in zip(got, frames))
    assert all(np.array_equal(cv2.resize(f, (SIZE, SIZE)), f)
               for f in frames)
    np.save(str(tmp_path / "big.npy"), images(1, 80)[0])
    (big,) = frame_source(str(tmp_path), SIZE, read_fn=np.load)
    np.testing.assert_array_equal(big, cv2.resize(images(1, 80)[0],
                                                  (SIZE, SIZE)))


def _fetchers_done(before):
    deadline = time.perf_counter() + JOIN_S
    while time.perf_counter() < deadline:
        if threading.active_count() <= before:
            return True
        time.sleep(0.05)
    return False


def test_early_stop_releases_fetcher(detectors, frames_dir):
    det, _ = detectors
    root = frames_dir[0]
    before = threading.active_count()
    n, _, _ = stream_detect(det, root, batch_size=2, loops=50,
                            prefetch=1, max_batches=1)
    assert n == 2
    assert _fetchers_done(before)


def test_raising_consumer_releases_fetcher(detectors, frames_dir):
    det, _ = detectors
    root = frames_dir[0]
    before = threading.active_count()

    def boom(dets, imgs):
        raise RuntimeError("consumer failed")

    with pytest.raises(RuntimeError, match="consumer failed"):
        stream_detect(det, root, batch_size=2, loops=50, prefetch=1,
                      on_batch=boom)
    assert _fetchers_done(before)


def test_raising_source_ends_the_stream(detectors, frames_dir):
    """A read_fn that raises on the fourth file: the fetcher's error ends
    the stream (the sentinel is always sent), with the frames read before
    it, the last batch padded."""
    det, _ = detectors
    npy = frames_dir[1]
    calls = []

    def read(path):
        calls.append(path)
        if len(calls) == 4:
            raise OSError("unreadable frame")
        return np.load(path)

    before = threading.active_count()
    n, _, _ = stream_detect(det, npy, batch_size=2, read_fn=read)
    assert n == 2 and len(calls) == 4
    assert _fetchers_done(before)


def test_video_source_needs_cv2_message(monkeypatch):
    """Without cv2 a camera source raises an ImportError that says so."""
    import builtins
    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="OpenCV"):
        next(frame_source(0, SIZE))
