"""The generator and driver of serving mixes (``"kind": "serve"``).

A serving mix is a data file of ``benchmark/traffic``: the batch (of frames
at the network's input size), the number of distinct batches in the pool,
how many batches are in flight, the precision, and how many batches
set-up, the trace and the check take. This module reads any
such file; a new mix is a new file.

The load is a closed loop of one client: it hands the port a batch of
frames held in pinned host memory (as a decoder writing into pinned
buffers would), asks for the batch's packed detections on the host, and
hands over the next batch before it waits for that readback, so that up to
``in_flight`` batches are outstanding.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

import compare
import weights as W
from reference import detect as RD
from reference import model as RM

INPUT_SEED_OFFSET = 1 << 32      # the inputs' generator: seed + this


class _Ready:
    """A CUDA event's stand-in on the CPU, where every call has finished
    when it returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


def event(device):
    return torch.cuda.Event() if device.type == "cuda" else _Ready()


def host_buffer(shape, dtype, device):
    """A host buffer, pinned where there is a card to copy from."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=device.type == "cuda")


def frame_pool(cfg, traffic, seed: int, device):
    """The pool of distinct batches, (P, B, S, S, 3) uint8 noise at the
    network's input size S drawn on the card from the seed, in pinned host
    memory."""
    side = cfg["input_size"]
    shape = (traffic["pool_batches"], traffic["batch"], side, side, 3)
    gen = torch.Generator(device=device).manual_seed(seed
                                                     + INPUT_SEED_OFFSET)
    drawn = torch.randint(0, 256, shape, generator=gen, device=device,
                          dtype=torch.uint8)
    pool = host_buffer(shape, torch.uint8, device)
    pool.copy_(drawn)
    del drawn
    return pool


def port_params(drawn):
    """The seeded weights in the port's layout and loading form: numpy
    {layer key: {"w", "gamma", "beta"} or {"w", "b"}} and the running
    statistics {layer key: {"mean", "var"}}."""
    from yolo_tensorflow_tpu_torch.models import engine
    params, stats = {}, {}
    for i, p in drawn.items():
        host = {k: v.cpu().numpy() for k, v in p.items()}
        key = engine.layer_key(i)
        if "gamma" in host:
            params[key] = {k: host[k] for k in ("w", "gamma", "beta")}
            stats[key] = {k: host[k] for k in ("mean", "var")}
        else:
            params[key] = host
    return params, stats


class Server:
    """The system under test: the port's Detector built the way a serving
    deployment builds it from darknet-form weights."""

    def __init__(self, cfg, traffic, drawn, device):
        from yolo_tensorflow_tpu_torch import config as C
        from yolo_tensorflow_tpu_torch.io.weights import fold_params
        from yolo_tensorflow_tpu_torch.models import engine
        from yolo_tensorflow_tpu_torch.models import specs as S
        from yolo_tensorflow_tpu_torch.ops import quant as Q
        from yolo_tensorflow_tpu_torch.pipeline import Detector
        from yolo_tensorflow_tpu_torch.post import nms as NMS
        self.NMS = NMS
        model_cfg = C.get_config(cfg["model"],
                                 input_size=cfg["input_size"])
        specs = C.build_specs(model_cfg)
        params, stats = port_params(drawn)
        params = fold_params(params, stats, model_cfg.bn_eps)
        if traffic["precision"] == "int8":
            scales = {engine.layer_key(i): traffic["act_scale"]
                      for i, sp in enumerate(specs) if isinstance(sp, S.Conv)}
            params = Q.quantize_params(specs, params, scales)
        self.device = device
        self.detector = Detector(
            model_cfg, params=params, device=device,
            compute_dtype=torch.bfloat16, score_dtype=torch.bfloat16,
            num_candidates=cfg["num_candidates"],
            conf_threshold=cfg["conf_threshold"],
            iou_threshold=cfg["iou_threshold"],
            max_detections=cfg["max_detections"],
            class_aware_nms=cfg["class_aware_nms"])

    def submit(self, frames):
        """Hand one batch of host frames to the port; returns its packed
        detections on the device."""
        return self.NMS.pack_detections(self.detector.detect_batch(frames))

    def unpack(self, packed_rows):
        return self.NMS.unpack_detections(packed_rows)


class Loop:
    """The closed loop: batches handed over in pool order, their packed
    detections copied into a ring of pinned host buffers, at most
    ``in_flight`` outstanding."""

    def __init__(self, server, pool, in_flight):
        self.server, self.pool, self.depth = server, pool, in_flight
        self.ring = []
        self.pending = collections.deque()
        self.k = 0

    def submit(self):
        t = time.perf_counter()
        with torch.profiler.record_function("bench.submit"):
            packed = self.server.submit(self.pool[self.k % len(self.pool)])
            if len(self.ring) <= self.depth:
                self.ring.append(host_buffer(packed.shape, packed.dtype,
                                             self.server.device))
            buf = self.ring[self.k % len(self.ring)]
            buf.copy_(packed, non_blocking=True)
            done = event(self.server.device)
            done.record()
        self.pending.append((self.k, t, done, buf))
        self.k += 1

    def complete(self):
        """Wait for the oldest batch: (index, hand-over time, arrival time,
        its packed rows on the host)."""
        k, t, done, buf = self.pending.popleft()
        with torch.profiler.record_function("bench.readback"):
            done.synchronize()
        return k, t, time.perf_counter(), buf.numpy().copy()

    def step(self):
        """Hand over one batch; returns the completed ones."""
        self.submit()
        out = []
        while len(self.pending) >= self.depth:
            out.append(self.complete())
        return out

    def drain(self):
        out = []
        while self.pending:
            out.append(self.complete())
        return out


def run(ctx):
    """One run of a serving cell: set-up, warm-up, the window, then the
    check. Returns the run's record for ``run.py``."""
    cfg, traffic, seed = ctx.cfg, ctx.traffic, ctx.seed
    dev = ctx.device
    cuda = dev.type == "cuda"
    drawn = W.draw(cfg, seed, dev)
    pool = frame_pool(cfg, traffic, seed, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    server = Server(cfg, traffic, drawn, dev)
    loop = Loop(server, pool, traffic["in_flight"])
    with torch.inference_mode():
        for _ in range(traffic["warmup_batches"]):
            loop.step()
        loop.drain()
        if cuda:
            torch.cuda.synchronize(dev)
        setup_s = ctx.clock()

        batch = traffic["batch"]
        traced = None
        if ctx.trace:
            def traced_batches():
                for _ in range(traffic["trace_batches"]):
                    loop.step()
                loop.drain()
            traced = ctx.profile(traced_batches)
            traced.images = traffic["trace_batches"] * batch
        t_start = time.perf_counter()
        t_end = t_start + ctx.seconds
        done = []
        while time.perf_counter() < t_end:
            done.extend(loop.step())
        done.extend(loop.drain())
    # every batch handed over in the window, over the time to its answer
    window = max(d[2] for d in done) - t_start if done else float("nan")
    lat_ms = [(d[2] - d[1]) * 1e3 for d in done]
    rec = {
        "setup_s": setup_s,
        "attempted": len(done) * batch,
        "failed": 0,
        "e2e": {"serve_img_s": (len(done) * batch / window if done
                                else None),
                "batch_p95_ms": (float(np.percentile(lat_ms, 95))
                                 if lat_ms else None)},
        "notes": [f"batches in the window: {len(done)} ({len(done) * batch}"
                  f" images) in {window:.4f} s; batch latency samples "
                  f"{len(lat_ms)}, median "
                  f"{np.median(lat_ms) if lat_ms else float('nan'):.3f} ms"],
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                              else 0),
        "trace": traced,
    }
    results = {d[0]: d[3] for d in done}
    unpack = server.unpack
    del server, loop
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    rec["checks"] = check(ctx, drawn, pool, results, unpack)
    rec["notes"] += ctx.notes + [
        f"check: {time.perf_counter() - t_check:.2f} s"]
    return rec


def sample(results, pool_batches, batch, n, seed):
    """(batch index, row) pairs drawn from the seed among the batches that
    completed in the window."""
    keys = sorted(results)
    rng = np.random.default_rng(seed)
    ks = rng.choice(keys, size=n, replace=True)
    rows = rng.integers(0, batch, size=n)
    return sorted(zip(ks.tolist(), rows.tolist()))


def reference_answers(cfg, traffic, drawn, pool, picks, precision, device):
    """{(pool batch, row): (candidates, kept)} of the reference for the
    picked frames, in blocks: candidates = every anchor's (xyxy boxes in
    the port's output frame, objectness, class probabilities), kept = its
    own NMS's (boxes, scores, labels)."""
    folded = {i: RM.fold(p, cfg["bn_eps"]) for i, p in drawn.items()}
    want = sorted({(k % traffic["pool_batches"], r) for k, r in picks})
    out = {}
    with RM.exact_f32(), torch.no_grad():
        for at in range(0, len(want), traffic["check_block"]):
            block = want[at:at + traffic["check_block"]]
            frames = torch.stack([pool[p, r] for p, r in block]).to(device)
            x = RD.normalize(frames, cfg["normalization_divisor"])
            heads = RM.forward(cfg["layers"], folded, x, precision)
            boxes, obj, probs = RD.decode(heads, cfg)
            for j, key in enumerate(block):
                scores, labels = (obj[j, :, None] * probs[j]).max(dim=-1)
                out[key] = ((boxes[j], obj[j], probs[j]),
                            RD.nms(boxes[j], scores, labels, cfg))
    return out


def reference_precision(traffic, name=None):
    """The precision the mix serves in, as the reference computes it; or
    ``name``, a control's, in its place."""
    return RM.Precision.parse(name or traffic["precision"],
                              traffic["act_scale"])


def gaps_of(ctx, picks, served_of, ref):
    """{"frame_gap": the worst gap of the picked frames}: ``served_of(k,
    r)`` the served (boxes, scores, classes, valid) of batch k's row r.
    Each frame's parts are kept in ``ctx.detail["frames"]``, the worst
    frame's in the notes."""
    traffic, cfg = ctx.traffic, ctx.cfg
    frames = [compare.frame_parts(served_of(k, r),
                                  *ref[(k % traffic["pool_batches"], r)], cfg)
              for k, r in picks]
    ctx.detail["frames"] = frames
    worst = max(frames, key=compare.frame_gap)
    ctx.notes.append(f"worst checked frame of {len(frames)}: {worst}")
    return {"frame_gap": compare.frame_gap(worst)}


def check(ctx, drawn, pool, results, unpack):
    """The numbers compared with the reference, {name: value}, over
    ``check_images`` frames drawn from the seed among the batches that
    completed in the window."""
    traffic, cfg = ctx.traffic, ctx.cfg
    if not results:
        return {"frame_gap": float("inf")}
    picks = sample(results, traffic["pool_batches"], traffic["batch"],
                   traffic["check_images"], ctx.seed)
    ref = reference_answers(cfg, traffic, drawn, pool, picks,
                            reference_precision(traffic), ctx.device)

    def served_of(k, r):
        d = unpack(results[k][r:r + 1])
        return d.boxes[0], d.scores[0], d.classes[0], d.valid[0]

    return gaps_of(ctx, picks, served_of, ref)


def control(ctx):
    """The control's numbers: the reference computed at the mix's
    ``control`` precision (the step below the configuration's: int4 for
    int8) in the program's place, held to the reference as ``check`` holds
    the program's, over as many frames of the pool."""
    traffic, cfg, dev = ctx.traffic, ctx.cfg, ctx.device
    drawn = W.draw(cfg, ctx.seed, dev)
    pool = frame_pool(cfg, traffic, ctx.seed, dev)
    picks = sample({k: None for k in range(traffic["pool_batches"])},
                   traffic["pool_batches"], traffic["batch"],
                   traffic["check_images"], ctx.seed)
    low = reference_answers(cfg, traffic, drawn, pool, picks,
                            reference_precision(traffic, traffic["control"]),
                            dev)
    ref = reference_answers(cfg, traffic, drawn, pool, picks,
                            reference_precision(traffic), dev)
    D = cfg["max_detections"]

    def served_of(k, r):
        boxes, scores, labels = low[(k % traffic["pool_batches"], r)][1]
        n = len(scores)
        out = (np.zeros((D, 4), np.float32), np.zeros(D, np.float32),
               np.zeros(D, np.int32), np.zeros(D, bool))
        out[0][:n] = boxes.cpu().numpy()
        out[1][:n] = scores.cpu().numpy()
        out[2][:n] = labels.cpu().numpy()
        out[3][:n] = True
        return out

    return gaps_of(ctx, picks, served_of, ref)
