#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, one line each (a failed phase exits nonzero, and no phase's failure
is caught):
  1. device: the card, as nvidia-smi reports its name and power limit;
  2. build:  nvcc builds the CUDA kernels from yolo_tensorflow_tpu_torch/csrc;
  3. kernel: the decode kernel against its plain PyTorch version on the same
             CUDA tensors, at the yolov3-416 head shapes, f32 and bf16, with
             both times from CUDA events;
  4. f32:    Detector("yolov3", <seeded .weights>).detect_batch at 416 on
             CUDA, through the decode kernel (its launch count is read around
             this run), against the same port on the CPU;
  5. bf16:   batch-64 bf16 serving throughput, and where its time goes.
Then a JSON line describing each kernel, and last the JSON result line.

The weights are random, drawn from a numpy seed (there are no pretrained
weights in the repository), at full Darknet-53 + FPN width, 80 classes.
Imports nothing of JAX: the machine with the card has none.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MODEL = "yolov3"
SEED = 0
OBJ_BIAS = -3.0          # keeps most seeded scores below 0.5: see phase 4
CONF = 0.5               # the model's own confidence threshold
KERNEL_BATCH = 8         # phase 3
PARITY_BATCH = 2         # phase 4
SERVE_BATCH = 64         # phase 5
# f32 kernel vs plain: the same float32 formulas, differing only in the
# rounding of expf and of the softmax sum order: a few ulp. bf16 inputs
# widen exactly to f32 in both, so the bf16 comparison holds to the same.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
# f32 detections, card vs CPU: TF32 is off, but cuDNN and the CPU sum each
# conv in another order, over 75 layers (the CPU tests hold the port to the
# JAX package at the same tolerance).
PARITY_TOL = dict(rtol=1e-4, atol=1e-5)


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters):
    """Host time of ``iters`` calls of fn(), ending in a synchronize, in ms
    per call (the NMS loop syncs with the host, so events alone would not
    say what a caller waits)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from yolo_tensorflow_tpu import config as C
    from yolo_tensorflow_tpu.models import specs as S
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine
    from yolo_tensorflow_tpu_torch.ops.kernels import build
    from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
    from yolo_tensorflow_tpu_torch.pipeline import Detector, normalize_images
    from yolo_tensorflow_tpu_torch.post import nms as NMS

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build(force=True)
    build_s = time.perf_counter() - t0
    build.load()
    print(f"[2 build] nvcc built {[s.name for s in build.sources()]} -> "
          f"{lib_path.name} in {build_s:.2f} s")

    # 3. kernel vs plain at the yolov3-416 head shapes
    cfg = C.get_config(MODEL)
    specs = C.build_specs(cfg)
    shapes = engine.infer_shapes(specs, (1, cfg.input_size, cfg.input_size,
                                         3))
    head_specs = [(shapes[i][1:], sp) for i, sp in enumerate(specs)
                  if isinstance(sp, S.Detect)]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def heads_on_card(batch, dtype):
        return [(torch.randn((batch, *shp), generator=gen, device=dev)
                 .to(dtype), sp) for shp, sp in head_specs]

    max_err = 0.0
    for batch, dtype in ((KERNEL_BATCH, torch.float32),
                         (KERNEL_BATCH, torch.bfloat16),
                         (SERVE_BATCH, torch.bfloat16)):
        dets = heads_on_card(batch, dtype)
        got, want = K.decode_fused(dets, cfg), K.decode_plain(dets, cfg)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, **KERNEL_TOL)
            err = max(err, (g - w).abs().max().item())
        require(torch.equal(got[2], want[2]), f"{dtype} labels differ")
        max_err = max(max_err, err)
        kernel_ms = cuda_ms(lambda: K.decode_fused(dets, cfg))
        plain_ms = cuda_ms(lambda: K.decode_plain(dets, cfg))
        in_mb = sum(f.numel() * f.element_size() for f, _ in dets) / 1e6
        print(f"[3 kernel] decode {str(dtype)[6:]} B={batch} "
              f"N={got[1].shape[1]}: equal to plain within {KERNEL_TOL}, "
              f"labels equal, max |err| {err:.3g}; kernel {kernel_ms:.4f} ms "
              f"({in_mb / kernel_ms:.1f} GB/s read), plain {plain_ms:.4f} ms")
    del dets, got, want     # the JSON line keeps the last, serving-shape times

    with tempfile.TemporaryDirectory() as tmp:
        # 4. main path, f32 parity
        path = os.path.join(tmp, f"{MODEL}-seed{SEED}.weights")
        params, stats = engine.init_params(specs, cfg.input_size, SEED,
                                           obj_bias=OBJ_BIAS)
        W.save_darknet_weights(specs, cfg.input_size, params, stats, path)
        del params, stats
        rng = np.random.default_rng(SEED + 1)
        imgs = rng.integers(0, 256, (PARITY_BATCH, cfg.input_size,
                                     cfg.input_size, 3), dtype=np.uint8)
        gpu = Detector(MODEL, path, device="cuda", conf_threshold=CONF)
        gpu.detect_batch(imgs)                 # warm-up, outside the count
        torch.cuda.synchronize()
        K.launches = 0
        got = gpu.detect_batch(imgs)           # f32, TF32 off in the network
        torch.cuda.synchronize()
        launches = K.launches
        require(launches == len(head_specs),
                f"decode kernel launched {launches} times in the main path, "
                f"expected one per head scale ({len(head_specs)})")
        got = NMS.fetch_detections(got)
        cpu = Detector(MODEL, path, device="cpu", conf_threshold=CONF)
        want = NMS.fetch_detections(cpu.detect_batch(imgs))
        with torch.inference_mode():
            feats = gpu.network(normalize_images(
                torch.as_tensor(imgs, device=dev), cfg))
            scores = K.decode_plain(feats, cfg)[1]
        top = torch.topk(scores, 256, dim=1).values
        ties = [256 - torch.unique(row).numel() for row in top]
        print(f"[4 f32] scores in [{scores.min().item():.4g}, "
              f"{scores.max().item():.4g}], {int((scores > CONF).sum())} "
              f"above {CONF}; exact ties in each image's top 256: {ties}")
        require(not any(ties), "tied top-256 scores: the comparison would "
                "depend on tie order")
        require(np.all(got.num > 0), f"no detections: num={got.num}")
        for name in ("num", "classes", "valid"):
            require(np.array_equal(getattr(got, name), getattr(want, name)),
                    f"card and CPU {name} differ")
        err = {}
        for name in ("boxes", "scores"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), **PARITY_TOL)
            err[name] = float(np.abs(getattr(got, name)
                                     - getattr(want, name)).max())
        require(got.boxes.shape == (PARITY_BATCH, cfg.max_detections, 4)
                and np.isfinite(got.boxes).all(),
                f"boxes {got.boxes.shape} not finite or not (B, D, 4)")
        print(f"[4 f32] Detector({MODEL!r}, seeded .weights).detect_batch "
              f"B={PARITY_BATCH} at {cfg.input_size} on {kind}: num "
              f"{got.num.tolist()}, classes/valid equal to the CPU port, "
              f"max |err| boxes {err['boxes']:.3g} scores "
              f"{err['scores']:.3g} (tol {PARITY_TOL}); decode kernel "
              f"launches {launches}")
        del gpu, cpu, feats

        # 5. main path, bf16 serving
        torch.backends.cudnn.benchmark = True
        det = Detector(MODEL, path, device="cuda",
                       compute_dtype=torch.bfloat16, conf_threshold=CONF)
    x = torch.as_tensor(rng.integers(0, 256, (SERVE_BATCH, cfg.input_size,
                                              cfg.input_size, 3),
                                     dtype=np.uint8), device=dev)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        out = det.detect_batch(x)
    iters = 5
    step_ms = sorted(wall_ms(lambda: det.detect_batch(x), iters)
                     for _ in range(3))
    rates = [SERVE_BATCH * 1e3 / ms for ms in step_ms]
    out = NMS.fetch_detections(out)
    require(np.isfinite(out.boxes).all() and np.all(out.num > 0),
            "bf16 detections empty or not finite")
    with torch.inference_mode():
        xn = normalize_images(x, cfg, torch.bfloat16)
        net_ms = cuda_ms(lambda: det.network(xn), iters=iters)
        feats = det.network(xn)
        dec_ms = cuda_ms(lambda: K.decode_fused(feats, cfg), iters=iters)
        boxes, scores, labels = K.decode_fused(feats, cfg)
        nms_ms = statistics.median(
            wall_ms(lambda: NMS.batched_nms_scored(
                boxes, scores, labels, conf_threshold=CONF,
                iou_threshold=cfg.iou_threshold,
                max_detections=cfg.max_detections), iters)
            for _ in range(3))
    step = statistics.median(step_ms)
    print(f"[5 bf16] detect_batch B={SERVE_BATCH} at {cfg.input_size}, "
          f"images on the card: {statistics.median(rates):.1f} img/s median "
          f"of 3 x {iters} steps (spread {min(rates):.1f}..{max(rates):.1f}), "
          f"step {step:.2f} ms; backbone {net_ms:.2f} ms, decode "
          f"{dec_ms:.3f} ms, NMS {nms_ms:.2f} ms = {100 * nms_ms / step:.1f}% "
          f"of the step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"mean num {out.num.mean():.1f}; on {smi}")

    print(json.dumps({"kernels": [{
        "name": "decode_fused", "route": "cuda",
        "source": "yolo_tensorflow_tpu_torch/csrc/decode.cu",
        "replaces": "yolo_tensorflow_tpu/ops/pallas/decode.py:82",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
