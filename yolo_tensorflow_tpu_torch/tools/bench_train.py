"""Training-step throughput on one card: YOLOv3-416, the full darknet loss.

The port's counterpart of tools/bench_train.py: normalize -> Darknet-53
FPN forward (train-mode BN) -> the yolo_layer.c loss -> backward ->
SGD/momentum update, as images/sec on the card, through the multi-step
dispatch the runner uses (``train/loop.make_multi_step``: here a Python
loop of ``steps`` train steps, where the TPU package scans them inside one
jit).

``compute_dtype``: None is float32 with TF32 off, the port's parity mode
(the TPU package's Precision.HIGHEST); "float32" is float32 at the card's
default precision, cuDNN's TF32 (the counterpart of the TPU's default MXU
precision for float32 operands); "bfloat16" the mixed-precision training
mode.

Prints one JSON line. Env knobs: BENCH_TRAIN_BATCH (32), BENCH_TRAIN_STEPS
(4, steps a dispatch), BENCH_TRAIN_SIZE (416), BENCH_TRAIN_MODEL (yolov3),
BENCH_TRAIN_REMAT, BENCH_TRAIN_BN_STATS (twopass),
BENCH_TRAIN_TRUTH_ASSIGN (vectorized), BENCH_TRAIN_DEVICE (cuda; cpu runs
it on the CPU's host clock).
"""

import json
import os
import time

import numpy as np

TRUTH_SLOTS, TRUTHS = 30, 8     # truth rows an image, the valid ones


def batch_inputs(num_classes, steps, batch, size, seed=0):
    """(images uint8 (steps, B, S, S, 3), truths float32 (steps, B, 30, 5)):
    the reference's draws from ``np.random.default_rng(seed)``, 8 boxes an
    image (normalized cx, cy, w, h, class), the other rows zero."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (steps, batch, size, size, 3),
                          dtype=np.uint8)
    truths = np.zeros((steps, batch, TRUTH_SLOTS, 5), np.float32)
    truths[..., :TRUTHS, 0:2] = rng.uniform(0.2, 0.8, (steps, batch, TRUTHS,
                                                       2))
    truths[..., :TRUTHS, 2:4] = rng.uniform(0.05, 0.4, (steps, batch, TRUTHS,
                                                        2))
    truths[..., :TRUTHS, 4] = rng.integers(0, num_classes,
                                           (steps, batch, TRUTHS))
    return images, truths


def measure_train(model="yolov3", size=416, batch=32, steps=4,
                  compute_dtype="bfloat16", remat_every=None,
                  bn_stats="twopass", truth_assign="vectorized",
                  repeats=3, device="cuda"):
    """The first dispatch of ``steps`` steps, ended by a readback of the
    cost, is ``compile_s`` (here the warm-up: kernel loads and cuDNN's
    plans); then ``repeats`` dispatches, each ended by a readback, and
    their median. The reference's keys."""
    import torch
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.train import loop as L

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("measure_train runs on the card: "
                           "torch.cuda.is_available() is false")
    cfg = C.get_config(model, input_size=size)
    sched = L.darknet_lr_schedule(1e-3, burn_in=1000)
    tx = L.make_optimizer(sched)
    state = L.create_train_state(cfg, tx, seed=0, device=dev)
    cd = {None: None, "float32": torch.float32,
          "bfloat16": torch.bfloat16}[compute_dtype]
    multi = L.make_multi_step(cfg, tx, steps, compute_dtype=cd,
                              tf32=compute_dtype == "float32",
                              remat_every=remat_every, bn_stats=bn_stats,
                              truth_assign=truth_assign)
    images, truths = batch_inputs(cfg.num_classes, steps, batch, size)
    images = torch.from_numpy(images).to(dev)
    truths = torch.from_numpy(truths).to(dev)

    t0 = time.perf_counter()
    state, metrics = multi(state, images, truths)
    cost = metrics["cost"].cpu().numpy()
    compile_s = time.perf_counter() - t0

    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state, metrics = multi(state, images, truths)
        cost = metrics["cost"].cpu().numpy()
        samples.append(time.perf_counter() - t0)
    dt = float(np.median(samples))
    return {
        "train_images_per_sec": round(steps * batch / dt, 1),
        "step_ms": round(dt / steps * 1e3, 2),
        "spread_img_per_sec": [round(steps * batch / s, 1) for s in samples],
        "loss_finite": bool(np.isfinite(cost.sum())),
        "compile_s": round(compile_s, 1),
        "batch": batch, "steps_per_dispatch": steps,
        "model": model, "size": size,
        "compute_dtype": compute_dtype or "float32-exact",
        "remat_every": remat_every,
        "bn_stats": bn_stats,
        "truth_assign": truth_assign,
    }


def device_name(device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or "cpu"."""
    import torch
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main():
    device = os.environ.get("BENCH_TRAIN_DEVICE", "cuda")
    res = measure_train(
        model=os.environ.get("BENCH_TRAIN_MODEL", "yolov3"),
        size=int(os.environ.get("BENCH_TRAIN_SIZE", "416")),
        batch=int(os.environ.get("BENCH_TRAIN_BATCH", "32")),
        steps=int(os.environ.get("BENCH_TRAIN_STEPS", "4")),
        remat_every=(int(os.environ["BENCH_TRAIN_REMAT"])
                     if os.environ.get("BENCH_TRAIN_REMAT") else None),
        bn_stats=os.environ.get("BENCH_TRAIN_BN_STATS", "twopass"),
        truth_assign=os.environ.get("BENCH_TRAIN_TRUTH_ASSIGN", "vectorized"),
        device=device)
    res["device"] = device_name(device)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
