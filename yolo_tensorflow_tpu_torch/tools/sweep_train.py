"""The training-throughput sweep on the card, the port's counterpart of
tools/sweep_train.py.

One process, one card, one methodology: every cell is
``tools/bench_train.measure_train`` (the full darknet step: train-mode
forward, loss, backward, SGD/momentum + decay update, running BN
statistics, ``steps`` steps a dispatch, a readback of the cost after each
dispatch), yolov3-416 in bf16. Three axes:

  1. the batch sweep at the default options (twopass BN, the vectorized
     truth assignment, SWEEP_STEPS steps a dispatch), one number a batch:
     the knee is the batch of the most img/s;
  2. steps a dispatch at the knee, 4 against 12: ``make_multi_step`` is a
     Python loop here, so the two differ by what the readback after a
     dispatch costs a step;
  3. the BN-statistics and truth-assignment options at the knee (twopass /
     onepass / onepass_bf16 / ghost32, scan / vectorized) and the two
     that should help most together.

Usage:  python -m yolo_tensorflow_tpu_torch.tools.sweep_train
            [device [model [size]]]
(defaults cuda yolov3 416; on the CPU only at small sizes and batches).
Env: SWEEP_BATCHES="32,64,96,128,160,192", SWEEP_STEPS=4. Prints a line a
cell, then one JSON line.
"""

import json
import os
import sys

from yolo_tensorflow_tpu_torch.tools.bench_train import (device_name,
                                                         measure_train)


def main(device="cuda", model="yolov3", size=416):
    batches = [int(b) for b in os.environ.get(
        "SWEEP_BATCHES", "32,64,96,128,160,192").split(",")]
    steps = int(os.environ.get("SWEEP_STEPS", "4"))
    rows = []

    def run(tag, **kw):
        r = measure_train(model=model, size=size, compute_dtype="bfloat16",
                          device=device, **kw)
        rows.append((tag, r))
        print(f"{tag:<46} {r['step_ms']:>9.2f} ms/step "
              f"{r['train_images_per_sec']:>7.1f} img/s "
              f"(compile {r['compile_s']}s)", flush=True)
        return r

    print("== 1. batch sweep (twopass, scan, steps/dispatch = "
          f"{steps}) ==", flush=True)
    best = None
    for b in batches:
        r = run(f"batch {b}", batch=b, steps=steps)
        if best is None or r["train_images_per_sec"] > best[1]:
            best = (b, r["train_images_per_sec"])
    knee = best[0]

    print(f"\n== 2. dispatch amortization at batch {knee} ==", flush=True)
    run(f"batch {knee}, steps/dispatch 4", batch=knee, steps=4)
    run(f"batch {knee}, steps/dispatch 12", batch=knee, steps=12)

    print(f"\n== 3. levers at batch {knee} (steps/dispatch {steps}) ==",
          flush=True)
    for bs in ("twopass", "onepass", "onepass_bf16", "ghost32"):
        run(f"bn_stats={bs}", batch=knee, steps=steps, bn_stats=bs)
    for ta in ("scan", "vectorized"):
        run(f"truth_assign={ta}", batch=knee, steps=steps, truth_assign=ta)
    run("best levers combined (onepass + vectorized)", batch=knee,
        steps=steps, bn_stats="onepass", truth_assign="vectorized")

    print(json.dumps({
        "device": device_name(device),
        "knee_batch": knee,
        "results": {tag: r for tag, r in rows}}))


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(argv[0] if argv else "cuda",
         argv[1] if len(argv) > 1 else "yolov3",
         int(argv[2]) if len(argv) > 2 else 416)
