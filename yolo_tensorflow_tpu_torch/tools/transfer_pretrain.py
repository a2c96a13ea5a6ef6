"""Backbone-pretrain transfer on the card: a darknet19 classifier ->
``partial`` cutoff -> yolov2 detector fine-tune, A/B'd against from-scratch
at equal steps.

The port's counterpart of tools/transfer_pretrain.py (darknet's canonical
recipe: pretrain a classifier backbone, truncate it with ``partial``,
src/parser.c:992 save_weights_upto, into files like darknet19_448.conv.23,
and load that prefix as the detector's init, examples/detector.c:16-23),
with the same phases, path tokens, cutoff and seeds (21 and 787 for the
crops, 31 and 797 for the scenes). Every phase runs the port's command line
in a fresh process on .npy images (``--npy-images``; no cv2):

  1. a 12-class single-shape classification set, crops from the same
     scene distribution resized to ``TRANSFER_CLF_SIZE``, labelled by the
     collision-free path tokens c00x..c11x (fill_truth's strstr
     convention, src/data.c:504, would match circle inside semicircle);
  2. a darknet19 classifier .cfg emitted and trained; held-out top-1;
  3. ``export-darknet --ckpt`` then ``partial --upto 23``;
  4. the yolov2 12-class detector trained twice at equal steps on the
     same scenes: (a) from scratch, (b) ``--weights backbone
     --partial-weights``; ``--eval-every`` gives the mAP curve;
  5. the A/B table (mAP@0.5 at each evaluation, scratch vs transfer).

The crops are resized with ``dream.resize_linear`` (cv2's INTER_LINEAR in
float32) and rounded to uint8; cv2's uint8 resize works in fixed point, so
a crop's pixels may sit one level from cv2's.

Usage:  python -m yolo_tensorflow_tpu_torch.tools.transfer_pretrain
            [--root DIR] [--clf-steps 1500] [--det-steps 1500]
            [--eval-every 250] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np

from yolo_tensorflow_tpu_torch.tools.flagship_train import (
    WORK, run_cli, write_detection_set)
from yolo_tensorflow_tpu_torch.tools.synthetic_train_demo import (
    HARD_CLASSES, make_scene)

# full scale; the environment drives the same phases tiny
CLF_SIZE = int(os.environ.get("TRANSFER_CLF_SIZE", "224"))
DET_SIZE = int(os.environ.get("TRANSFER_DET_SIZE", "416"))
CUTOFF = 23             # darknet19_448.conv.23's layer cutoff
# collision-free path-label tokens, index-aligned with HARD_CLASSES
CLF_TOKENS = tuple(f"c{i:02d}x" for i in range(len(HARD_CLASSES)))


def resize_crop(crop, size):
    """A uint8 crop resized to size x size: cv2.resize(INTER_LINEAR)'s
    float32 arithmetic (``dream.resize_linear``), rounded."""
    from yolo_tensorflow_tpu_torch.dream import resize_linear
    out = resize_linear(crop.astype(np.float32), size, size)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def scene_crops(rng, n):
    """(crop, class) pairs until ``n``: a square crop with context padding
    around each object of hard scenes at DET_SIZE, resized to CLF_SIZE."""
    i = 0
    while i < n:
        img, boxes = make_scene(rng, hard=True, size=DET_SIZE)
        for cx, cy, w, h, c in boxes:
            if i >= n:
                break
            s = int(max(w, h) * DET_SIZE * 1.6)
            x0 = int(cx * DET_SIZE - s / 2)
            y0 = int(cy * DET_SIZE - s / 2)
            x0 = max(0, min(x0, DET_SIZE - s))
            y0 = max(0, min(y0, DET_SIZE - s))
            if s < 12 or x0 < 0 or y0 < 0:
                continue
            yield resize_crop(img[y0:y0 + s, x0:x0 + s], CLF_SIZE), int(c)
            i += 1


def gen_classifier_set(root, n_train, n_val):
    """Single-shape crops from the SAME scene distribution the detector
    trains on, labelled by the darknet path convention."""
    for split, n, seed in (("train", n_train, 21), ("valid", n_val, 787)):
        d = os.path.join(root, "clf", split)
        os.makedirs(d, exist_ok=True)
        paths = []
        for i, (crop, c) in enumerate(scene_crops(np.random.default_rng(seed),
                                                  n)):
            p = os.path.abspath(os.path.join(
                d, f"{CLF_TOKENS[c]}_{i:05d}.npy"))
            np.save(p, crop)
            paths.append(p)
        with open(os.path.join(root, f"clf_{split}.txt"), "w") as f:
            f.write("\n".join(paths) + "\n")
    tokens = os.path.join(root, "clf.names")
    with open(tokens, "w") as f:
        f.write("\n".join(CLF_TOKENS) + "\n")
    return tokens


def gen_detection_set(root, n_train, n_val):
    """Detection scenes in darknet layout (as flagship_train's)."""
    write_detection_set(root, (("train", n_train, 31), ("valid", n_val, 797)),
                        DET_SIZE)


def emit_cfg(root, model, size, names, fname, max_batches=None):
    """max_batches scales the steps-policy LR drops to the run length
    (x0.1 at 80 %/90 %, the stock cfg's proportions)."""
    import dataclasses
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io.cfg import specs_to_cfg
    cfg = dataclasses.replace(C.get_config(model, input_size=size),
                              custom_classes=tuple(names))
    path = os.path.join(root, fname)
    with open(path, "w") as f:
        f.write(specs_to_cfg(cfg, batch=32, max_batches=max_batches))
    return path


def parse_curve(log_path, marker):
    """[(step, value)] for 'step N: val <marker> = V' lines."""
    pat = re.compile(rf"step (\d+): val {re.escape(marker)} = ([0-9.]+)")
    with open(log_path) as f:
        return [(int(m.group(1)), float(m.group(2)))
                for m in (pat.search(line) for line in f) if m]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(WORK, "transfer12"))
    ap.add_argument("--clf-steps", type=int, default=1500)
    ap.add_argument("--det-steps", type=int, default=1500)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n-train", type=int, default=2000)
    ap.add_argument("--n-val", type=int, default=160)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--skip-clf", action="store_true",
                    help="backbone file already exists: A/B only")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.makedirs(root, exist_ok=True)
    backbone = os.path.join(root, f"darknet19-shapes.conv.{CUTOFF}")
    dev = ["--device", args.device]
    out = {}
    legs_s = {}

    # -- phase 1+2: classifier pretrain --------------------------------------
    clf_log = os.path.join(root, "clf.log")
    if not args.skip_clf:
        t0 = time.time()
        if not os.path.exists(os.path.join(root, "clf_valid.txt")):
            gen_classifier_set(root, args.n_train, max(args.n_val, 120))
        legs_s["clf_data"] = round(time.time() - t0, 1)
        clf_cfg = emit_cfg(root, "darknet19-classifier", CLF_SIZE,
                           CLF_TOKENS, "darknet19-shapes12.cfg",
                           max_batches=args.clf_steps)
        legs_s["classifier"] = round(run_cli(
            ["train", "--cfg", clf_cfg, "--npy-images",
             "--list", os.path.join(root, "clf_train.txt"),
             "--val-list", os.path.join(root, "clf_valid.txt"),
             "--names", os.path.join(root, "clf.names"),
             "--ckpt-dir", os.path.join(root, "clf_ckpts"),
             "--batch-size", str(args.batch), "--bf16",
             "--cache-images",
             "--steps", str(args.clf_steps), "--lr", "1e-3",
             "--burn-in", "200",
             "--eval-every", str(args.eval_every),
             "--save-every", str(args.clf_steps),
             "--log-every", "100"] + dev, clf_log), 1)
        out["clf_top1_curve"] = parse_curve(clf_log, "top-1")

        # export the trained classifier to .weights, then `partial` it —
        # the save_weights_upto workflow (src/parser.c:992)
        stem = os.path.join(root, "darknet19-shapes")
        run_cli(["export-darknet", "--cfg", clf_cfg,
                 "--ckpt", os.path.join(root, "clf_ckpts"),
                 "--out", stem], clf_log)
        run_cli(["partial", "--cfg", clf_cfg,
                 "--weights", stem + ".weights",
                 "--upto", str(CUTOFF), "--out", backbone], clf_log)

    # -- phase 4: detector A/B ----------------------------------------------
    t0 = time.time()
    if not os.path.exists(os.path.join(root, "valid.txt")):
        gen_detection_set(root, args.n_train, args.n_val)
    legs_s["det_data"] = round(time.time() - t0, 1)
    det_cfg = emit_cfg(root, "yolov2", DET_SIZE, HARD_CLASSES,
                       "yolov2-shapes12.cfg", max_batches=args.det_steps)
    common = ["train", "--cfg", det_cfg, "--npy-images",
              "--list", os.path.join(root, "train.txt"),
              "--val-list", os.path.join(root, "valid.txt"),
              "--names", os.path.join(root, "shapes.names"),
              "--batch-size", str(args.batch), "--bf16", "--cache-images",
              "--steps", str(args.det_steps), "--lr", "1e-3",
              "--burn-in", "200",
              "--eval-every", str(args.eval_every),
              "--save-every", str(args.det_steps),
              "--log-every", "100"] + dev
    legs = {}
    for leg, extra in (
            ("scratch", []),
            ("transfer", ["--weights", backbone, "--partial-weights"])):
        log = os.path.join(root, f"det_{leg}.log")
        legs_s[leg] = round(run_cli(
            common + ["--ckpt-dir", os.path.join(root, f"det_{leg}")]
            + extra, log), 1)
        legs[leg] = dict(parse_curve(log, "mAP@0.5"))
        out[f"det_{leg}_map_curve"] = sorted(legs[leg].items())
    out["leg_seconds"] = legs_s

    steps = sorted(set(legs["scratch"]) & set(legs["transfer"]))
    print(f"\n=== transfer A/B: yolov2-{DET_SIZE} hard12, mAP@0.5 at "
          "equal steps ===")
    print(f"{'step':>6} {'scratch':>9} {'transfer':>9} {'delta':>8}")
    for s in steps:
        a, b = legs["scratch"][s], legs["transfer"][s]
        print(f"{s:>6} {a:>9.4f} {b:>9.4f} {b - a:>+8.4f}")
    out["table"] = [
        {"step": s, "scratch": legs["scratch"][s],
         "transfer": legs["transfer"][s],
         "delta": round(legs["transfer"][s] - legs["scratch"][s], 4)}
        for s in steps]
    with open(os.path.join(root, "transfer_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"transfer_ab": out["table"]}))
    return out


if __name__ == "__main__":
    main()
