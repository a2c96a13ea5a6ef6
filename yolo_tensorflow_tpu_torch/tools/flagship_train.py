"""Flagship-scale training on the card: full yolov3 (Darknet-53 FPN) at 416
on the hard 12-class synthetic task, through the port's command line end
to end.

The port's counterpart of tools/flagship_train.py, with the same phases,
seeds (11 for the training scenes, 777 for the held-out ones), defaults and
result JSON:

  1. the task rendered to disk in darknet layout: images/*.npy (RGB uint8,
     read with np.load: the card's host has no cv2), labels/*.txt ('cls cx
     cy w h' rows) and the train/valid list files;
  2. a .cfg emitted by ``io.cfg.specs_to_cfg`` with the LR drops scaled to
     the run (x0.1 at 80 % and 90 % of ``--steps``), and an unscaled
     ``-qat`` cfg for the fine-tune;
  3. ``cli train --cfg --npy-images`` with --bf16 --eval-every --save-every
     --cache-images, interrupted at the halfway checkpoint and resumed in a
     fresh process;
  4. ``--qat`` resuming the float checkpoint (fresh scales), which ships
     ckpts/int8-qat.npz;
  5. the suite on the held-out scenes, from the float checkpoint of record
     (ckpt-<steps>.npz, not the QAT leg's later one): float, flip-TTA in
     darknet's and the corrected mode, int8 PTQ (calibrated on 64 training
     scenes) and int8 QAT, through ``eval.batched.detect_images``.

Usage:  python -m yolo_tensorflow_tpu_torch.tools.flagship_train
            [--root DIR] [--steps 6000] [--batch 32] [--n-train 4000]
            [--n-val 200] [--qat-steps 800] [--device cuda]

``--root`` defaults to the package's ignored ``_build/flagship12``.
FLAGSHIP_SIZE and FLAGSHIP_MODEL (environment) drive the same phases at
another size and model.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from yolo_tensorflow_tpu_torch.tools.synthetic_train_demo import (
    HARD_CLASSES, make_scene, score_detector, scene_truth)

# flagship scale; FLAGSHIP_SIZE/FLAGSHIP_MODEL drive the same phases tiny
SIZE = int(os.environ.get("FLAGSHIP_SIZE", "416"))
MODEL = os.environ.get("FLAGSHIP_MODEL", "yolov3")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# runs write under the package's ignored build directory unless --root
WORK = os.path.join(REPO, "yolo_tensorflow_tpu_torch", "_build")


def write_scene(root, name, img, boxes):
    """One scene in darknet layout: images/<name>.npy and labels/<name>.txt.
    Returns the image's absolute path."""
    p = os.path.abspath(os.path.join(root, "images", name + ".npy"))
    np.save(p, img)
    with open(os.path.join(root, "labels", name + ".txt"), "w") as f:
        for cx, cy, w, h, c in boxes:
            f.write(f"{int(c)} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}\n")
    return p


def write_detection_set(root, splits, size):
    """Render hard scenes for each (split, n, seed) of ``splits`` into
    ``root`` (darknet layout, list files <split>.txt) and the names file.
    Returns ({split: list path}, names path)."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    lists = {}
    for split, n, seed in splits:
        rng = np.random.default_rng(seed)
        paths = []
        t0 = time.time()
        for i in range(n):
            img, boxes = make_scene(rng, hard=True, size=size)
            paths.append(write_scene(root, f"{split}_{i:05d}", img, boxes))
        lf = os.path.join(root, split + ".txt")
        with open(lf, "w") as f:
            f.write("\n".join(paths) + "\n")
        lists[split] = lf
        print(f"wrote {n} {split} scenes in {time.time()-t0:.0f}s",
              flush=True)
    names = os.path.join(root, "shapes.names")
    with open(names, "w") as f:
        f.write("\n".join(HARD_CLASSES) + "\n")
    return lists, names


def gen_dataset(root, n_train, n_val, size=SIZE):
    """Render the task to disk in darknet layout. Returns (lists, names)."""
    return write_detection_set(root, (("train", n_train, 11),
                                      ("valid", n_val, 777)), size)


def emit_cfg(root, size=SIZE, max_batches=None, suffix=""):
    """The 12-class .cfg the CLI trains from (specs_to_cfg).

    ``max_batches`` scales the steps-policy LR drops (x0.1 at 80 %/90 %) to
    the run length, the stock cfg's proportions; without it a 6000-step
    run never reaches the stock boundaries (400000/450000) and trains at
    constant 1e-3. The QAT leg uses its own unscaled cfg (suffix '-qat'):
    it fine-tunes past max_batches at --lr 1e-4, where a fired x0.01 would
    freeze it at 1e-6."""
    import dataclasses
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io.cfg import specs_to_cfg
    cfg = dataclasses.replace(C.get_config(MODEL, input_size=size),
                              custom_classes=HARD_CLASSES)
    text = specs_to_cfg(cfg, batch=32, max_batches=max_batches)
    path = os.path.join(root, f"{MODEL}-shapes12{suffix}.cfg")
    with open(path, "w") as f:
        f.write(text)
    return path, cfg


def train_args(root, cfg_path, *, batch, eval_every, save_every, device,
               lr="1e-3", burn_in=500):
    """The recipe's ``cli train`` arguments on the task under ``root``, all
    but --steps (and the QAT leg's --qat)."""
    return ["train", "--cfg", cfg_path, "--npy-images",
            "--list", os.path.join(root, "train.txt"),
            "--val-list", os.path.join(root, "valid.txt"),
            "--names", os.path.join(root, "shapes.names"),
            "--ckpt-dir", os.path.join(root, "ckpts"),
            "--batch-size", str(batch), "--bf16",
            "--eval-every", str(eval_every), "--save-every", str(save_every),
            # decoded frames cached after the first epoch (4000 x 416^2 x 3
            # ~ 2.1 GB, within the loader's 4 GiB budget)
            "--cache-images", "--log-every", "100",
            "--lr", lr, "--burn-in", str(burn_in), "--device", device]


def run_cli(args_list, log_path):
    """One command-line invocation in a fresh process (so resume is a real
    cross-process restore), its output appended to ``log_path``. Returns
    its seconds; raises SystemExit if it fails."""
    cmd = [sys.executable, "-m", "yolo_tensorflow_tpu_torch.cli"] + args_list
    print(f"$ {' '.join(cmd)}", flush=True)
    t0 = time.time()
    with open(log_path, "a") as lf:
        lf.write(f"\n$ {' '.join(cmd)}\n")
        lf.flush()
        r = subprocess.run(cmd, stdout=lf, stderr=subprocess.STDOUT,
                           cwd=REPO)
    dt = time.time() - t0
    print(f"  -> exit {r.returncode} in {dt:.0f}s (log: {log_path})",
          flush=True)
    if r.returncode != 0:
        with open(log_path) as lf:
            print(lf.read()[-4000:])
        raise SystemExit(f"CLI phase failed: {' '.join(args_list[:4])}")
    return dt


def load_valid(root):
    """Held-out scenes + ground truth from the on-disk valid split (the
    files the in-training --eval-every read)."""
    from yolo_tensorflow_tpu_torch.data.datasets import load_darknet_list
    samples = load_darknet_list(os.path.join(root, "valid.txt"))
    imgs, gts = [], []
    for s in samples:
        img = np.load(s.image_path)
        h, w = img.shape[:2]
        assert h == w, s.image_path
        gts.append(scene_truth(s.boxes, w))
        imgs.append(img)
    return imgs, gts


def eval_suite(cfg, specs, params, batch_stats, root, *, device="cuda",
               log=print):
    """The five legs on the held-out scenes: {leg: mAP@0.5}."""
    from yolo_tensorflow_tpu_torch.cli import _load_npz_params
    from yolo_tensorflow_tpu_torch.io.weights import fold_params
    from yolo_tensorflow_tpu_torch.ops import quant as Q
    from yolo_tensorflow_tpu_torch.pipeline import Detector

    imgs, gts = load_valid(root)
    folded = fold_params(params, batch_stats, cfg.bn_eps)
    nms = dict(conf_threshold=0.3, iou_threshold=0.45, max_detections=20)
    results = {}

    def run(label, **kw):
        det = Detector(cfg, specs=specs, device=device, **nms, **kw)
        out, dt = score_detector(det, imgs, gts, len(HARD_CLASSES),
                                 batch_size=8)
        log(f"{label}: mAP@0.5 = {out['map']:.4f} "
            f"({len(imgs)/dt:.0f} img/s batched eval)")
        results[label] = round(float(out["map"]), 4)

    run("float bf16", params=folded)
    for mode in ("darknet", "corrected"):
        run(f"flip-TTA[{mode}]", params=folded, tta=True, tta_mode=mode)

    # PTQ: calibrate on training scenes read back from disk (the production
    # calibration source), quantize, re-evaluate
    with open(os.path.join(root, "train.txt")) as f:
        calib_paths = [line.strip() for line in f][:64]
    calib_imgs = np.stack([np.load(p) for p in calib_paths])
    calib = [calib_imgs[i:i + 8] for i in range(0, len(calib_imgs), 8)]
    scales = Q.calibrate_activations(specs, folded, calib, cfg=cfg,
                                     device=device)
    run("int8 PTQ", params=Q.quantize_params(specs, folded, scales))

    # QAT: the int8-qat.npz the --qat phase shipped
    qat_npz = os.path.join(root, "ckpts", "int8-qat.npz")
    if os.path.exists(qat_npz):
        run("int8 QAT", params=_load_npz_params(qat_npz))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(WORK, "flagship12"))
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n-train", type=int, default=4000)
    ap.add_argument("--n-val", type=int, default=200)
    ap.add_argument("--qat-steps", type=int, default=800)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.makedirs(root, exist_ok=True)
    log_path = os.path.join(root, "train.log")
    t_legs = {}

    t0 = time.time()
    if not os.path.exists(os.path.join(root, "valid.txt")):
        gen_dataset(root, args.n_train, args.n_val)
    cfg_path, _ = emit_cfg(root, max_batches=args.steps)
    qat_cfg_path, _ = emit_cfg(root, suffix="-qat")
    t_legs["data"] = round(time.time() - t0, 1)
    shared = dict(root=root, batch=args.batch, eval_every=args.eval_every,
                  save_every=args.save_every, device=args.device)
    # train-half: to the halfway point, then the process exits (the
    # interruption); train-full: a fresh process resumes and finishes
    for leg, upto in (("train-half", args.steps // 2),
                      ("train-full", args.steps)):
        t_legs[leg] = round(run_cli(
            train_args(cfg_path=cfg_path, **shared) + ["--steps", str(upto)],
            log_path), 1)
    # float -> QAT fine-tune from the float checkpoint, on the
    # unscaled-schedule cfg (constant 1e-4 past the train boundaries)
    t_legs["qat"] = round(run_cli(
        train_args(cfg_path=qat_cfg_path, lr="1e-4", burn_in=20, **shared)
        + ["--steps", str(args.steps + args.qat_steps), "--qat"],
        log_path), 1)
    print(json.dumps({"leg_seconds": t_legs}), flush=True)

    # final suite: the FLOAT checkpoint of record (the QAT phase saved
    # later steps; the float eval wants the step-<steps> state)
    import dataclasses
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.io import checkpoint as ckpt
    cfg = dataclasses.replace(C.get_config(MODEL, input_size=SIZE),
                              custom_classes=HARD_CLASSES)
    specs = C.build_specs(cfg)
    ckpt_dir = os.path.join(root, "ckpts")
    target = os.path.join(ckpt_dir, f"ckpt-{args.steps}.npz")
    params, stats, step = ckpt.load_train_params(
        target if os.path.exists(target) else ckpt_dir)
    print(f"evaluating float checkpoint at step {step}", flush=True)
    t0 = time.time()
    results = eval_suite(cfg, specs, params, stats, root, device=args.device)
    print(f"suite in {time.time() - t0:.1f}s", flush=True)
    out = {"flagship": f"{MODEL}-{SIZE} hard12", "step": int(step),
           "results": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
