"""The trainer on one card: the port's counterpart of
yolo_tensorflow_tpu/train/runner.py (examples/detector.c:6 train_detector,
examples/classifier.c train_classifier). Threaded data loading overlapped
with device steps, multi-scale resizes every 10 batches, periodic
checkpoints and resume, per-step Region-style stat lines.

    run_training(args)                     # argparse.Namespace
    run_training(args, read_fn=decode)     # images from decode(path)

``args`` carries the TPU package's fields: model or cfg (+ names), list,
weights (+ partial_weights), ckpt_dir, batch_size, steps, lr, burn_in,
input_size, multiscale, bf16, bn_stats / bn_onepass, cache_images,
save_every, log_every; and ``device`` ("cuda" unless the caller asks for
the CPU). ``read_fn`` (path -> RGB uint8 (H, W, 3)) replaces the loader's
cv2 decode; on a host without cv2 it is how images get in, and the
training pixels then go through the native kernel (YOLO_NATIVE_LOADER=1,
``data/native.py``).

``val_list`` with ``eval_every``: every eval_every steps the state is
folded and scored on the first 200 validation samples, read through
``read_fn`` as the training images are: mAP@0.5 for a detector
(``evaluate_model``, the stretch Detector, which needs cv2), top-1 for a
classifier (``evaluate_classifier``, mode 'crop': the resize runs on the
device). One Detector or Classifier serves every round, its network's
parameters swapped.

Raise NotImplementedError before any step: more than one data or spatial
shard or a distributed coordinator (ROADMAP.md, Queue 1 item 10), QAT
(item 13) and rematerialization (remat_every, item 9).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

MULTISCALE_SIZES = tuple(range(320, 640, 32))  # 320..608 (detector.c:63-71)


def aug_from_cfg(net: dict, h0: dict, head: int) -> dict:
    """DetectionLoader kwargs from a parsed cfg (get_base_args reads [net]
    saturation/exposure/hue, src/network.c:45-58; train_detector reads
    jitter and max boxes from the head section, examples/detector.c:45-52),
    with the C's defaults ([yolo]/[detection] max=90, [region] max=30,
    jitter .2)."""
    return dict(
        jitter=float(h0.get("jitter", 0.2)),
        hue=float(net.get("hue", 0.0)),
        sat=float(net.get("saturation", 1.0)),
        exposure=float(net.get("exposure", 1.0)),
        max_boxes=int(h0.get("max", 30 if head == 2 else 90)),
    )


def _folded(cfg, state) -> dict:
    """The train state's parameters folded into the serving form. A QAT
    state would score its int8 export, which is not ported."""
    from yolo_tensorflow_tpu_torch.io.weights import fold_params
    if getattr(state, "qat_scales", None):
        raise NotImplementedError("evaluating a QAT state (its int8 export) "
                                  "is not ported (ROADMAP.md, Queue 1 item "
                                  "13: ops/qat.py)")
    return fold_params(state.params, state.batch_stats, cfg.bn_eps)


def _swap_params(owner, folded):
    """Give a cached Detector or Classifier the newly folded parameters: a
    new network of its specs, device and dtype (the TPU package swaps the
    params argument of its jitted functions)."""
    from yolo_tensorflow_tpu_torch.models import engine
    owner.network = engine.Network(owner.specs, folded, device=owner.device,
                                   dtype=owner.network.dtype)


def evaluate_model(cfg, specs, state, samples, *, limit=0, conf=0.25,
                   detector_cache=None, batch_size=16, read_fn=None):
    """In-training mAP (validate_detector, examples/detector.c:364, folded
    into the loop) through the batched evaluation pipeline
    (eval/batched.evaluate_samples) and eval.map.evaluate_detections.
    ``detector_cache``: a list that keeps one Detector across rounds (the
    first call appends it, later calls load the new parameters into it).
    ``read_fn`` reads the images (default eval.batched.read_rgb)."""
    from yolo_tensorflow_tpu_torch.eval.batched import (evaluate_samples,
                                                        read_rgb)
    from yolo_tensorflow_tpu_torch.eval.map import evaluate_detections
    from yolo_tensorflow_tpu_torch.pipeline import Detector

    folded = _folded(cfg, state)
    if detector_cache:
        det = detector_cache[0]
        _swap_params(det, folded)
    else:
        det = Detector(cfg, params=folded, specs=specs,
                       device=_device_of(state.network),
                       conf_threshold=conf, max_detections=50)
        if detector_cache is not None:
            detector_cache.append(det)
    dets, gts, _, _ = evaluate_samples(det, samples, limit=limit,
                                       batch_size=batch_size,
                                       read_fn=read_fn or read_rgb)
    return evaluate_detections(dets, gts, cfg.num_classes)


def evaluate_classifier(cfg, state, samples, *, limit=0, specs=None,
                        classifier_cache=None, batch_size=32, read_fn=None):
    """Top-1 accuracy of the in-training classifier on data.datasets
    samples (the label in ``boxes[0, 4]``): eval/classify.
    validate_classifier in mode 'crop' (validate_classifier_crop's stretch,
    examples/classifier.c:170, on the device). ``classifier_cache`` as
    ``evaluate_model``'s ``detector_cache``."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.eval.batched import read_rgb
    from yolo_tensorflow_tpu_torch.eval.classify import validate_classifier
    from yolo_tensorflow_tpu_torch.pipeline import Classifier

    if specs is None:
        specs = C.build_specs(cfg)
    folded = _folded(cfg, state)
    if classifier_cache:
        clf = classifier_cache[0]
        _swap_params(clf, folded)
    else:
        clf = Classifier(cfg, params=folded, specs=specs,
                         device=_device_of(state.network))
        if classifier_cache is not None:
            classifier_cache.append(clf)
    if limit:
        samples = samples[:limit]
    pairs = [(smp.image_path, int(smp.boxes[0, 4])) for smp in samples]
    res = validate_classifier(clf, pairs, top_k=1, mode="crop",
                              batch_size=batch_size,
                              read_fn=read_fn or read_rgb)
    return res["top1"]


def _device_of(network) -> torch.device:
    return next(network.parameters()).device


def _not_ported(args):
    """Raise for an option the port does not run, naming its item."""
    if (getattr(args, "num_data", None) or 1) > 1 \
            or (getattr(args, "num_spatial", None) or 1) > 1 \
            or getattr(args, "coordinator", None):
        raise NotImplementedError(
            "data or spatial parallel and multi-host training are not "
            "ported (ROADMAP.md, Queue 1 item 10): run_training trains on "
            "one card")
    if getattr(args, "qat", False):
        raise NotImplementedError("QAT training is not ported (ROADMAP.md, "
                                  "Queue 1 item 13: ops/qat.py)")
    if getattr(args, "remat_every", None):
        raise NotImplementedError("remat_every: rematerialization is not "
                                  "ported (ROADMAP.md, Queue 1 item 9)")


def _model(args):
    """(cfg, specs or None, NetTrainOptions or None, loss kwargs, loader
    aug kwargs, cfg multi-scale) from --cfg or the registry."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.train import loop as T
    from yolo_tensorflow_tpu_torch.train import losses

    if not getattr(args, "cfg", None):
        if not getattr(args, "model", None):
            raise SystemExit("train needs --model or --cfg")
        overrides = {}
        if getattr(args, "input_size", None):
            overrides["input_size"] = args.input_size
        if getattr(args, "names", None):
            with open(args.names) as f:
                overrides["custom_classes"] = tuple(
                    line.strip() for line in f if line.strip())
        return C.get_config(args.model, **overrides), None, None, {}, {}, \
            False
    # arbitrary-cfg training: every hyperparameter from [net] and the head
    # section (parse_net_options src/parser.c:643, train_detector)
    from yolo_tensorflow_tpu_torch.io.cfg import parse_cfg_file
    cfg, specs = C.config_from_cfg(
        args.cfg, class_names_file=getattr(args, "names", None),
        name=os.path.splitext(os.path.basename(args.cfg))[0])
    _, net, heads = parse_cfg_file(args.cfg)
    h0 = heads[0] if heads else {}
    loss_kw, aug_kw = {}, {}
    if cfg.head != 0:
        aug_kw = aug_from_cfg(net, h0, cfg.head)
    if cfg.head == 3:
        loss_kw["ignore_thresh"] = float(h0.get("ignore_thresh", 0.5))
        loss_kw["truth_thresh"] = float(h0.get("truth_thresh", 1.0))
    elif cfg.head == 2:
        loss_kw["region_hyper"] = losses.RegionHyper.from_options(h0)
    elif cfg.head == 1:
        loss_kw["detection_hyper"] = losses.DetectionHyper.from_options(h0)
    # random=1 resizes only region and yolo heads (detector.c:63); a
    # [detection] section's random is v1's responsibility draw, read above
    multiscale = cfg.head in (2, 3) and bool(int(h0.get(
        "random", net.get("random", 0))))
    if getattr(args, "input_size", None):
        if cfg.head == 1:
            raise SystemExit("--input-size cannot override a v1 (FC-head) "
                             "cfg")
        cfg = dataclasses.replace(cfg, input_size=args.input_size)
    return (cfg, specs, T.NetTrainOptions.from_net(net), loss_kw, aug_kw,
            multiscale)


def _initial_params(args, cfg, specs):
    """Seeded darknet-form parameters (numpy seed 0), with a .weights file's
    layers over them when --weights is given (all of them, or with
    partial_weights the layers a truncated backbone holds)."""
    from yolo_tensorflow_tpu_torch.io import weights as W
    from yolo_tensorflow_tpu_torch.models import engine

    params, stats = engine.init_params(specs, cfg.input_size, 0)
    if not getattr(args, "weights", None):
        return params, stats
    partial = bool(getattr(args, "partial_weights", False))
    loaded, loaded_stats, _ = W.load_darknet_weights(
        specs, cfg.input_size, args.weights, fold=False,
        allow_partial=partial)
    if partial:
        print(f"loaded {len(loaded)} weighted layers from {args.weights} "
              f"(partial); {len(params) - len(loaded)} layers keep init")
    params.update(loaded)
    stats.update(loaded_stats)
    return params, stats


def run_training(args, *, read_fn=None):
    """Train as the TPU package's run_training does, on one card (module
    docstring). Prints "N training samples", a line every log_every steps,
    "saved <path>" at every checkpoint, "resumed from step N" when ckpt_dir
    holds one, and "done"."""
    from yolo_tensorflow_tpu_torch import config as C
    from yolo_tensorflow_tpu_torch.data.datasets import (
        load_classifier_list, load_darknet_list)
    from yolo_tensorflow_tpu_torch.data.loader import DetectionLoader
    from yolo_tensorflow_tpu_torch.io import checkpoint as ckpt
    from yolo_tensorflow_tpu_torch.train import loop as T

    _not_ported(args)
    device = torch.device(getattr(args, "device", None) or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_training on 'cuda' needs a CUDA device and "
                           "torch.cuda.is_available() is false")
    cfg, specs, net_opts, loss_kw, aug_kw, cfg_multiscale = _model(args)
    specs = C.build_specs(cfg) if specs is None else specs
    val_list = getattr(args, "val_list", None)
    if cfg.head == 0:
        # labels from class-name substring match on the path (fill_truth)
        samples = load_classifier_list(args.list, cfg.classes)
        val_samples = (load_classifier_list(val_list, cfg.classes)
                       if val_list else None)
    else:
        samples = load_darknet_list(args.list)
        val_samples = load_darknet_list(val_list) if val_list else None
    print(f"{len(samples)} training samples")
    eval_every = getattr(args, "eval_every", 0) or 0
    eval_cache = []     # the one Detector or Classifier of every round

    # CLI flags override the cfg's [net] options, which override the
    # registry defaults (get_current_rate, src/network.c:90)
    lr_flag = getattr(args, "lr", None)
    burn_flag = getattr(args, "burn_in", None)
    steps_flag = getattr(args, "steps", None)
    batch_flag = getattr(args, "batch_size", None)
    if net_opts is not None:
        eff = dataclasses.replace(
            net_opts,
            learning_rate=(lr_flag if lr_flag is not None
                           else net_opts.learning_rate),
            burn_in=burn_flag if burn_flag is not None else net_opts.burn_in)
        total_steps = (steps_flag if steps_flag is not None
                       else (eff.max_batches or 500200))
        batch_size = batch_flag if batch_flag is not None else max(eff.batch,
                                                                   1)
        tx = T.optimizer_from_net(eff, batch=batch_size)
        print(f"[net] lr {eff.learning_rate} policy {eff.policy} "
              f"burn_in {eff.burn_in} momentum {eff.momentum} "
              f"decay {eff.decay} max_batches {eff.max_batches} "
              f"batch {batch_size}"
              + (f" adam B1={eff.B1} B2={eff.B2} eps={eff.eps}"
                 if eff.adam else ""))
    else:
        tx = T.make_optimizer(T.darknet_lr_schedule(
            lr_flag if lr_flag is not None else 1e-3,
            burn_in=burn_flag if burn_flag is not None else 1000))
        total_steps = steps_flag if steps_flag is not None else 500200
        batch_size = batch_flag if batch_flag is not None else 64

    params, stats = _initial_params(args, cfg, specs)
    if any(getattr(sp, "bn", False) for sp in specs) and not stats:
        raise ValueError("training needs unfolded BN weights")
    state = T.create_train_state(cfg, tx, specs=specs, device=device,
                                 params=params, batch_stats=stats)
    del params, stats
    restored, start_step = ckpt.restore_train_state(state, args.ckpt_dir)
    if restored is not None:
        state = restored
        print(f"resumed from step {start_step}")

    multiscale = bool(getattr(args, "multiscale", False)) or cfg_multiscale
    if multiscale and cfg.head == 1:
        raise SystemExit("--multiscale is incompatible with v1 (FC-head) "
                         "models: the dense layer fixes the input size")
    loader_kw = dict(aug_kw)
    if read_fn is not None:
        loader_kw["read_fn"] = read_fn
    loader = DetectionLoader(samples, batch_size, cfg.input_size,
                             train=True,
                             cache_images=bool(getattr(args, "cache_images",
                                                       False)),
                             **loader_kw)
    if len(loader) == 0:
        raise ValueError(f"{len(samples)} samples make no batch of "
                         f"{batch_size}")
    bn_stats = getattr(args, "bn_stats", None) or (
        "onepass" if getattr(args, "bn_onepass", False) else "twopass")
    compute_dtype = torch.bfloat16 if getattr(args, "bf16", False) else None
    steps = {}          # one step per input size (at most 10 with
                        # multi-scale)

    def step_for(size):
        if size not in steps:
            steps[size] = T.make_train_step(
                cfg, tx, input_size=size, specs=specs,
                compute_dtype=compute_dtype, bn_stats=bn_stats, **loss_kw)
        return steps[size]

    rng = np.random.default_rng(1)
    size = cfg.input_size
    step_i = start_step
    t_last = time.time()
    while step_i < total_steps:
        for images, truths in loader.epoch():
            if multiscale and step_i % 10 == 0:
                size = int(rng.choice(MULTISCALE_SIZES))
                loader.set_size(size)
            if cfg.head == 0:
                truths = truths[:, 0, 4].astype(np.int32)
            im = torch.from_numpy(images).to(device)
            tr = torch.from_numpy(np.asarray(truths, np.float32)).to(device)
            state, metrics = step_for(images.shape[1])(state, im, tr)
            step_i += 1
            if step_i % args.log_every == 0:
                dt = (time.time() - t_last) / args.log_every
                t_last = time.time()
                if cfg.head == 0:
                    extra = f"acc {float(metrics['accuracy']):.3f}"
                else:
                    extra = (f"avg_iou {float(metrics['avg_iou']):.3f} "
                             f"obj {float(metrics['avg_obj']):.3f}")
                print(f"step {step_i}: cost {float(metrics['cost']):.3f} "
                      f"{extra} {batch_size / dt:.1f} img/s size "
                      f"{images.shape[1]}", flush=True)
            if step_i % args.save_every == 0:
                path = ckpt.save_train_state(state, args.ckpt_dir, step_i)
                print(f"saved {path}")
            if val_samples and eval_every and step_i % eval_every == 0:
                if cfg.head == 0:
                    acc = evaluate_classifier(
                        cfg, state, val_samples, limit=200, specs=specs,
                        classifier_cache=eval_cache, read_fn=read_fn)
                    print(f"step {step_i}: val top-1 = {acc:.4f}",
                          flush=True)
                else:
                    m = evaluate_model(cfg, specs, state, val_samples,
                                       limit=200, detector_cache=eval_cache,
                                       read_fn=read_fn)
                    print(f"step {step_i}: val mAP@0.5 = {m['map']:.4f} "
                          f"({m['num_classes_evaluated']} classes)",
                          flush=True)
            if step_i >= total_steps:
                break
    ckpt.save_train_state(state, args.ckpt_dir, step_i)
    print("done")
    return state
