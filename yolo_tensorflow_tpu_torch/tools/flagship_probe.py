"""Where the flagship's in-loop mAP goes around its LR drops.

``flagship_train``'s in-training evaluation scores the first 200 held-out
scenes. This probe runs the same training (``cli train`` on the same cfg
and data with ``flagship_train.train_args``, in this process, one run with
no interruption, saved once at its end) and, at
every evaluation, also scores ``n_extra`` more held-out scenes (seed 778)
with the 200, and 400 training scenes: whether a move of the 200-scene
number is sampling noise (the larger set does not follow it) or the model
(it does; the training scenes then say whether it fits them better). With
``precise`` it also scores the larger set with the BN running statistics
replaced by the mean of the batch statistics of 16 batches of training
scenes (bf16 train-mode forwards, no augmentation), and prints the largest
distance, over every BN layer and channel, between the running mean and
that mean in units of its standard deviation: whether the running
statistics, and not the weights, carry a drop.

Usage:  python -m yolo_tensorflow_tpu_torch.tools.flagship_probe
            steps n_train n_val n_extra eval_every batch device root
            [stop [precise]]

``stop`` ends the run there (the cfg's LR drops stay those of ``steps``).

Prints "probe {json}" at every evaluation and "probe-curve [...]" at the
end; FLAGSHIP_SIZE and FLAGSHIP_MODEL as for ``flagship_train``.
"""

from __future__ import annotations

import json
import os
import sys
import time


def precise_stats(cfg, state, batches):
    """The mean over ``batches`` (uint8 (B, S, S, 3) arrays) of the
    network's bf16 train-mode batch statistics, {layer: {"mean", "var"}}."""
    import torch
    from yolo_tensorflow_tpu_torch.pipeline import normalize_images
    from yolo_tensorflow_tpu_torch.train.loop import tree_map
    total = None
    with torch.no_grad():
        for batch in batches:
            x = normalize_images(torch.as_tensor(batch).to(state.step.device),
                                 cfg)
            _, stats = state.network(x, torch.bfloat16, "twopass",
                                     cfg.bn_eps)
            total = stats if total is None else tree_map(
                lambda a, b: a + b, total, stats)
    return tree_map(lambda a: a / len(batches), total)


def stat_gap(running, precise, eps):
    """(largest |running mean - mean| / sqrt(var + eps) over every layer
    and channel, its layer)."""
    import torch
    worst, where = 0.0, None
    for key, st in precise.items():
        gap = float(((running[key]["mean"] - st["mean"]).abs()
                     / torch.sqrt(st["var"] + eps)).max())
        if gap > worst:
            worst, where = gap, key
    return worst, where


def main(argv=None):
    from yolo_tensorflow_tpu_torch import cli
    from yolo_tensorflow_tpu_torch.data.datasets import load_darknet_list
    from yolo_tensorflow_tpu_torch.tools import flagship_train as FT
    from yolo_tensorflow_tpu_torch.train import runner

    argv = sys.argv[1:] if argv is None else argv
    steps, n_train, n_val, n_extra, every, batch = (int(v) for v in argv[:6])
    device, root = argv[6], os.path.abspath(argv[7])
    stop = int(argv[8]) if len(argv) > 8 else steps
    precise = len(argv) > 9 and argv[9] == "precise"
    os.makedirs(root, exist_ok=True)
    t0 = time.time()
    FT.gen_dataset(root, n_train, n_val)
    FT.write_detection_set(root, (("extra", n_extra, 778),), FT.SIZE)
    with open(os.path.join(root, "valid_big.txt"), "w") as out:
        for split in ("valid", "extra"):
            with open(os.path.join(root, f"{split}.txt")) as f:
                out.write(f.read())
    cfg_path, _ = FT.emit_cfg(root, max_batches=steps)
    print(f"data {time.time() - t0:.1f} s", flush=True)
    big = load_darknet_list(os.path.join(root, "valid_big.txt"))
    train = load_darknet_list(os.path.join(root, "train.txt"))[:400]
    if precise:
        import numpy as np
        scenes = np.stack([np.load(smp.image_path) for smp in
                           load_darknet_list(os.path.join(
                               root, "train.txt"))[:16 * batch]])
        batches = [scenes[i:i + batch] for i in range(0, len(scenes), batch)]
    evaluate_model = runner.evaluate_model
    curve = []

    def evaluate(cfg, specs, state, samples, **kw):
        out = evaluate_model(cfg, specs, state, samples, **kw)
        more = dict(kw, limit=0)
        row = {"step": int(state.step), "val200": round(out["map"], 4),
               f"val{n_val + n_extra}": round(evaluate_model(
                   cfg, specs, state, big, **more)["map"], 4),
               f"train{len(train)}": round(evaluate_model(
                   cfg, specs, state, train, **more)["map"], 4)}
        if precise:
            stats = precise_stats(cfg, state, batches)
            row[f"val{n_val + n_extra}_preciseBN"] = round(evaluate_model(
                cfg, specs, state._replace(batch_stats=stats), big,
                **more)["map"], 4)
            gap, layer = stat_gap(state.batch_stats, stats, cfg.bn_eps)
            row["stat_gap"], row["stat_gap_layer"] = round(gap, 3), layer
        curve.append(row)
        print("probe " + json.dumps(row), flush=True)
        return out

    runner.evaluate_model = evaluate
    try:
        # the recipe's float training; one save, at the end
        cli.main(FT.train_args(root, cfg_path, batch=batch,
                               eval_every=every, save_every=steps,
                               device=device) + ["--steps", str(stop)])
    finally:
        runner.evaluate_model = evaluate_model
    print("probe-curve " + json.dumps(curve), flush=True)
    return curve


if __name__ == "__main__":
    main()
