"""CPU gates for the port's training tools (yolo_tensorflow_tpu_torch/
tools/flagship_train.py and transfer_pretrain.py), the counterparts of
tests/test_flagship_smoke.py and tests/test_transfer_smoke.py.

Each drives its tool's phases end to end at a tiny size in a fresh process,
on ``--device cpu``, with cv2 unimportable there (a stand-in ``cv2`` module
on the path raises ImportError), as on the card's host: every command-line
phase runs in its own process, so resume, the QAT leg, export and partial
cross process boundaries as they do on the card. The flagship's dataset
and cfg are also held to the JAX tool's: the label files byte for byte,
the list files line for line (.npy for .png), the pixels equal to the
PNGs, and the emitted cfg text equal. Seconds on this CPU: flagship ~30,
transfer ~40. Each removes its run directory at the end: the transfer
recipe's full-width yolov2 checkpoints take ~1.1 GB.

Beside them, the rule of ``train/runner.py`` that the tools' runs rely on
for their last checkpoint: a run ends with a checkpoint of its last step,
written once when the periodic save has just written that step.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(tmp_path, **extra):
    """The tool's environment: the repo on the path, behind a cv2 that
    cannot be imported, and 4 threads a process."""
    block = tmp_path / "nocv2"
    block.mkdir()
    (block / "cv2.py").write_text(
        "raise ImportError('cv2 is not available to the port')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update({"PYTHONPATH": os.pathsep.join(
        [str(block), REPO, os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "4"}, **extra)
    return env


def _run(module, args, env, timeout):
    r = subprocess.run([sys.executable, "-m", module] + args,
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


@pytest.fixture
def run_root(tmp_path):
    """The tool's --root, removed after the test whatever its outcome."""
    root = tmp_path / "run"
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_flagship_phases_end_to_end(tmp_path, run_root, monkeypatch):
    root = run_root
    out = _run("yolo_tensorflow_tpu_torch.tools.flagship_train",
               ["--root", str(root), "--steps", "6", "--batch", "4",
                "--n-train", "12", "--n-val", "6", "--qat-steps", "2",
                "--eval-every", "3", "--save-every", "3", "--device", "cpu"],
               _env(tmp_path, FLAGSHIP_SIZE="96",
                    FLAGSHIP_MODEL="yolov3-tiny"), timeout=600)

    # the three CLI phases ran as separate processes, phase 2 resumed
    # from phase 1's checkpoint, and the QAT phase shipped its int8 model
    log = (root / "train.log").read_text()
    assert log.count("\n$ ") == 3, log
    assert "resumed from step 3" in log, log
    assert "float checkpoint -> QAT fine-tune" in log, log
    assert "cv2" not in log, log
    assert (root / "ckpts" / "int8-qat.npz").exists()

    # the final line is the results-of-record JSON with every suite leg
    res = json.loads(out.strip().splitlines()[-1])
    assert res["flagship"] == "yolov3-tiny-96 hard12"
    assert res["step"] == 6
    legs = {"float bf16", "flip-TTA[darknet]", "flip-TTA[corrected]",
            "int8 PTQ", "int8 QAT"}
    assert legs <= set(res["results"]), res["results"]
    assert all(0.0 <= v <= 1.0 for v in res["results"].values())

    # the JAX tool's dataset and cfg at the same n and size
    from tools import flagship_train as JF
    jroot = tmp_path / "jax"
    jroot.mkdir()
    JF.gen_dataset(str(jroot), 12, 6, size=96)
    for split in ("train", "valid"):
        jlines = (jroot / f"{split}.txt").read_text().splitlines()
        plines = (root / f"{split}.txt").read_text().splitlines()
        assert [p.replace(str(root), str(jroot)).replace(".npy", ".png")
                for p in plines] == jlines
        for jl, pl in zip(jlines, plines):
            name = os.path.basename(jl)[:-4]
            assert (root / "labels" / f"{name}.txt").read_bytes() == \
                (jroot / "labels" / f"{name}.txt").read_bytes()
            png = cv2.cvtColor(cv2.imread(jl), cv2.COLOR_BGR2RGB)
            np.testing.assert_array_equal(np.load(pl), png)
    assert (root / "shapes.names").read_bytes() == \
        (jroot / "shapes.names").read_bytes()
    monkeypatch.setattr(JF, "MODEL", "yolov3-tiny")
    for kw, suffix in (({"max_batches": 6}, ""), ({}, "-qat")):
        jpath, _ = JF.emit_cfg(str(jroot), size=96, suffix=suffix, **kw)
        with open(jpath) as f:
            assert (root / f"yolov3-tiny-shapes12{suffix}.cfg").read_text() \
                == f.read()


def test_transfer_phases_end_to_end(tmp_path, run_root):
    root = run_root
    out = _run("yolo_tensorflow_tpu_torch.tools.transfer_pretrain",
               ["--root", str(root), "--clf-steps", "2", "--det-steps", "2",
                "--eval-every", "1", "--batch", "4", "--n-train", "16",
                "--n-val", "8", "--device", "cpu"],
               _env(tmp_path, TRANSFER_CLF_SIZE="32",
                    TRANSFER_DET_SIZE="64"), timeout=600)

    # classifier, export-darknet, partial: the truncated backbone exists
    # and is shorter than the full export
    clf_log = (root / "clf.log").read_text()
    for cmd in ("cli train", "cli export-darknet", "cli partial"):
        assert cmd in clf_log, clf_log[-2000:]
    backbone = root / "darknet19-shapes.conv.23"
    assert backbone.stat().st_size < \
        (root / "darknet19-shapes.weights").stat().st_size
    # both yolov2 legs ran; the transfer leg started from the backbone
    assert "keep init" not in (root / "det_scratch.log").read_text()
    det_log = (root / "det_transfer.log").read_text()
    assert "partial" in det_log and "keep init" in det_log, det_log[-2000:]
    assert "done" in det_log and "cv2" not in det_log + clf_log

    # the A/B table was printed, and is the JSON of record
    assert "=== transfer A/B: yolov2-64 hard12" in out
    table = json.loads(out.strip().splitlines()[-1])["transfer_ab"]
    assert [row["step"] for row in table] == [1, 2]
    for row in table:
        assert 0.0 <= row["scratch"] <= 1.0
        assert 0.0 <= row["transfer"] <= 1.0
        assert abs(row["delta"] - (row["transfer"] - row["scratch"])) < 1e-6
    saved = json.loads((root / "transfer_ab.json").read_text())
    assert [s for s, _ in saved["clf_top1_curve"]] == [1, 2]


@pytest.mark.parametrize("steps,saved", [(4, [2, 4]), (5, [2, 4, 5])])
def test_run_ends_with_one_checkpoint_of_its_last_step(steps, saved,
                                                       tmp_path, monkeypatch):
    """--save-every 2: a run of 4 steps saves steps 2 and 4 (the final save
    is the periodic one), a run of 5 steps saves 2, 4 and then 5."""
    from yolo_tensorflow_tpu_torch.io import checkpoint as ckpt
    from yolo_tensorflow_tpu_torch.tools import flagship_train as FT
    from yolo_tensorflow_tpu_torch.train import runner
    lists, _ = FT.write_detection_set(str(tmp_path), (("train", 8, 0),), 64)
    steps_saved = []

    def save(state, ckpt_dir, step):
        steps_saved.append(step)
        return os.path.join(ckpt_dir, f"ckpt-{step}.npz")

    monkeypatch.setattr(ckpt, "save_train_state", save)
    runner.run_training(argparse.Namespace(
        model="yolov2-tiny-voc", cfg=None, list=lists["train"],
        val_list=None, weights=None, ckpt_dir=str(tmp_path / "ckpts"),
        batch_size=4, steps=steps, lr=1e-3, burn_in=4, multiscale=False,
        num_data=1, num_spatial=1, save_every=2, log_every=1,
        input_size=64, device="cpu"), read_fn=np.load)
    assert steps_saved == saved
