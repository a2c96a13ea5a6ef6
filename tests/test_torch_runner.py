"""The port's training entry point (train/runner.run_training) and its data
path (data/loader.DetectionLoader, data/native.py) on the CPU: real files
on disk -> loader -> steps -> checkpoint -> resume, as tests/test_runner.py
drives the JAX package's with num_data=1; from the registry, from a .cfg
written by specs_to_cfg with a .weights file, for the region, detection
and classifier heads. The port's loader gives the same batches as the JAX
package's for the same seed and read_fn, through the native kernel and
through cv2, bit for bit."""

import argparse
import json

import numpy as np
import pytest

from yolo_tensorflow_tpu.data import datasets as JD
from yolo_tensorflow_tpu.data import loader as JLd
from yolo_tensorflow_tpu_torch.data import datasets as TD
from yolo_tensorflow_tpu_torch.data import loader as TLd
from yolo_tensorflow_tpu_torch.data import native as TN
from yolo_tensorflow_tpu_torch.io import cfg as TCfg
from yolo_tensorflow_tpu_torch.train import runner as TR

from torch_parity import model, write_weights


def _scenes(n=8, seed=0):
    """n synthetic 96x128 scenes, a bright rectangle each: (images, darknet
    label lines)."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for i in range(n):
        img = np.full((96, 128, 3), 25, np.uint8)
        w, h = int(rng.integers(40, 80)), int(rng.integers(30, 60))
        x0, y0 = int(rng.integers(0, 128 - w)), int(rng.integers(0, 96 - h))
        img[y0:y0 + h, x0:x0 + w] = (210, 90 + 10 * i, 40)
        imgs.append(img)
        labels.append(f"{i % 4} {(x0 + w / 2) / 128:.4f} "
                      f"{(y0 + h / 2) / 96:.4f} {w / 128:.4f} {h / 96:.4f}\n")
    return imgs, labels


def _dataset(tmp_path, n=8):
    """Images written with cv2 and darknet labels; returns the list file."""
    import cv2
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    paths = []
    for i, (img, lab) in enumerate(zip(*_scenes(n))):
        p = tmp_path / "images" / f"im{i}.png"
        cv2.imwrite(str(p), img[..., ::-1])
        (tmp_path / "labels" / f"im{i}.txt").write_text(lab)
        paths.append(str(p))
    lst = tmp_path / "train.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


def _args(lst, ckpt_dir, steps, **kw):
    base = dict(model="yolov2-tiny-voc", cfg=None, list=lst, val_list=None,
                weights=None, ckpt_dir=str(ckpt_dir), batch_size=4,
                steps=steps, lr=1e-3, burn_in=4, multiscale=False,
                num_data=1, num_spatial=1, save_every=3, log_every=1,
                input_size=64, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("native", ["1", "0"])
def test_loader_batches_equal_jax(native, tmp_path, monkeypatch):
    """Two epochs, the second at another size (multi-scale's set_size),
    through the native kernel (1) or cv2 (0): every image and truth equal
    to the JAX package's loader, bit for bit."""
    monkeypatch.setenv("YOLO_NATIVE_LOADER", native)
    lst = _dataset(tmp_path)
    imgs = {p: img for p, img in zip(open(lst).read().split(),
                                     _scenes()[0])}
    read = imgs.__getitem__
    loaders = [pkg.DetectionLoader(ds.load_darknet_list(lst), 4, 64,
                                   seed=3, num_workers=2, read_fn=read,
                                   jitter=0.3, hue=0.1, sat=1.5,
                                   exposure=1.5)
               for pkg, ds in ((TLd, TD), (JLd, JD))]
    for size in (64, 96):
        for lo in loaders:
            lo.set_size(size)
        got, want = (list(lo.epoch()) for lo in loaders)
        assert len(got) == len(want) == 2
        for (gi, gt), (wi, wt) in zip(got, want):
            assert gi.shape == (4, size, size, 3)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gt, wt)


def test_native_library_builds_from_the_repository_source():
    path = TN.build()
    assert path.parent == TN.BUILD_DIR and path.name.startswith(
        "libyolodata-")
    assert TN.load_library().yd_version() == 1


def test_run_training_and_resume(tmp_path, capsys):
    lst = _dataset(tmp_path)
    ckpt_dir = tmp_path / "ckpts"
    TR.run_training(_args(lst, ckpt_dir, 3))
    out = capsys.readouterr().out
    assert "8 training samples" in out and "step 3:" in out
    assert "saved" in out and (ckpt_dir / "ckpt-3.npz").exists()
    TR.run_training(_args(lst, ckpt_dir, 5))
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "step 5:" in out
    assert json.loads((ckpt_dir / "latest.json").read_text())["step"] == 5


@pytest.mark.parametrize("name", ["narrow-v2", "narrow-v1-train"])
def test_run_training_from_cfg_and_weights(name, tmp_path, capsys,
                                           monkeypatch):
    """--cfg (specs_to_cfg's text, with adam=1 and, for the region head,
    random=1) and --weights from save_darknet_weights; the read_fn route
    (no cv2 decode) with the native pixel kernel."""
    monkeypatch.setenv("YOLO_NATIVE_LOADER", "1")
    lst = _dataset(tmp_path)
    cfg, specs = model(name, 64)
    text = TCfg.specs_to_cfg(cfg, specs, batch=4).replace(
        "[net]\n", "[net]\nadam=1\n").replace("random=0", "random=1")
    (tmp_path / "m.cfg").write_text(text)
    write_weights(specs, 64, tmp_path / "m.weights", seed=5)
    scenes = dict(zip(open(lst).read().split(), _scenes()[0]))
    args = _args(lst, tmp_path / "ck", 3, model=None,
                 cfg=str(tmp_path / "m.cfg"),
                 weights=str(tmp_path / "m.weights"), input_size=None,
                 lr=None, burn_in=None, batch_size=None)
    state = TR.run_training(args, read_fn=scenes.__getitem__)
    out = capsys.readouterr().out
    assert "adam B1=0.9" in out and "batch 4" in out and "done" in out
    assert int(state.step) == 3
    sizes = {int(line.split("size ")[1]) for line in out.splitlines()
             if line.startswith("step ")}
    if cfg.head == 2:
        # random=1: batches the loader made before the first set_size come
        # at the cfg's size, as in the TPU package's runner
        assert sizes - {64} and sizes - {64} <= set(TR.MULTISCALE_SIZES)
    else:
        assert sizes == {64}


def test_run_training_classifier(tmp_path, capsys):
    """Labels from the class name in the path; softmax cross-entropy."""
    import cv2
    paths = []
    for i in range(8):
        p = tmp_path / f"{'dark' if i % 2 == 0 else 'bright'}_{i}.png"
        cv2.imwrite(str(p), np.full((40, 40, 3), 30 if i % 2 == 0 else 200,
                                    np.uint8))
        paths.append(str(p))
    (tmp_path / "train.txt").write_text("\n".join(paths) + "\n")
    (tmp_path / "names.txt").write_text("dark\nbright\n")
    args = _args(str(tmp_path / "train.txt"), tmp_path / "ck", 2,
                 model="darknet19-classifier", input_size=32,
                 names=str(tmp_path / "names.txt"))
    TR.run_training(args)
    out = capsys.readouterr().out
    assert "acc " in out and "done" in out


@pytest.mark.parametrize("kw,item", [
    (dict(num_data=2), "item 10"), (dict(num_spatial=2), "item 10"),
    (dict(coordinator="localhost:1234"), "item 10"),
    (dict(qat=True), "item 13"), (dict(remat_every=2), "item 9")])
def test_unported_runner_options_raise(kw, item, tmp_path):
    """Each raises before a sample is read or a step taken."""
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        TR.run_training(_args(str(tmp_path / "missing.txt"), tmp_path, 1,
                              **kw))


def test_run_training_defaults_to_the_card(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.run_training(_args(str(tmp_path / "missing.txt"), tmp_path, 1,
                              device=None))


@pytest.mark.parametrize("head,h0", [
    (2, {"jitter": ".3", "max": "20"}), (3, {}), (1, {"jitter": ".1"})])
def test_aug_from_cfg_matches_jax(head, h0):
    from yolo_tensorflow_tpu.train import runner as JR
    net = {"hue": ".1", "saturation": "1.5", "exposure": "1.4"}
    assert TR.aug_from_cfg(net, h0, head) == JR.aug_from_cfg(net, h0, head)


def _jax_state(state):
    """The port's TrainState as the JAX package's evaluate_model and
    evaluate_classifier read one: HWIO params and batch stats, numpy."""
    import types
    from torch_parity import to_jax

    def arrays(tree):
        return {k: {n: v.detach().cpu().numpy().copy() for n, v in p.items()}
                for k, p in tree.items()}

    return types.SimpleNamespace(params=to_jax(arrays(state.params)),
                                 batch_stats=arrays(state.batch_stats))


def _eval_lines(out):
    return [line for line in out.splitlines() if ": val " in line]


def test_run_training_evaluates_a_detector(tmp_path, capsys):
    """val_list with eval_every on the narrow v2 net from a .cfg: the mAP
    printed at step 2 (stretch Detector, cv2) and evaluate_model's result
    equal the JAX package's evaluate_model on the same parameters."""
    from yolo_tensorflow_tpu import config as JC
    from yolo_tensorflow_tpu.train import runner as JR
    from yolo_tensorflow_tpu_torch import config as TC
    lst = _dataset(tmp_path)
    cfg, specs = model("narrow-v2", 64)
    path = tmp_path / "m.cfg"
    path.write_text(TCfg.specs_to_cfg(cfg, specs, batch=4))
    scenes = dict(zip(open(lst).read().split(), _scenes()[0]))
    args = _args(lst, tmp_path / "ck", 2, model=None, cfg=str(path),
                 input_size=None, lr=None, burn_in=None, batch_size=None,
                 val_list=lst, eval_every=2)
    state = TR.run_training(args, read_fn=scenes.__getitem__)
    out = capsys.readouterr().out
    jcfg, jspecs = JC.config_from_cfg(str(path))
    want = JR.evaluate_model(jcfg, jspecs, _jax_state(state),
                             JD.load_darknet_list(lst), limit=200)
    pcfg, pspecs = TC.config_from_cfg(str(path))
    cache = []
    for _ in range(2):          # the second round reuses the Detector
        got = TR.evaluate_model(pcfg, pspecs, state,
                                TD.load_darknet_list(lst), limit=200,
                                detector_cache=cache,
                                read_fn=scenes.__getitem__)
        assert len(cache) == 1
        assert got["map"] == want["map"]
        assert got["num_classes_evaluated"] == want["num_classes_evaluated"]
        np.testing.assert_array_equal(got["ap_per_class"],
                                      want["ap_per_class"])
    assert _eval_lines(out) == [
        f"step 2: val mAP@0.5 = {want['map']:.4f} "
        f"({want['num_classes_evaluated']} classes)"]


def test_run_training_evaluates_a_classifier(tmp_path, capsys):
    """val_list with eval_every on the narrow classifier from a .cfg, the
    images through read_fn: the top-1 printed at steps 2 and 4 and
    evaluate_classifier's equal the JAX package's evaluate_classifier
    (mode 'crop') on the same parameters."""
    import cv2
    from yolo_tensorflow_tpu import config as JC
    from yolo_tensorflow_tpu.train import runner as JR
    from yolo_tensorflow_tpu_torch import config as TC
    names = ("qdark", "qbright", "qred", "qblue")
    colours = ((30, 30, 30), (220, 220, 220), (200, 20, 20), (20, 20, 200))
    rng = np.random.default_rng(4)
    paths, pixels = [], {}
    for i in range(8):
        p = str(tmp_path / f"{names[i % 4]}_{i}.png")
        img = np.clip(np.asarray(colours[i % 4], np.int16)
                      + rng.integers(-20, 21, (40, 48, 3)), 0,
                      255).astype(np.uint8)
        cv2.imwrite(p, img[..., ::-1])
        paths.append(p)
        pixels[p] = img
    (tmp_path / "train.txt").write_text("\n".join(paths) + "\n")
    (tmp_path / "names.txt").write_text("\n".join(names) + "\n")
    cfg, specs = model("narrow-cls", 32)
    path = tmp_path / "c.cfg"
    path.write_text(TCfg.specs_to_cfg(cfg, specs, batch=4))
    lst = str(tmp_path / "train.txt")
    args = _args(lst, tmp_path / "ck", 4, model=None, cfg=str(path),
                 names=str(tmp_path / "names.txt"), input_size=None,
                 lr=None, burn_in=None, batch_size=None, val_list=lst,
                 eval_every=2)
    state = TR.run_training(args, read_fn=pixels.__getitem__)
    out = capsys.readouterr().out
    jcfg, jspecs = JC.config_from_cfg(
        str(path), class_names_file=str(tmp_path / "names.txt"))
    want = JR.evaluate_classifier(jcfg, _jax_state(state),
                                  JD.load_classifier_list(lst, names),
                                  limit=200, specs=jspecs)
    pcfg, pspecs = TC.config_from_cfg(
        str(path), class_names_file=str(tmp_path / "names.txt"))
    got = TR.evaluate_classifier(pcfg, state,
                                 TD.load_classifier_list(lst, names),
                                 limit=200, specs=pspecs,
                                 read_fn=pixels.__getitem__)
    assert got == want
    lines = _eval_lines(out)
    assert len(lines) == 2 and lines[-1] == f"step 4: val top-1 = {want:.4f}"
