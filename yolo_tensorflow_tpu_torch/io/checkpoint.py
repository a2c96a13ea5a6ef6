"""Training checkpoints of the port: save, resume and read back.

Counterpart of yolo_tensorflow_tpu/io/checkpoint.py (darknet's periodic
.backup writes, examples/detector.c:132-143), in the same npz format: one
``ckpt-<step>.npz`` per save, written to a temporary name and renamed, a
``latest.json`` pointer, the newest 3 kept.

``params`` and ``batch_stats`` are stored under the TPU package's keys
(``n:params%%k:L003%%k:w``) and in its array layout (HWIO conv kernels), so
either package's ``load_train_params`` reads the other's checkpoints. The
optimizer's state, the step and the generator's state are the port's own
and are stored under keys of their own (``torch:opt_state%%n:momentum%%
k:L003%%k:w``, ``torch:step``, ``torch:generator``), in the port's layout;
the port restores them, the TPU package ignores them.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict

import numpy as np
import torch

from yolo_tensorflow_tpu_torch.io.weights import (params_from_jax,
                                                   params_to_jax)

_SEP = "%%"
_OURS = "torch:"


def _atomic_savez(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write to a temporary name, then rename: a crash mid-save leaves no
    truncated checkpoint under the final name."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _np(tree) -> dict:
    return {k: {n: v.detach().float().cpu().numpy() for n, v in p.items()}
            for k, p in tree.items()}


def _tree_keys(prefix: str, tree: dict) -> Dict[str, np.ndarray]:
    return {_SEP.join((prefix, f"k:{k}", f"k:{n}")): np.asarray(v)
            for k, p in tree.items() for n, v in p.items()}


def _flatten(state) -> Dict[str, np.ndarray]:
    """A port TrainState as npz keys (module docstring)."""
    flat = _tree_keys("n:params", params_to_jax(_np(state.params)))
    flat.update(_tree_keys("n:batch_stats", _np(state.batch_stats)))
    opt = state.opt_state
    for field in opt._fields:
        value = getattr(opt, field)
        prefix = f"{_OURS}opt_state{_SEP}n:{field}"
        if isinstance(value, dict):
            flat.update(_tree_keys(prefix, _np(value)))
        else:
            flat[prefix] = value.detach().cpu().numpy()
    flat[f"{_OURS}step"] = state.step.detach().cpu().numpy()
    flat[f"{_OURS}generator"] = state.generator.get_state().numpy()
    return flat


def save_params_npz(params: Dict, path: str) -> None:
    """Flat 'layer/field' npz, the TPU package's params interchange format
    (its convert/quantize outputs, detect/eval inputs), written in its
    layout: the port's params (OIHW) are transposed to HWIO."""
    flat = {f"{layer}/{field}": np.asarray(v)
            for layer, d in params_to_jax(params).items()
            for field, v in d.items()}
    _atomic_savez(path, flat)


def save_train_state(state, ckpt_dir: str, step: int, *,
                     keep: int = 3) -> str:
    """Write <ckpt_dir>/ckpt-<step>.npz and the latest.json pointer; remove
    all but the newest ``keep`` checkpoints. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt-{step}.npz")
    _atomic_savez(path, _flatten(state))
    latest = os.path.join(ckpt_dir, "latest.json")
    with open(latest + ".tmp", "w") as f:
        json.dump({"step": step, "file": os.path.basename(path)}, f)
    os.replace(latest + ".tmp", latest)
    ckpts = sorted(
        (f for f in os.listdir(ckpt_dir)
         if re.fullmatch(r"ckpt-\d+\.npz", f)),
        key=lambda f: int(f.split("-")[1].split(".")[0]))
    for old in ckpts[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
    return path


def _latest(ckpt_dir: str):
    latest = os.path.join(ckpt_dir, "latest.json")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return json.load(f)


def checkpoint_has_field(ckpt_dir: str, field: str) -> bool:
    """True if the newest checkpoint stores any array under the named
    top-level field (e.g. 'qat_scales')."""
    meta = _latest(ckpt_dir)
    if meta is None:
        return False
    tokens = (f"n:{field}", f"k:{field}", f"{_OURS}{field}")
    with np.load(os.path.join(ckpt_dir, meta["file"])) as data:
        return any(part in tokens for k in data.files
                   for part in k.split(_SEP))


def load_train_params(path_or_dir: str):
    """(params, batch_stats, step) out of a training checkpoint of either
    package, in the port's layout (OIHW conv kernels), float32 numpy.
    Accepts a ckpt-<step>.npz or a checkpoint directory (its latest)."""
    step = -1
    if os.path.isdir(path_or_dir):
        meta = _latest(path_or_dir)
        if meta is None:
            raise FileNotFoundError(f"no latest.json in {path_or_dir}")
        path, step = os.path.join(path_or_dir, meta["file"]), meta["step"]
    else:
        path = path_or_dir
        m = re.search(r"ckpt-(\d+)\.npz$", path)
        if m:
            step = int(m.group(1))
    out = {"params": {}, "batch_stats": {}}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split(_SEP)
            if len(parts) != 3 or parts[0] not in ("n:params",
                                                   "n:batch_stats"):
                continue
            layer, leaf = parts[1][2:], parts[2][2:]
            out[parts[0][2:]].setdefault(layer, {})[leaf] = data[key]
    if not out["params"]:
        raise ValueError(
            f"{path} holds no 'params' tree: not a training checkpoint "
            "(convert/quantize outputs use the flat layer/field format)")
    return params_from_jax(out["params"]), out["batch_stats"], int(step)


def _subtree(flat, prefix: str, like: dict, what: str) -> dict:
    """The checkpoint's {layer: {name: array}} under ``prefix`` for every
    leaf of ``like``; a missing one raises KeyError."""
    out = {}
    for k, p in like.items():
        out[k] = {}
        for n in p:
            key = _SEP.join((prefix, f"k:{k}", f"k:{n}"))
            if key not in flat:
                raise KeyError(f"checkpoint missing {what} {k}/{n} ({key})")
            out[k][n] = flat[key]
    return out


def _copy_into(tensors: dict, arrays: dict) -> None:
    with torch.no_grad():
        for k, p in tensors.items():
            for n, t in p.items():
                t.copy_(torch.from_numpy(np.asarray(arrays[k][n])).reshape(
                    t.shape))


def restore_train_state(template, ckpt_dir: str):
    """Restore the newest checkpoint into ``template`` (a port TrainState
    of the same model and optimizer, as ``train.loop.create_train_state``
    makes it), in place. Returns (state, step), or (None, 0) when the
    directory holds no checkpoint. A field the template has and the
    checkpoint lacks raises KeyError."""
    meta = _latest(ckpt_dir)
    if meta is None:
        return None, 0
    with np.load(os.path.join(ckpt_dir, meta["file"])) as data:
        flat = {k: data[k] for k in data.files}
    _copy_into(template.params, params_from_jax(
        _subtree(flat, "n:params", template.params, "params")))
    _copy_into(template.batch_stats, _subtree(
        flat, "n:batch_stats", template.batch_stats, "batch_stats"))
    opt = template.opt_state
    for field in opt._fields:
        value = getattr(opt, field)
        prefix = f"{_OURS}opt_state{_SEP}n:{field}"
        if isinstance(value, dict):
            _copy_into(value, _subtree(flat, prefix, value,
                                       f"optimizer {field}"))
            continue
        if prefix not in flat:
            raise KeyError(f"checkpoint missing optimizer {field} "
                           f"({prefix})")
        value.copy_(torch.from_numpy(flat[prefix]))
    for key in (f"{_OURS}step", f"{_OURS}generator"):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
    template.step.copy_(torch.from_numpy(flat[f"{_OURS}step"]))
    template.generator.set_state(torch.from_numpy(flat[f"{_OURS}generator"]))
    return template, int(meta["step"])
