"""Darknet ``.weights`` byte stream <-> the port's folded parameters.

Counterpart of yolo_tensorflow_tpu/io/weights.py for convolutional and
connected layers, which is all the v1, v2 and v3 detectors hold. That module
cannot be imported here: it pulls in the TPU package's engine, which imports
jax. The file format is the same (src/parser.c:1241-1290):
  header: int32 major, minor, revision, then ``seen`` (int32 before
          major*10+minor >= 2, int64 from then on), then raw float32s;
  per conv+BN layer: biases(beta)[n] scales(gamma)[n] mean[n] var[n]
                     weights[(out, in, kh, kw) row-major];
  per bias-only conv: biases[n] weights[...];
  per connected layer: biases[out] weights[(out, in) row-major], then with
                     batch norm scales[out] mean[out] var[out].
The port keeps darknet's OIHW kernel order, so no transpose happens at load
for convs; connected weights are held (In, Out), the TPU package's layout,
and transposed from and to the file's (Out, In). A layer that holds no
weights (TransposeFlatten among them) takes no section of the file. BN folds
into its layer at load with darknet's formula.
"""

from __future__ import annotations

import io as _io
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from yolo_tensorflow_tpu_torch.models import specs as S
from yolo_tensorflow_tpu_torch.models.engine import (check_supported,
                                                      infer_shapes, layer_key)


class WeightsFormatError(ValueError):
    pass


def read_header(fp):
    """Read the darknet header, by darknet's version rule: ``seen`` is int64
    iff major*10+minor >= 2."""
    raw = fp.read(12)
    if len(raw) != 12:
        raise WeightsFormatError("truncated header")
    major, minor, revision = struct.unpack("<3i", raw)
    wide_seen = major * 10 + minor >= 2
    seen = struct.unpack("<q" if wide_seen else "<i",
                         fp.read(8 if wide_seen else 4))[0]
    return {"major": major, "minor": minor, "revision": revision,
            "seen": seen}


def write_header(fp, *, major=0, minor=2, revision=0, seen=0):
    fp.write(struct.pack("<3i", major, minor, revision))
    wide_seen = major * 10 + minor >= 2
    fp.write(struct.pack("<q" if wide_seen else "<i", seen))


def _take(buf: np.ndarray, ptr: int, n: int) -> Tuple[np.ndarray, int]:
    if ptr + n > buf.size:
        raise WeightsFormatError(
            f"weights file exhausted: need {ptr + n} floats, have {buf.size}")
    return buf[ptr:ptr + n], ptr + n


def fold_bn(w_oihw, gamma, beta, mean, var):
    """Fold inference-mode BN into conv weight + bias by darknet's formula,
    gamma/(sqrt(var)+1e-6) (normalize_cpu), the ground truth for .weights
    files."""
    inv = gamma / (np.sqrt(var) + 1e-6)
    w = w_oihw * inv.reshape(-1, 1, 1, 1)
    b = beta - mean * inv
    return w.astype(np.float32), b.astype(np.float32)


def fold_params(params, batch_stats, bn_eps: float) -> dict:
    """Trained (unfolded BN) params of the port's layout, numpy or tensors
    -> the folded serving form, {"w", "b"} float32 numpy per layer: the TPU
    package's fold_params with its default "tf" formula, gamma / sqrt(var +
    eps) (training-mode BN normalizes that way), over OIHW conv kernels and
    (In, Out) connected weights alike."""
    def arr(v):
        return (v.detach().float().cpu().numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v))

    out = {}
    for key, p in params.items():
        p = {k: arr(v) for k, v in p.items()}
        if "gamma" not in p:
            out[key] = p
            continue
        st = {k: arr(v) for k, v in batch_stats[key].items()}
        inv = p["gamma"] / np.sqrt(st["var"] + bn_eps)
        w = p["w"]
        scale = inv.reshape(-1, 1, 1, 1) if w.ndim == 4 else inv[None, :]
        out[key] = {"w": (w * scale).astype(np.float32),
                    "b": (p["beta"] - st["mean"] * inv).astype(np.float32)}
    return out


def _read_conv_sub(buf, ptr, cin, cout, k, bn, fold):
    """One conv layer (load_convolutional_weights order): (params, running
    statistics or None, ptr), folded unless ``fold`` is false."""
    if bn:
        beta, ptr = _take(buf, ptr, cout)
        gamma, ptr = _take(buf, ptr, cout)
        mean, ptr = _take(buf, ptr, cout)
        var, ptr = _take(buf, ptr, cout)
    else:
        bias, ptr = _take(buf, ptr, cout)
    flat, ptr = _take(buf, ptr, cout * cin * k * k)
    w = np.array(flat.reshape(cout, cin, k, k), np.float32)
    if not bn:
        return {"w": w, "b": bias.copy()}, None, ptr
    if fold:
        wf, bf = fold_bn(w, gamma, beta, mean, var)
        return {"w": wf, "b": bf}, None, ptr
    return ({"w": w, "gamma": gamma.copy(), "beta": beta.copy()},
            {"mean": mean.copy(), "var": var.copy()}, ptr)


def _read_fc(buf, ptr, fan_in, units, bn, fold):
    """One connected layer (load_connected_weights order): w comes back
    (In, Out); the biases are the BN's beta. Folded unless ``fold`` is
    false, as ``_read_conv_sub``."""
    bias, ptr = _take(buf, ptr, units)
    flat, ptr = _take(buf, ptr, units * fan_in)
    w = np.ascontiguousarray(flat.reshape(units, fan_in).T, np.float32)
    if not bn:
        return {"w": w, "b": bias.copy()}, None, ptr
    gamma, ptr = _take(buf, ptr, units)
    mean, ptr = _take(buf, ptr, units)
    var, ptr = _take(buf, ptr, units)
    if not fold:
        return ({"w": w, "gamma": gamma.copy(), "beta": bias.copy()},
                {"mean": mean.copy(), "var": var.copy()}, ptr)
    inv = gamma / (np.sqrt(var) + 1e-6)
    return {"w": (w * inv[None, :]).astype(np.float32),
            "b": (bias - mean * inv).astype(np.float32)}, None, ptr


def load_darknet_weights(specs, input_size: int, path_or_bytes, *,
                         in_channels: int = 3, fold: bool = True,
                         allow_partial: bool = False):
    """Parse a .weights stream against ``specs``.

    fold=True (serving) returns (params, header), BN folded with darknet's
    formula: {layer_key(i): {"w": OIHW f32, "b": f32}} per conv and {"w":
    (In, Out) f32, "b": f32} per connected layer. fold=False (training)
    returns (params, batch_stats, header) as the TPU package's loader does:
    BN convs and connected layers carry {"w", "gamma", "beta"} and their
    running {"mean", "var"} land in batch_stats.

    ``allow_partial``: accept a file that ends at a layer boundary before
    the spec list does (a backbone cut by darknet's ``partial``, such as
    darknet19_448.conv.23); layers past its end are absent from the
    result. A file that ends inside a layer still raises. Specs the port
    cannot run raise NotImplementedError."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        fp = _io.BytesIO(path_or_bytes)
    else:
        fp = open(path_or_bytes, "rb")
    with fp:
        header = read_header(fp)
        buf = np.frombuffer(fp.read(), dtype="<f4")

    shapes = infer_shapes(specs, (1, input_size, input_size, in_channels))
    params: Dict[str, Dict[str, np.ndarray]] = {}
    stats: Dict[str, Dict[str, np.ndarray]] = {}
    ptr = 0
    stopped_early = False
    prev = (1, input_size, input_size, in_channels)
    for i, spec in enumerate(specs):
        weighted = isinstance(spec, (S.Conv, S.Dense))
        if allow_partial and ptr == buf.size and weighted:
            stopped_early = True
            break
        if isinstance(spec, S.Conv):
            sub, st, ptr = _read_conv_sub(buf, ptr, prev[3], spec.filters,
                                          spec.size, spec.bn, fold)
        elif isinstance(spec, S.Dense):
            sub, st, ptr = _read_fc(buf, ptr, prev[1], spec.units, spec.bn,
                                    fold)
        if weighted:
            params[layer_key(i)] = sub
            if st is not None:
                stats[layer_key(i)] = st
        prev = shapes[i]
    if ptr != buf.size and not stopped_early:
        raise WeightsFormatError(
            f"weights file has {buf.size - ptr} unconsumed floats "
            f"(consumed {ptr}); spec/weights mismatch")
    return (params, header) if fold else (params, stats, header)


def save_darknet_weights(specs, input_size: int, params, batch_stats, path,
                         *, seen: int = 0):
    """Write unfolded darknet-form params (``engine.init_params``' form:
    convs OIHW, connected layers (In, Out)) to a .weights file, byte for
    byte what the TPU package's writer makes of the same values in its
    layout."""
    for i, spec in enumerate(specs):
        check_supported(spec, i)       # no other weighted type gets past
    with open(path, "wb") as fp:
        write_header(fp, seen=seen)
        for i, spec in enumerate(specs):
            if not isinstance(spec, (S.Conv, S.Dense)):
                continue
            key = layer_key(i)
            p = {k: np.asarray(v, np.float32) for k, v in params[key].items()}
            if spec.bn and "gamma" not in p:
                raise ValueError(
                    f"{key}: cannot serialize folded BN back to .weights")
            st = batch_stats[key] if spec.bn else None
            if isinstance(spec, S.Dense):
                # connected order: bias, weights (Out, In), then the BN
                fp.write((p["beta"] if spec.bn else p["b"]).tobytes())
                fp.write(p["w"].T.tobytes())
                if spec.bn:
                    for arr in (p["gamma"], st["mean"], st["var"]):
                        fp.write(np.asarray(arr, np.float32).tobytes())
                continue
            if spec.bn:
                for arr in (p["beta"], p["gamma"], st["mean"], st["var"]):
                    fp.write(np.asarray(arr, np.float32).tobytes())
            else:
                fp.write(p["b"].tobytes())
            fp.write(np.ascontiguousarray(p["w"]).tobytes())


HWIO_TO_OIHW = (3, 2, 0, 1)
OIHW_TO_HWIO = (2, 3, 1, 0)


def _relayout(np_params, axes):
    out = {}
    for key, p in np_params.items():
        p = {k: np.asarray(v) for k, v in p.items()}
        name = "w_q" if "w_q" in p else "w"
        if p[name].ndim == 2:
            out[key] = {**p, name: np.ascontiguousarray(p[name])}
            continue
        if p[name].ndim != 4:
            raise NotImplementedError(
                f"{key}: only conv and connected parameters carry over "
                "(ROADMAP.md, 'the long tail')")
        out[key] = {**p, name: np.ascontiguousarray(p[name].transpose(axes))}
    return out


def params_from_jax(np_params):
    """TPU-package parameters (numpy) -> the port's layout. Conv kernels go
    from HWIO to OIHW, float ``w`` and int8 ``w_q`` alike. A connected
    layer's 2-D ``w`` stays (In, Out): that is the port's layout too
    (``ops.layers.dense``), not ``nn.Linear``'s (Out, In). Other arrays
    (``b``, ``s_w``, ``s_x``, ``gamma``, ``beta``) pass through."""
    return _relayout(np_params, HWIO_TO_OIHW)


def params_to_jax(np_params):
    """The inverse of ``params_from_jax``: the port's layout (numpy) -> the
    TPU package's, conv kernels OIHW -> HWIO."""
    return _relayout(np_params, OIHW_TO_HWIO)


def train_state_from_jax(np_params, np_batch_stats, np_momentum=None):
    """A TPU-package TrainState's parameters (convs, and connected layers
    plain or with their BN's gamma and beta), running BN statistics and SGD
    momentum buffers (numpy trees: the momentum is optax's trace, shaped
    like the parameters) -> the port's layout, conv kernels OIHW, as
    ``train.loop.create_train_state(params=, batch_stats=, momentum=)``
    takes them. Returns (params, batch_stats, momentum or None)."""
    stats = {k: {n: np.asarray(v, np.float32) for n, v in st.items()}
             for k, st in np_batch_stats.items()}
    momentum = None if np_momentum is None else params_from_jax(np_momentum)
    return params_from_jax(np_params), stats, momentum
