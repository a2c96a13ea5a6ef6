"""Int8 (w8a8) post-training quantization.

Counterpart of yolo_tensorflow_tpu/ops/quant.py. The mixed serving path:
per-output-channel symmetric weight scales s_w[o] = max|w[o]| / 127, a
static per-conv input scale s_x = calibrated range / 127, head convs kept
in float. ``engine.Network`` runs a conv whose params hold ``w_q`` through
the int8 kernel (``ops/kernels/conv_int8``); everything between convs stays
in the compute dtype.

The all-int8-activation path: ``calibrate_outputs`` records a scale per
layer output (and the input), ``apply_int8`` keeps activations int8 between
layers (each quantized conv is the int8-in kernel, ``conv2d_int8_q``, which
requantizes in its epilogue; pools, upsample and reorg move int8 values;
routes concatenate int8, requantizing the parts whose scale differs;
shortcuts add in float32 and requantize; head convs run in float32), and
``make_int8_forward`` decodes and runs NMS after it. Where the TPU package
divides by a scale, XLA compiles a multiply by its float32 reciprocal (and
folds a dequantize scale into it, and an add of two dequantized values into
an fma); the port computes the same, so that it is that program bit for
bit.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from yolo_tensorflow_tpu_torch.models import engine, heads
from yolo_tensorflow_tpu_torch.models import specs as S
from yolo_tensorflow_tpu_torch.ops import layers as L
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
from yolo_tensorflow_tpu_torch.pipeline import _nms_opts, normalize_images
from yolo_tensorflow_tpu_torch.post import nms as NMS

PERCENTILE = 99.9       # of |conv input|, per calibration batch


def _percentile(t) -> float:
    """PERCENTILE of |t| (any layout: the percentile sorts)."""
    return float(np.percentile(np.abs(np.asarray(t.float().cpu(),
                                                 np.float32)), PERCENTILE))


def head_conv_layers(specs) -> set:
    """Indices of convs feeding a Detect marker (kept unquantized)."""
    return {i - 1 for i, spec in enumerate(specs)
            if isinstance(spec, S.Detect) and i > 0}


def calibrate_activations(specs, params, batches, *, cfg,
                          device="cpu") -> Dict[str, float]:
    """Run float32 inference of the folded ``params`` (port layout) on
    ``device`` over calibration batches (uint8 (B, H, W, 3) each),
    recording every conv's input range as the JAX package does: the
    PERCENTILE of |x| per batch, the max over batches. Returns
    {layer_key: range / 127}."""
    net = engine.Network(specs, params, device=device)
    maxes: Dict[str, float] = {}

    def recorder(key):
        def record(_, args):
            maxes[key] = max(maxes.get(key, 0.0), _percentile(args[0]))
        return record

    hooks = [conv.register_forward_pre_hook(recorder(key))
             for key, conv in net.convs.items()]
    try:
        with torch.inference_mode():
            for images in batches:
                net(normalize_images(torch.as_tensor(images).to(device),
                                     cfg))
    finally:
        for hook in hooks:
            hook.remove()
    return {k: max(v, 1e-6) / 127.0 for k, v in maxes.items()}


def quantize_params(specs, folded_params, act_scales: Dict[str, float]):
    """Folded f32 params (port layout, OIHW) -> mixed params: quantized
    convs carry {"w_q" int8 OIHW, "s_w" (Cout,) f32, "s_x" () f32, "b" f32};
    the head convs pass through unchanged. Bit for bit the JAX package's
    result (with its default ``skip``), transposed."""
    skip = head_conv_layers(specs)
    out = {}
    for i, spec in enumerate(specs):
        key = engine.layer_key(i)
        if key not in folded_params:
            continue
        p = folded_params[key]
        if (isinstance(spec, S.Conv) and i not in skip
                and key in act_scales):
            w = np.asarray(p["w"], np.float32)
            s_w = np.maximum(np.abs(w).max(axis=(1, 2, 3)), 1e-8) / 127.0
            w_q = np.clip(np.round(w / s_w[:, None, None, None]), -127,
                          127).astype(np.int8)
            out[key] = {"w_q": w_q, "s_w": s_w.astype(np.float32),
                        "s_x": np.float32(act_scales[key]),
                        "b": np.asarray(p["b"], np.float32)}
        else:
            out[key] = {k: np.asarray(v) for k, v in p.items()}
    return out


# --------------------------------------------------------------------------
# The all-int8-activation path: int8 tensors between layers

def calibrate_outputs(specs, params, batches, *, cfg,
                      device="cpu") -> Dict[int, float]:
    """Scales of every Conv, Route and Shortcut output, and of the
    normalized input (index -1), for ``apply_int8``: float32 inference of
    the folded ``params`` on ``device`` over the calibration batches, the
    PERCENTILE of |output| per batch, the max over batches, / 127."""
    net = engine.Network(specs, params, device=device)
    maxes: Dict[int, float] = {}

    def record(i, t):
        maxes[i] = max(maxes.get(i, 0.0), _percentile(t))

    with torch.inference_mode():
        for images in batches:
            x = normalize_images(torch.as_tensor(images).to(device), cfg)
            record(-1, x)
            for i, out in enumerate(net.layer_outputs(x)):
                if isinstance(specs[i], (S.Conv, S.Route, S.Shortcut)):
                    record(i, out)
    return {k: max(v, 1e-6) / 127.0 for k, v in maxes.items()}


def int8_params_to(qparams, device) -> dict:
    """The port's int8 params (``quantize_params``: numpy or tensors) as
    tensors on ``device``: int8 and float conv weights in channels-last
    memory, scales and biases float32. Tensors already there are used as
    they are, so ``apply_int8`` may take either."""
    def conv_w(v, dtype):
        t = torch.as_tensor(v).to(device=device, dtype=dtype)
        return (t.contiguous(memory_format=torch.channels_last)
                if t.dim() == 4 else t)

    out = {}
    for key, p in qparams.items():
        q = {}
        for name, v in p.items():
            if name == "w_q":
                q[name] = conv_w(v, torch.int8)
            elif name == "s_x":
                q[name] = float(np.float32(v))
            else:
                q[name] = conv_w(v, torch.float32)
        out[key] = q
    return out


def _requant_from(t, s, s_out):
    """_requant(to_float(t, s), s_out) of the TPU package as XLA compiles
    it: t * f32(s * 1/s_out) for an int8 t (the two constants folded), t *
    f32(1/s_out) for a float one."""
    inv = np.float32(Q8.inv_scale(s_out))
    f = inv if s is None else np.float32(np.float32(s) * inv)
    return Q8.requantize_plain(t, float(f)).contiguous(
        memory_format=torch.channels_last)


def _scalar(v):
    """A float32 scalar as a 0-dim CPU tensor, which an elementwise op on a
    CUDA tensor takes as an argument (no copy to the card, no sync)."""
    return torch.tensor(float(np.float32(v)), dtype=torch.float32)


def _to_float(t, s):
    return t if s is None else t.float() * _scalar(s)


def _add(a, b):
    """to_float(*a) + to_float(*b) as XLA compiles it: the dequantize of an
    int8 operand (the first one where both are) is fused with the add into
    one fma, which ``torch.add(..., alpha=)`` computes on the CPU and the
    card (tests/test_torch_int8act.py and chip_smoke.py hold it to
    ``conv_int8.fma_f32``)."""
    (ta, sa), (tb, sb) = a, b
    if sa is not None:
        return torch.add(_to_float(tb, sb), ta.float(),
                         alpha=float(np.float32(sa)))
    if sb is not None:
        return torch.add(ta, tb.float(), alpha=float(np.float32(sb)))
    return ta + tb


def _conv_int8(spec, p, cur, cur_s, s_out, quantized):
    """One conv of ``apply_int8`` -> (output, its scale or None)."""
    pad = spec.pad if spec.pad >= 0 else spec.size // 2
    if quantized and spec.act in Q8.ACTIVATIONS:
        y = Q8.conv2d_int8_q(cur.contiguous(memory_format=torch.channels_last),
                             cur_s, p["w_q"], p["s_w"], p["b"],
                             stride=spec.stride, pad=pad, act=spec.act,
                             s_out=s_out)
        return y, s_out
    if quantized:
        # an activation the epilogue does not take: the float32-out entry,
        # the activation, then the requantize, as the TPU package orders
        # them
        y = L.activate(Q8.conv2d_int8_q(
            cur.contiguous(memory_format=torch.channels_last), cur_s,
            p["w_q"], p["s_w"], p["b"], stride=spec.stride, pad=pad),
            spec.act)
        return (y, None) if s_out is None else (_requant_from(y, None, s_out),
                                                s_out)
    w = (p["w_q"].float() * p["s_w"].reshape(-1, 1, 1, 1) if "w_q" in p
         else p["w"])
    y = L.activate(L.conv2d(_to_float(cur, cur_s), w, p["b"],
                            stride=spec.stride, pad=pad), spec.act)
    return (y, None) if s_out is None else (_requant_from(y, None, s_out),
                                            s_out)


def apply_int8(specs, qparams, out_scales: Dict[int, float], x_norm, *,
               skip: Optional[set] = None):
    """The all-int8-activation forward: activations stay int8 between
    layers, each with the scale ``calibrate_outputs`` gave its layer.
    x_norm: the normalized float input (B, 3, H, W), channels-last.
    Returns [(feat_nhwc float32, Detect)] per Detect marker, as
    ``engine.Network``. ``apply_int8_layers`` also returns every layer's
    output.

    A conv whose params hold ``w_q`` and whose input is int8 (and which is
    not in ``skip``, by default the head convs) runs ``conv2d_int8_q``: the
    int8-in kernel on a CUDA input, int8 out where the layer has an out
    scale; an activation other than linear or leaky (logistic, ...) is
    applied to the kernel's float32 output and requantized after it. Other
    convs run in float32 (TF32 off) on the dequantized input and
    weights."""
    return apply_int8_layers(specs, qparams, out_scales, x_norm,
                             skip=skip)[0]


def apply_int8_layers(specs, qparams, out_scales: Dict[int, float], x_norm,
                      *, skip: Optional[set] = None):
    """``apply_int8`` -> (detections, every layer's (output, scale)), the
    scale None for a float output."""
    skip = head_conv_layers(specs) if skip is None else skip
    qparams = int8_params_to(qparams, x_norm.device)
    x = x_norm.to(torch.float32)
    x_q = (_requant_from(x, None, out_scales[-1]), out_scales[-1])
    outputs, detections = [], []

    def fetch(ref, i):
        r = S.resolve_ref(ref, i)
        return x_q if r == S.INPUT else outputs[r]

    cur, cur_s = x_q
    for i, spec in enumerate(specs):
        engine.check_supported(spec, i)
        if isinstance(spec, S.Conv):
            p = qparams[engine.layer_key(i)]
            s_out = (out_scales[i] if i in out_scales and i not in skip
                     else None)
            quantized = ("w_q" in p and cur_s is not None
                         and i not in skip)
            with L.exact_f32_convs(x.is_cuda and not quantized):
                cur, cur_s = _conv_int8(spec, p, cur, cur_s, s_out,
                                        quantized)
        elif isinstance(spec, S.MaxPool):
            cur = L.max_pool(cur, spec.size, spec.stride)
        elif isinstance(spec, S.Route):
            parts = [fetch(r, i) for r in spec.refs]
            if len(parts) == 1:
                cur, cur_s = parts[0]
            else:
                cur_s = out_scales[i]
                cur = torch.cat([
                    t if s is not None and abs(s - cur_s) < 1e-12
                    else _requant_from(t, s, cur_s) for t, s in parts], dim=1)
        elif isinstance(spec, S.Shortcut):
            y = _add((cur, cur_s), fetch(spec.ref, i))
            cur_s = out_scales[i]
            cur = _requant_from(y, None, cur_s)
        elif isinstance(spec, (S.Reorg, S.Upsample, S.Detect)):
            cur = engine.apply_unweighted(spec, i, cur, None, [])
            if isinstance(spec, S.Detect):
                detections.append((engine.head_view(_to_float(cur, cur_s)),
                                   spec))
        else:
            # flatten, connected, dropout, pooling, softmax: float32
            cur, cur_s = _to_float(cur, cur_s), None
            if isinstance(spec, S.Dense):
                p = qparams[engine.layer_key(i)]
                cur = L.activate(L.dense(cur, p["w"], p["b"]), spec.act)
            else:
                cur = engine.apply_unweighted(spec, i, cur, x, [])
        outputs.append((cur, cur_s))
    return detections, outputs


def make_int8_forward(cfg, specs, out_scales, **nms_kwargs):
    """The all-int8-activation detection forward, (qparams, uint8 images
    (B, S, S, 3)) -> Detections, on the images' device: normalize,
    ``apply_int8``, then for v2 and v3 heads the fused decode
    (``ops.kernels.decode.decode_fused``) and ``batched_nms_scored``, for
    v1 ``heads.decode_v1`` and ``batched_nms``. At float32 the fused decode
    scores as the TPU package's heads.decode + batched_nms do (its
    docstring says why). ``nms_kwargs``: num_candidates, max_detections,
    conf_threshold, iou_threshold, class_aware_nms."""
    nms_kw = _nms_opts(cfg, nms_kwargs.pop("max_detections", None),
                       nms_kwargs.pop("conf_threshold", None),
                       nms_kwargs.pop("iou_threshold", None),
                       nms_kwargs.pop("class_aware_nms", None),
                       nms_kwargs.pop("num_candidates", 256))
    if nms_kwargs:
        raise TypeError(f"unknown options {sorted(nms_kwargs)}")

    def forward(qparams, images_uint8):
        with torch.inference_mode():
            x = normalize_images(torch.as_tensor(images_uint8), cfg)
            dets = apply_int8(specs, qparams, out_scales, x)
            if cfg.head == 1:
                boxes, conf, probs = heads.decode(dets, cfg)
                return NMS.batched_nms(heads.xywh_to_xyxy(boxes), conf,
                                       probs, **nms_kw)
            return NMS.batched_nms_scored(*K.decode_fused(dets, cfg),
                                          **nms_kw)

    return forward
