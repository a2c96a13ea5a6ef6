"""Int8 (w8a8) post-training quantization, host side.

Counterpart of yolo_tensorflow_tpu/ops/quant.py for the mixed serving path:
per-output-channel symmetric weight scales s_w[o] = max|w[o]| / 127, a
static per-conv input scale s_x = calibrated range / 127, head convs kept
in float. ``engine.Network`` runs a conv whose params hold ``w_q`` through
the int8 kernel (``ops/kernels/conv_int8``); everything between convs stays
in the compute dtype. The all-int8-activation alternative
(``calibrate_outputs``, ``apply_int8``, ``make_int8_forward``) is not
ported yet (ROADMAP.md, 'int8').
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from yolo_tensorflow_tpu_torch.models import engine
from yolo_tensorflow_tpu_torch.models import specs as S
from yolo_tensorflow_tpu_torch.pipeline import normalize_images

PERCENTILE = 99.9       # of |conv input|, per calibration batch


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
            x = args[0].permute(0, 2, 3, 1)          # NHWC, as JAX sees it
            v = float(np.percentile(np.abs(np.asarray(x.float().cpu(),
                                                      np.float32)),
                                    PERCENTILE))
            maxes[key] = max(maxes.get(key, 0.0), v)
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
