"""Primitive inference ops in PyTorch.

Counterpart of yolo_tensorflow_tpu/ops/layers.py for the layers the v3
family runs. Tensors here are NCHW in ``torch.channels_last`` memory format
(the NHWC bytes of the TPU package, so a permute to NHWC is free) and conv
weights are OIHW. Convolution goes to cuDNN through ``F.conv2d``: it was
XLA's on the TPU, never a Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def leaky_relu(x, alpha=0.1):
    """LEAKY activation, alpha=0.1 everywhere in darknet. alpha is held in
    x's dtype, as JAX's weak-typed scalar is: in bf16 that multiplies by
    bf16(0.1) = 0.10009765625, where a Python float would multiply by 0.1
    in f32 and round another 10 % of the outputs differently."""
    return torch.maximum(x * torch.tensor(alpha, dtype=x.dtype), x)


def activate(x, name: str):
    """Darknet activation by name: leaky alpha=.1, logistic, relu, tanh,
    linear. Unknown names raise."""
    if name == "leaky":
        return leaky_relu(x)
    if name == "logistic":
        return torch.sigmoid(x)
    if name == "relu":
        return torch.relu(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "linear":
        return x
    raise ValueError(f"unsupported activation {name!r} "
                     "(supported: leaky, logistic, relu, tanh, linear)")


def conv2d(x, w, b=None, *, stride=1, pad=None):
    """Conv with darknet explicit padding (size//2 per side by default).
    x (B, Cin, H, W), w (Cout, Cin, kh, kw), b (Cout,) or None. The output
    has x's dtype; cuDNN accumulates narrow types in float32."""
    k = w.shape[-1]
    return F.conv2d(x, w, b, stride=stride, padding=k // 2 if pad is None
                    else pad)


def max_pool(x, size=2, stride=2):
    """Max pool. stride == size is VALID; stride < size (the tiny models'
    stride-1 size-2 pool) is XLA's SAME, which pads at the END only, with
    -inf. ``F.max_pool2d`` alone would pad symmetrically."""
    if stride != size:
        pads = []
        for n in (x.shape[3], x.shape[2]):            # F.pad order: W, H
            out = -(-n // stride)
            total = max((out - 1) * stride + size - n, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, size, stride)


def upsample_nearest(x, factor=2):
    """Nearest-neighbour integer upsample (darknet's upsample layer)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")
