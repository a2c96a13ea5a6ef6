"""Primitive ops in PyTorch, for inference and training.

Counterpart of yolo_tensorflow_tpu/ops/layers.py for the layers the v3
family runs. Tensors here are NCHW in ``torch.channels_last`` memory format
(the NHWC bytes of the TPU package, so a permute to NHWC is free) and conv
weights are OIHW. Convolution goes to cuDNN through ``F.conv2d``: it was
XLA's on the TPU, never a Pallas kernel.
"""

from __future__ import annotations

import contextlib

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


def exact_f32_convs(enabled: bool = True):
    """Context in which cuDNN runs float32 convolutions, forward and
    backward, in full float32: it otherwise runs them in TF32 (the TPU
    package forces Precision.HIGHEST in its float32 parity mode for the same
    reason). The port's paths run no matmul. ``enabled=False`` changes
    nothing."""
    if not enabled:
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def is_narrow(dtype) -> bool:
    """Whether a compute dtype is a mixed-precision one (bf16, f16)."""
    return dtype is not None and torch.finfo(dtype).bits < 32


def conv2d(x, w, b=None, *, stride=1, pad=None, compute_dtype=None,
           train=False, out_dtype=None):
    """Conv with darknet explicit padding (size//2 per side by default).
    x (B, Cin, H, W), w (Cout, Cin, kh, kw), b (Cout,) or None. Without a
    ``compute_dtype`` the output has x's dtype; cuDNN accumulates narrow
    types in float32.

    ``compute_dtype`` casts x and w first. ``train=True`` with a narrow
    compute dtype is the mixed-precision training form of the TPU package:
    the conv output is materialized in the compute dtype (one rounding of
    the float32 accumulator), then cast to ``out_dtype`` (None: float32)
    before the bias is added in that dtype."""
    padding = w.shape[-1] // 2 if pad is None else pad
    if not train or not is_narrow(compute_dtype):
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        return F.conv2d(x, w, None if b is None else b.to(x.dtype),
                        stride=stride, padding=padding)
    out = F.conv2d(x.to(compute_dtype), w.to(compute_dtype), stride=stride,
                   padding=padding).to(out_dtype or torch.float32)
    return out if b is None else out + b.to(out.dtype).view(1, -1, 1, 1)


def check_bn_stats(stats: str):
    """Raise for a bn_stats form the port does not run."""
    if stats == "onepass_bf16" or stats.startswith("ghost"):
        raise NotImplementedError(
            f"bn_stats={stats!r} is left out of the port (ROADMAP.md, Queue "
            "1 item 14: an accuracy verdict of the reference)")
    if stats not in ("twopass", "onepass"):
        raise ValueError(f"unknown bn_stats {stats!r} (supported: twopass, "
                         "onepass)")


def batch_norm_train(x, gamma, beta, eps, *, stats: str = "twopass",
                     sums=None):
    """Training-mode BN over (B, H, W). Returns (y, batch_mean, batch_var),
    the statistics in float32 (float64 for a float64 x). Not
    ``F.batch_norm``: the variance is biased and the normalization is the
    TPU package's, y = x * inv + (beta - mean * inv) in x's dtype with
    inv = gamma * rsqrt(var + eps).

    'twopass' is darknet's exact variance, E[(x - mean)^2]; 'onepass' is
    E[x^2] - E[x]^2, clamped at 0. ``sums`` = (sum, sum of squares) per
    channel, when the conv that produced x already reduced them
    (ops/kernels/conv_bnstat), replaces the reductions that read x: the
    mean always, and under onepass x is not read for statistics at all."""
    check_bn_stats(stats)
    n = x.numel() // x.shape[1]
    dims = (0, 2, 3)
    if sums is not None and stats == "onepass":
        mean, var = sums[0] / n, sums[1] / n
    else:
        xw = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xw.mean(dim=dims) if sums is None else sums[0] / n
        var = (torch.var(xw, dim=dims, correction=0) if stats == "twopass"
               else (xw * xw).mean(dim=dims))
    if stats == "onepass":
        var = torch.clamp(var - mean * mean, min=0.0)
    inv = gamma * torch.rsqrt(var + eps)
    y = (x * inv.to(x.dtype).view(1, -1, 1, 1)
         + (beta - mean * inv).to(x.dtype).view(1, -1, 1, 1))
    return y, mean, var


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
