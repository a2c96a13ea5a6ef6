"""Primitive ops in PyTorch, for inference and training.

Counterpart of yolo_tensorflow_tpu/ops/layers.py for the layers the v1, v2
and v3 detectors and the darknet19 classifier run. Tensors here are NCHW
in ``torch.channels_last`` memory format (the NHWC bytes of the TPU
package, so a permute to NHWC is free), conv weights are OIHW and
connected weights (In, Out). Convolution goes to cuDNN through
``F.conv2d`` and ``dense`` to cuBLAS through ``torch.matmul``: both were
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


@contextlib.contextmanager
def exact_f32_convs(enabled: bool = True):
    """Context in which cuDNN runs float32 convolutions, forward and
    backward, and cuBLAS float32 matrix products (``dense``) in full
    float32, not TF32 (the TPU package forces Precision.HIGHEST in its
    float32 parity mode for the same reason). cuDNN's default is TF32;
    cuBLAS's is full float32, and is set here all the same.
    ``enabled=False`` changes nothing."""
    if not enabled:
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    tf32 = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = tf32


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
    -inf. ``F.max_pool2d`` alone would pad symmetrically. An int8 x (the
    all-int8-activation path) pools in bfloat16, which holds every int8
    value exactly, and comes back as int8: ``F.max_pool2d`` does not take
    int8, and every window holds at least one value of x, so the -inf
    padding never reaches the output."""
    if x.dtype == torch.int8:
        return max_pool(x.to(torch.bfloat16), size, stride).to(torch.int8)
    if stride != size:
        pads = []
        for n in (x.shape[3], x.shape[2]):            # F.pad order: W, H
            out = -(-n // stride)
            total = max((out - 1) * stride + size - n, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, size, stride)


def upsample_nearest(x, factor=2):
    """Nearest-neighbour integer upsample (darknet's upsample layer). A
    floating x goes through ``F.interpolate``; any other dtype (int8 on the
    all-int8-activation path) through a broadcast copy of its NHWC view,
    which returns channels-last."""
    if x.is_floating_point():
        return F.interpolate(x, scale_factor=factor, mode="nearest")
    b, c, h, w = x.shape
    v = x.permute(0, 2, 3, 1)[:, :, None, :, None, :]
    v = v.expand(b, h, factor, w, factor, c).reshape(b, h * factor,
                                                     w * factor, c)
    return v.permute(0, 3, 1, 2)


def space_to_depth(x, block=2):
    """Reorg with tf.space_to_depth's channel order, on NCHW x:
    out[b, (di*block + dj)*C + c, i, j] = x[b, c, block*i + di, block*j + dj]
    (what the reference's TF graphs compute). Returns channels-last."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, block * block * c, h // block, w // block).contiguous(
        memory_format=torch.channels_last)


def darknet_reorg(x, stride=2):
    """Darknet's actual reorg (src/blas.c reorg_cpu, forward = 0), which is
    neither ``space_to_depth`` nor ``F.pixel_unshuffle``. The C code
    reinterprets the input's CHW buffer (C, H, W) as (C/s^2, H*s, W*s),
    gathers

      mid[k, j, i] = view[k % (C/s^2), j*s + (k // (C/s^2)) // s,
                                       i*s + (k // (C/s^2)) % s]

    and reinterprets mid's buffer as (C*s^2, H/s, W/s). Darknet-trained
    weights of the conv after the passthrough expect this channel order.

    x is (B, C, H, W) in any memory format. The buffer the C code
    reinterprets is the CHW one, so x is first laid out truly NCHW (one
    copy of a channels-last x); mid's channels k = off*(C/s^2) + c2 are s^2
    strided slices of the view, one per off, concatenated. Returns
    channels-last, as every layer here does."""
    b, c, h, w = x.shape
    s = stride
    view = x.contiguous().reshape(b, c // (s * s), h * s, w * s)
    mid = torch.cat([view[:, :, off // s::s, off % s::s]
                     for off in range(s * s)], dim=1)          # (B, C, H, W)
    return mid.reshape(b, c * s * s, h // s, w // s).contiguous(
        memory_format=torch.channels_last)


def transpose_flatten(x):
    """(B, C, H, W) -> (B, C*H*W) in C, H, W order: YOLOv1's connected-head
    input layout (the TPU package transposes its NHWC to NCHW first; here
    the logical order is NCHW already, and the reshape copies a
    channels-last x into it)."""
    return x.reshape(x.shape[0], -1)


def dense(x, w, b, act=None):
    """Fully connected: x (B, In) @ w (In, Out) + b, the TPU package's
    layout. w is rounded to x's dtype first, the products are summed in
    float32 and the result is float32 whatever x's dtype, as the TPU
    package's ``preferred_element_type`` gives it: a bf16 x and w widen to
    float32 exactly, so one float32 product computes the same sums."""
    wide = torch.promote_types(x.dtype, torch.float32)
    out = torch.matmul(x.to(wide), w.to(x.dtype).to(wide)) + b.to(wide)
    return out if act is None else act(out)


def connected_forward(x, p, act, *, bn_eps, bn_stats: str = "twopass"):
    """Train-mode forward_connected_layer (src/connected_layer.c): x (B, In)
    @ w (In, Out), then batch norm over the batch with the layer's biases as
    its beta (``p`` = {"w", "gamma", "beta"}) or a bias add (``p`` = {"w",
    "b"}), then the activation. Returns (y, {"mean", "var"} or None).
    ``bn_stats`` is batch_norm_train's twopass or onepass form. Inference
    with unfolded connected BN is not ported: ``io.weights`` folds it."""
    if "gamma" not in p:
        return activate(dense(x, p["w"], p["b"]), act), None
    check_bn_stats(bn_stats)
    wide = torch.promote_types(x.dtype, torch.float32)
    y = torch.matmul(x.to(wide), p["w"].to(x.dtype).to(wide))
    mean = y.mean(dim=0)
    if bn_stats == "twopass":
        var = torch.var(y, dim=0, correction=0)
    else:
        var = torch.clamp((y * y).mean(dim=0) - mean * mean, min=0.0)
    inv = p["gamma"] * torch.rsqrt(var + bn_eps)
    y = y * inv + (p["beta"] - mean * inv)
    return activate(y, act), {"mean": mean, "var": var}


def dropout(x, rate: float, generator: torch.Generator):
    """Train-mode dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), else 0. The mask is drawn from ``generator``
    (on x's device), where the TPU package draws it from a JAX PRNG key: the
    same distribution, not the same draw."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)
