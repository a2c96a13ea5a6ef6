"""The plain reference of a darknet detector served at w<b>a<b> with
bfloat16 compute: its forward pass.

A straightforward interpreter of a configuration's ``layers`` (the darknet
cfg written out as JSON in ``benchmark/configs``): convolution with
darknet's ``size // 2`` padding, batch norm folded into it, leaky
activation, shortcut, route, nearest upsample, max pool and darknet's
reorg. It imports nothing of the program under test and takes nothing the
program has made: the batch norm fold and the integer weights are worked
out here again from the seeded darknet-form weights.

The arithmetic is the configuration's, step by step (``Precision``):

* activations are bfloat16 from the normalized input on;
* every convolution but the heads' takes its input rounded to b-bit
  integers at one static scale (``act_scale`` for 8 bits, the same
  clipping range for fewer) and its weights at b bits with one scale per
  output channel; the integer sum is exact; the epilogue is bfloat16, each
  step rounded: the sum times the two scales' product, plus the bias, then
  leaky with its slope held in bfloat16;
* a head convolution takes bfloat16 operands and bias, sums in float32
  with TF32 off (``exact_f32``) and rounds once to bfloat16.

Every quotient is a true division: on the card PyTorch multiplies by the
reciprocal of a Python number, which rounds otherwise, so each divisor is a
tensor (``scalar``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
LEAKY = 0.1


class Precision(NamedTuple):
    bits: int = 8               # the width of the quantized convolutions
    act_scale: float = 0.05     # the 8-bit activation scale

    @classmethod
    def parse(cls, name: str, act_scale: float = 0.05) -> "Precision":
        if not name.startswith("int"):
            raise ValueError(f"unknown precision {name!r}")
        return cls(int(name[3:]), act_scale)


@contextlib.contextmanager
def exact_f32():
    """float32 convolutions and matrix products without TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def resolve(ref: int, i: int) -> int:
    """A route or shortcut reference at layer i as an absolute index."""
    return i + ref if ref < 0 else ref


def head_convs(layers) -> set:
    """Indices of the convolutions that feed a detect layer."""
    return {i - 1 for i, lay in enumerate(layers) if lay["type"] == "detect"}


def scalar(v, like):
    """v as a float32 0-dim tensor on ``like``'s device."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def fold(p: dict, bn_eps: float) -> dict:
    """Darknet-form weights of one conv -> {"w", "b"}: batch norm folded
    as gamma / sqrt(var + eps) onto the output channels."""
    if "gamma" not in p:
        return {"w": p["w"], "b": p["b"]}
    inv = p["gamma"] / torch.sqrt(p["var"] + scalar(bn_eps, p["var"]))
    return {"w": p["w"] * inv[:, None, None, None],
            "b": p["beta"] - p["mean"] * inv}


def quantize_int(t, scale, qmax):
    """clamp(round(t / scale), -qmax, qmax), halves to even."""
    return torch.clamp(torch.round(t / scale), -qmax, qmax)


def int_sum(xq, wq, stride, pad):
    """The exact sum of the convolution of integer-valued xq and wq: in
    float64, where every partial sum is an integer far below 2**53, and
    without cuDNN, whose transform algorithms (Winograd, FFT) round;
    PyTorch's own convolution is im2col and a matrix product."""
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(xq.double(), wq.double(), stride=stride,
                        padding=pad)


def column(v):
    return v.reshape(1, -1, 1, 1)


def conv(x, p, lay, prec: Precision, head: bool):
    """One convolution of folded weights p on bfloat16 x, then its
    activation; bfloat16 out."""
    k, s = lay["size"], lay["stride"]
    pad = k // 2
    w, b = p["w"], p["b"]
    if head:
        y = F.conv2d(x.float(), w.to(BF16).float(), b.to(BF16).float(),
                     stride=s, padding=pad).to(BF16)
    else:
        qmax = 2 ** (prec.bits - 1) - 1
        s_x = scalar(prec.act_scale * (127 / qmax), x)
        s_w = w.abs().amax(dim=(1, 2, 3)).clamp(min=1e-8) / scalar(qmax, w)
        xq = quantize_int(x.float(), s_x, qmax)
        wq = quantize_int(w, s_w[:, None, None, None], qmax)
        acc = int_sum(xq, wq, s, pad).float()
        y = acc.to(BF16) * column((s_x * s_w).to(BF16)) + column(b.to(BF16))
    if lay["act"] == "leaky":
        y = torch.maximum(y * torch.tensor(LEAKY, dtype=BF16), y)
    elif lay["act"] != "linear":
        raise ValueError(f"activation {lay['act']!r} is not in the "
                         "reference")
    return y


def maxpool(x, size, stride):
    if size == stride:
        return F.max_pool2d(x, size, stride)
    # darknet's stride-1 pool pads at the end only
    pads = []
    for n in (x.shape[3], x.shape[2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + size - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), size, stride)


def reorg(x, s):
    """darknet's reorg_cpu (forward = 0): the (C, H, W) buffer read as
    (C / s^2, H s, W s), gathered and read back as (C s^2, H / s, W / s)."""
    b, c, h, w = x.shape
    view = x.contiguous().reshape(b, c // (s * s), h * s, w * s)
    mid = torch.cat([view[:, :, off // s::s, off % s::s]
                     for off in range(s * s)], dim=1)
    return mid.reshape(b, c * s * s, h // s, w // s)


def outputs(layers, folded, x, prec: Precision = Precision()):
    """Every layer's output, in layer order, of a normalized bfloat16 input
    x (B, 3, S, S); a detect layer hands its input on. ``folded`` maps a
    layer index to its folded {"w", "b"}. Outputs no later layer reads are
    dropped as the pass goes."""
    last_use = {}
    for i, lay in enumerate(layers):
        refs = ([lay["from"]] if lay["type"] == "shortcut"
                else lay.get("layers", []))
        for r in refs:
            last_use[resolve(r, i)] = i
    heads_at = head_convs(layers)
    outs = {}
    cur = x
    for i, lay in enumerate(layers):
        t = lay["type"]
        if t == "conv":
            cur = conv(cur, folded[i], lay, prec, i in heads_at)
        elif t == "shortcut":
            cur = cur + outs[resolve(lay["from"], i)]
        elif t == "route":
            parts = [outs[resolve(r, i)] for r in lay["layers"]]
            cur = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        elif t == "upsample":
            cur = F.interpolate(cur, scale_factor=lay["stride"],
                                mode="nearest")
        elif t == "maxpool":
            cur = maxpool(cur, lay["size"], lay["stride"])
        elif t == "reorg":
            cur = reorg(cur, lay["stride"])
        elif t != "detect":
            raise ValueError(f"layer type {t!r} is not in the reference")
        if last_use.get(i, -1) > i:
            outs[i] = cur
        for j in [j for j, u in last_use.items() if u == i and j in outs]:
            del outs[j]
        yield cur


def forward(layers, folded, x, prec: Precision = Precision()):
    """The heads of a normalized bfloat16 input x (B, 3, S, S): [(raw map
    (B, A*(5+C), G, G) in bfloat16, anchor mask)] in layer order."""
    return [(out, lay["mask"]) for lay, out in
            zip(layers, outputs(layers, folded, x, prec))
            if lay["type"] == "detect"]
