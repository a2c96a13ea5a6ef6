"""Operations and bytes of a configuration's convolutions, from its shapes,
and the table of the card's peaks.

Frozen here so that later changes to the program cannot move the
yardstick. A convolution's operations are 2 per multiply-add; its bytes
count each input byte read once, the weights, per-channel scales and bias
(8 bytes a channel) read once, and each output byte written once, whatever
the kernel reads again.
"""

from __future__ import annotations

from typing import NamedTuple

from weights import conv_shapes

# NVIDIA H100 SXM (data sheet, dense, at its 700 W power limit)
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
HBM_BYTES_S = 3.35e12


class Conv(NamedTuple):
    index: int
    cin: int
    cout: int
    k: int
    stride: int
    h: int          # input side
    ho: int         # output side


def convs(cfg):
    """Every convolution of the configuration at its input size."""
    out = []
    for i, cin, cout, k, s, h in conv_shapes(cfg["layers"],
                                             cfg["input_size"]):
        out.append(Conv(i, cin, cout, k, s, h, (h + 2 * (k // 2) - k) // s
                        + 1))
    return out


def head_convs(cfg) -> set:
    return {i - 1 for i, lay in enumerate(cfg["layers"])
            if lay["type"] == "detect"}


def int8_convs(cfg):
    """The convolutions the int8 path quantizes: all but the heads'."""
    skip = head_convs(cfg)
    return [c for c in convs(cfg) if c.index not in skip]


def ops(c: Conv, batch: int) -> float:
    return 2.0 * batch * c.ho * c.ho * c.cout * c.k * c.k * c.cin


def nbytes(c: Conv, batch: int, in_bytes: int, w_bytes: int,
           out_bytes: int) -> float:
    return (batch * c.h * c.h * c.cin * in_bytes
            + c.cout * c.k * c.k * c.cin * w_bytes + 8 * c.cout
            + batch * c.ho * c.ho * c.cout * out_bytes)


def bound_s(c: Conv, batch: int, precision: str, in_bytes: int,
            w_bytes: int, out_bytes: int):
    """(the least seconds the card could take, "bytes" or "ops")."""
    t_b = nbytes(c, batch, in_bytes, w_bytes, out_bytes) / HBM_BYTES_S
    t_o = ops(c, batch) / PEAK_OPS[precision]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "ops")


def int8_bound_s(cfg, batch: int):
    """{"total", "bytes", "ops"}: seconds of the int8 convolutions' bound at
    ``batch`` (bf16 in and out, int8 weights), split by what bounds each."""
    out = {"total": 0.0, "bytes": 0.0, "ops": 0.0}
    for c in int8_convs(cfg):
        t, by = bound_s(c, batch, "int8", 2, 1, 2)
        out["total"] += t
        out[by] += t
    return out


def forward_flops(cfg) -> float:
    """The forward's convolution operations for one image."""
    return sum(ops(c, 1) for c in convs(cfg))


def forward_peak_s(cfg) -> float:
    """Seconds one image's convolutions take at the peak of the precision
    each runs in on the int8 path: the quantized convolutions at the int8
    peak, the head convolutions at bf16's."""
    skip = head_convs(cfg)
    return sum(ops(c, 1) / PEAK_OPS["bf16" if c.index in skip else "int8"]
               for c in convs(cfg))
