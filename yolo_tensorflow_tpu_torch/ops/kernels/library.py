"""The serving kernels as PyTorch operators, in the namespace ``yolo_torch``.

Each kernel wrapper (decode, greedy NMS, the int8 conv and its quantize
prologue) defines one operator here with three implementations: CUDA, which
launches the hand-written kernel through ctypes (and counts the launch);
CPU, which is the kernel's plain PyTorch version; and a fake one, which
gives the outputs' shapes, dtypes and strides from the inputs alone and
launches nothing. The dispatcher picks by the device of the inputs, so a
CUDA tensor reaches the kernel or raises, and never the plain version.

As operators the kernels can be traced: ``torch.export`` records a call of
``torch.ops.yolo_torch.<name>`` in the exported program (export.py), and
that program launches the kernel when it runs on the card. Arguments are
tensors, lists of tensors and scalars only; every host-side plan (tiles,
kernel instance, alignment) is made inside the CUDA implementation, from
the real tensors.

The registration is ``torch.library.Library`` ``define`` + ``impl``, the
lighter of PyTorch's two (``torch.library.custom_op`` wraps each call in
more Python). Its host time still shows where the card is fast: on an H100
(PERF.md) the int8 yolov3-416 forward, 74 operator calls, lost 3-17 % of
its img/s at batch 8 against calling the implementations directly, and
nothing at batch 64. An implementation never returns a view of an input.
"""

from __future__ import annotations

import torch

NAMESPACE = "yolo_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, *, cpu, cuda, fake):
    """Define the operator ``yolo_torch::<name>`` of ``schema`` with its CPU,
    CUDA and fake implementations; returns its overload packet's default,
    the callable the wrappers use."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
