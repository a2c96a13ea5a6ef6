"""Int8 (w8a8) convolution: the CUDA kernel and its plain twin.

Counterpart of yolo_tensorflow_tpu/ops/quant.conv2d_int8, with the
activation fused: quantize the input with its static scale s_x, convolve
int8 x int8 with exact int32 accumulation, dequantize with s_x * s_w[o],
add the bias, apply linear or leaky, all in ``epilogue_dtype``. On the TPU
XLA emitted that conv; tools/probe_int8_3x3.py holds three Pallas versions
of its accumulator. The kernels are in ``csrc/conv_int8.cu`` (its header
says what bounds them and how they are laid out): a quantize pass into an
int8 scratch tensor, then the wgmma implicit GEMM with the fused epilogue;
the first conv (Cin = 3, 3x3 or 7x7) takes a direct kernel instead, after
the quantize pass at 7x7. PyTorch has no
int8 convolution on CUDA, so there is no library call that computes this.

Layouts are the port's: x is NCHW in channels-last memory (the NHWC bytes),
w_q is OIHW int8 in channels-last memory (the (Cout, kh, kw, Cin) bytes the
kernel reads), s_w and b are (Cout,) float32 and s_x is a host scalar.

``conv2d_int8_q`` is the int8-in entry, the conv of the TPU package's
all-int8-activation path (ops/quant.apply_int8): int8 activations in,
with their scale s_in, no quantize pass, and the epilogue fmaf(acc, s_in *
s_w, b), leaky, then int8 out requantized with s_out (or float32 out where
the layer keeps no out scale). It has its own count, ``launches_q``.

Dispatch is by the device of the input: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version. ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from yolo_tensorflow_tpu_torch.ops import layers as L
from yolo_tensorflow_tpu_torch.ops.kernels import build, igemm

launches = 0
launches_q = 0

ACTIVATIONS = ("linear", "leaky")
KSIZES = (1, 3, 7)
EPILOGUE_DTYPES = (torch.float32, torch.bfloat16)


def check_geometry(k: int, stride: int, pad: int, act: str) -> None:
    """Raise NotImplementedError for a conv the int8 kernel does not take:
    square k in KSIZES, stride in {1, 2}, darknet padding k // 2, linear or
    leaky in the epilogue (``engine.QuantConv`` applies any other
    activation after a linear epilogue)."""
    if k not in KSIZES or stride not in (1, 2) or pad != k // 2:
        raise NotImplementedError(
            f"int8 conv takes k in {KSIZES}, stride in (1, 2) and padding "
            f"k // 2, not k={k} stride={stride} pad={pad} (ROADMAP.md, "
            "'int8')")
    if act not in ACTIVATIONS:
        raise NotImplementedError(
            f"int8 conv fuses {ACTIVATIONS} into its epilogue, not {act!r} "
            "(ROADMAP.md, 'int8')")


def int8_accumulate(xq, w_q, *, stride: int = 1, pad: int = 0):
    """Exact int32 accumulator of an int8 conv: xq (B, Cin, H, W) and w_q
    (Cout, Cin, k, k), integer-valued tensors of any dtype. The conv runs in
    float64, which holds every product and partial sum exactly while
    |acc| < 2**53 (an int8 conv stays below 2**31)."""
    return F.conv2d(xq.double(), w_q.double(), stride=stride,
                    padding=pad).to(torch.int32)


def quantize_act_plain(x, s_x):
    """clamp(round(x / s_x), -127, 127) as int8, the division in float32 and
    halves to even: yolo_tensorflow_tpu/ops/quant.conv2d_int8's quantize."""
    s = torch.tensor(float(s_x), dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def quantize_act(x, s_x):
    """The int8 conv's prologue on its own: x (float32 or bfloat16,
    contiguous in its memory format) quantized to int8 with scale s_x, in
    x's shape and layout. The kernel on CUDA, the plain version on the CPU.
    ``conv2d_int8`` runs the same pass itself; this entry exists to test and
    time it, and does not count as a launch of the conv."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_act takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.device.type == "cpu":
        return quantize_act_plain(x, s_x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_act runs on cpu or cuda, not {x.device}")
    q = torch.empty_like(x, dtype=torch.int8)
    if q.stride() != x.stride():
        raise ValueError("quantize_act needs x dense in its memory format")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = build.load().yolo_quantize_act(
            x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
            x.numel(), float(s_x), stream)
    if err != 0:
        raise RuntimeError(f"quantize_act kernel launch failed: CUDA error "
                           f"{err}")
    return q


def _column(v, dtype):
    return v.to(dtype).reshape(1, -1, 1, 1)


def conv2d_int8_plain(x, w_q, s_x, s_w, b, *, stride: int = 1,
                      pad: int = None, act: str = "linear",
                      epilogue_dtype=torch.float32):
    """Plain PyTorch version of ``conv2d_int8``, on any device.

    f32 epilogue: one fma, fma_f32(acc, sc, b), as the kernel and JAX's
    compiled program round it. bf16 epilogue: bf16 tensor ops rounding
    after each step, as the kernel and JAX do."""
    k = w_q.shape[-1]
    pad = k // 2 if pad is None else pad
    s = torch.tensor(float(s_x), dtype=torch.float32, device=x.device)
    xq = quantize_act_plain(x, s_x)
    acc = int8_accumulate(xq, w_q, stride=stride, pad=pad).float()
    sc = s * s_w.float()                       # f32, as the JAX epilogue
    if epilogue_dtype == torch.float32:
        y = fma_f32(acc, _column(sc, torch.float32),
                    _column(b, torch.float32))
    else:
        y = (acc.to(epilogue_dtype) * _column(sc, epilogue_dtype)
             + _column(b, epilogue_dtype))
    if act == "leaky":
        y = L.leaky_relu(y)
    return y.contiguous(memory_format=torch.channels_last)


def _check(x, w_q, s_w, b, stride, pad, act, epilogue_dtype,
           x_dtypes=(torch.float32, torch.bfloat16)):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8 conv runs on cpu or cuda, not {x.device}")
    if x.dtype not in x_dtypes:
        raise TypeError(f"this int8 conv takes {x_dtypes} input, not "
                        f"{x.dtype}")
    if epilogue_dtype not in EPILOGUE_DTYPES:
        raise TypeError(f"int8 conv epilogue is float32 or bfloat16, not "
                        f"{epilogue_dtype}")
    if (w_q.dtype != torch.int8 or w_q.dim() != 4
            or w_q.shape[2] != w_q.shape[3]):
        raise ValueError(f"w_q must be int8 (Cout, Cin, k, k), got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    check_geometry(w_q.shape[-1], stride, pad, act)
    if x.dim() != 4 or x.shape[1] != w_q.shape[1]:
        raise ValueError(f"input {tuple(x.shape)} is not (B, "
                         f"{w_q.shape[1]}, H, W)")
    for name, t in (("x", x), ("w_q", w_q)):
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"int8 conv needs {name} in channels-last "
                             "memory (NHWC / OHWI bytes)")
    cout = w_q.shape[0]
    for name, t in (("s_w", s_w), ("b", b)):
        if (t.dtype != torch.float32 or t.shape != (cout,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 ({cout},)")
    for t in (w_q, s_w, b):
        if t.device != x.device:
            raise ValueError("int8 conv operands must share the input's "
                             "device")


def conv2d_int8(x, w_q, s_x, s_w, b, *, stride: int = 1, pad: int = None,
                act: str = "linear", epilogue_dtype=torch.float32):
    """Quantize x with s_x, int8 conv with w_q (int32 accumulation),
    dequantize with s_x * s_w, add b, apply ``act``; the result is
    (B, Cout, Ho, Wo) in channels-last memory, in ``epilogue_dtype``."""
    k = w_q.shape[-1]
    pad = k // 2 if pad is None else pad
    _check(x, w_q, s_w, b, stride, pad, act, epilogue_dtype)
    if x.device.type == "cpu":
        return conv2d_int8_plain(x, w_q, s_x, s_w, b, stride=stride, pad=pad,
                                 act=act, epilogue_dtype=epilogue_dtype)
    return _launch(x, w_q, float(s_x), s_w, b, stride, pad, act,
                   epilogue_dtype)


def plan(x, w_q):
    """(instance, BN) of the kernel that a CUDA x and w_q launch: the wgmma
    main loop fed by cp.async (``wgmma``) or element by element
    (``gather``), both after the quantize pass, or the direct first-conv
    kernel (after the pass at 7x7, where BN is its Cout tile). The pass
    writes an aligned scratch tensor, so of the operands only the weights'
    alignment matters."""
    cout, cin, k = w_q.shape[0], w_q.shape[1], w_q.shape[-1]
    return (igemm.pick_instance(cin, cout, k, 1, w_q.data_ptr() % 16 == 0),
            igemm.pick_bn(cout, 1))


def _launch(x, w_q, s_x, s_w, b, stride, pad, act, epilogue_dtype):
    global launches
    batch, cin, h, w = x.shape
    cout, k = w_q.shape[0], w_q.shape[-1]
    y = torch.empty((batch, cout, (h + 2 * pad - k) // stride + 1,
                     (w + 2 * pad - k) // stride + 1), dtype=epilogue_dtype,
                    device=x.device, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    instance, bn = plan(x, w_q)
    # the quantize pass's output, the GEMM's A operand (NHWC int8); the 3x3
    # direct kernel quantizes in registers and takes none
    xq = (None if instance == "direct" and k == 3 else
          torch.empty(x.numel(), dtype=torch.int8, device=x.device))
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.yolo_conv2d_int8(
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            None if xq is None else xq.data_ptr(), w_q.data_ptr(), s_x,
            s_w.data_ptr(), b.data_ptr(), y.data_ptr(),
            int(epilogue_dtype == torch.bfloat16), batch, h, w, cin, cout, k,
            stride, pad, int(act == "leaky"), igemm.INSTANCES[instance], bn,
            stream)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y


# ---------------------------------------------------------- the int8-in entry

def fma_f32(a, b, c):
    """a * b + c rounded once to float32, as one fmaf: a, b and c float32
    tensors (broadcasting), on any device. The product is exact in float64;
    the sum is rounded to odd in float64 (TwoSum, then one step toward the
    rounding error where the result is even), which a second rounding to
    float32 turns into the correctly rounded sum."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def inv_scale(s_out) -> float:
    """f32(1 / f32(s_out)): XLA compiles the TPU package's ``y / s_out`` by
    a constant into a multiply by this."""
    return float(np.float32(1.0) / np.float32(s_out))


def requantize_plain(y, factor: float):
    """clamp(rint(y * factor), -127, 127) as int8, the product in float32:
    with factor = inv_scale(s_out), the TPU package's ``_requant(y, s_out)``
    as its compiled program runs it. The factor is a 0-dim CPU tensor, so a
    CUDA y takes it with no copy to the card."""
    f = torch.tensor(factor, dtype=torch.float32)
    return torch.clamp(torch.round(y.float() * f), -127, 127).to(torch.int8)


def conv2d_int8_q_plain(xq, s_in, w_q, s_w, b, *, stride: int = 1,
                        pad: int = None, act: str = "linear", s_out=None):
    """Plain PyTorch version of ``conv2d_int8_q``, on any device, rounding
    as the kernel does: the exact accumulator, one fma (``fma_f32``), leaky
    in float32, the requantize of ``requantize_plain``."""
    k = w_q.shape[-1]
    pad = k // 2 if pad is None else pad
    acc = int8_accumulate(xq, w_q, stride=stride, pad=pad).float()
    sc = torch.tensor(float(np.float32(s_in)),
                      dtype=torch.float32) * s_w.float()
    y = fma_f32(acc, _column(sc, torch.float32), _column(b, torch.float32))
    if act == "leaky":
        y = L.leaky_relu(y)
    if s_out is not None:
        y = requantize_plain(y, inv_scale(s_out))
    return y.contiguous(memory_format=torch.channels_last)


def conv2d_int8_q(xq, s_in, w_q, s_w, b, *, stride: int = 1,
                  pad: int = None, act: str = "linear", s_out=None):
    """int8 xq (B, Cin, H, W) in channels-last memory, quantized with scale
    s_in, convolved with w_q (int32 accumulation), dequantized with s_in *
    s_w, plus b, then ``act``; int8 requantized with s_out, or float32 where
    s_out is None. Channels-last (B, Cout, Ho, Wo)."""
    k = w_q.shape[-1]
    pad = k // 2 if pad is None else pad
    _check(xq, w_q, s_w, b, stride, pad, act, torch.float32,
           x_dtypes=(torch.int8,))
    if xq.device.type == "cpu":
        return conv2d_int8_q_plain(xq, s_in, w_q, s_w, b, stride=stride,
                                   pad=pad, act=act, s_out=s_out)
    return _launch_q(xq, float(np.float32(s_in)), w_q, s_w, b, stride, pad,
                     act, s_out)


def plan_q(xq, w_q, int8_out: bool = True):
    """(instance, BN) of the kernel that ``conv2d_int8_q`` launches: with no
    quantize pass and no scratch, the input's alignment counts too."""
    cout, cin, k = w_q.shape[0], w_q.shape[1], w_q.shape[-1]
    aligned = w_q.data_ptr() % 16 == 0 and xq.data_ptr() % 16 == 0
    return (igemm.pick_instance(cin, cout, k, 1, aligned,
                                out_chunk=16 if int8_out else 8),
            igemm.pick_bn(cout, 1))


def _launch_q(xq, s_in, w_q, s_w, b, stride, pad, act, s_out):
    global launches_q
    batch, cin, h, w = xq.shape
    cout, k = w_q.shape[0], w_q.shape[-1]
    int8_out = s_out is not None
    y = torch.empty((batch, cout, (h + 2 * pad - k) // stride + 1,
                     (w + 2 * pad - k) // stride + 1),
                    dtype=torch.int8 if int8_out else torch.float32,
                    device=xq.device, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    instance, bn = plan_q(xq, w_q, int8_out)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = build.load().yolo_conv2d_int8_q(
            xq.data_ptr(), w_q.data_ptr(), s_in, s_w.data_ptr(),
            b.data_ptr(), y.data_ptr(), int(int8_out),
            inv_scale(s_out) if int8_out else 0.0, batch, h, w, cin, cout,
            k, stride, pad, int(act == "leaky"), igemm.INSTANCES[instance],
            bn, stream)
    if err != 0:
        raise RuntimeError(f"int8-in conv kernel launch failed: CUDA error "
                           f"{err}")
    launches_q += 1
    return y
