"""Int8 (w8a8) convolution: the CUDA kernel and its plain twin.

Counterpart of yolo_tensorflow_tpu/ops/quant.conv2d_int8, with the
activation fused: quantize the input with its static scale s_x, convolve
int8 x int8 with exact int32 accumulation, dequantize with s_x * s_w[o],
add the bias, apply linear or leaky, all in ``epilogue_dtype``. On the TPU
XLA emitted that conv; tools/probe_int8_3x3.py holds three Pallas versions
of its accumulator. The kernels are in ``csrc/conv_int8.cu`` (its header
says what bounds them and how they are laid out): a quantize pass into an
int8 scratch tensor, then the wgmma implicit GEMM with the fused epilogue;
the first conv (Cin = 3, 3x3 or 7x7) takes the direct kernel instead,
which quantizes each input element once in shared memory (no pass, no
scratch) and runs mma.sync on the int8 tensor cores (``direct_plan`` is
its tile plan). The implicit GEMM takes any square k, stride and padding
(darknet's k // 2, 0, or any other), as the TPU package's lax conv does.
PyTorch has no int8 convolution on CUDA, so there is no library call that
computes this.

Layouts are the port's: x is NCHW in channels-last memory (the NHWC bytes),
w_q is OIHW int8 in channels-last memory (the (Cout, kh, kw, Cin) bytes the
kernel reads), s_w and b are (Cout,) float32 and s_x is a host scalar.

``conv2d_int8_q`` is the int8-in entry, the conv of the TPU package's
all-int8-activation path (ops/quant.apply_int8): int8 activations in,
with their scale s_in, no quantize pass, and the epilogue fmaf(acc, s_in *
s_w, b), leaky, then int8 out requantized with s_out (or float32 out where
the layer keeps no out scale). It has its own count, ``launches_q``.

The wrappers call the operators ``yolo_torch::quantize_act``,
``conv2d_int8`` and ``conv2d_int8_q`` (ops/kernels/library.py), whose
implementation is picked by the device of the input: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain version, a fake one
(under ``torch.export``) gives the output's shape, dtype and strides.
``launches`` and ``launches_q`` count kernel launches and nothing else;
``launches_direct`` counts those of either entry that went to the direct
kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from yolo_tensorflow_tpu_torch.ops import layers as L
from yolo_tensorflow_tpu_torch.ops.kernels import build, igemm, library

launches = 0
launches_q = 0
launches_direct = 0

# The direct kernel's tile plan, copied from csrc/conv_int8.cu (kDirectTH,
# kDirectTW, kTapsPerStep, kDirectWBank, kDirectYPad, kMaxSharedBytes;
# tests/test_torch_kernel_host.py holds them equal)
DIRECT_TH = 8             # output rows a CTA, one warp each
DIRECT_TW = 32            # output columns a CTA: two m16 tiles a warp
DIRECT_TAPS_PER_STEP = 8  # taps of 4 bytes (R, G, B, 0) in one k32 step
DIRECT_W_BANK = 24        # a weight row's pitch, mod 32 words
DIRECT_Y_PAD = 16         # bytes past a staged output pixel
MAX_SHARED_BYTES = 227 * 1024


class DirectPlan(NamedTuple):
    """One launch of the direct kernel: the CTA's output tile (th x tw),
    its input patch (patch_h x patch_w pixels, a word each, two buffers of
    it in shared memory), K in bytes (k * k * 3 packed at k = 3, k * k
    taps x 4 bytes at 7) and its k32 steps, the Cout tile, the grid
    (tiles_h x tiles_w tiles an image) and the dynamic shared memory of a
    CTA."""
    th: int
    tw: int
    patch_h: int
    patch_w: int
    k_bytes: int
    k_steps: int
    n_tile: int
    tiles_h: int
    tiles_w: int
    shared_bytes: int


def _direct_k(k: int):
    """(K bytes, k32 steps, weight pitch in words) of the direct kernel:
    (ky, kx, c) bytes packed at 3x3, (tap, c) words with c padded to 4 at
    7x7."""
    packed = k == 3
    k_bytes = k * k * (3 if packed else 4)
    k_steps = -(-k_bytes // 32)
    taps = k_steps * DIRECT_TAPS_PER_STEP
    return (k_bytes, k_steps,
            taps if packed else taps + (DIRECT_W_BANK - taps) % 32)


def direct_shared_bytes(k: int, stride: int, n_tile: int,
                        out_bytes: int) -> int:
    """Dynamic shared memory of a direct-kernel CTA: the weights, scales
    and biases, the staged output tile, two buffers of the input patch."""
    patch = ((DIRECT_TH - 1) * stride + k) * ((DIRECT_TW - 1) * stride + k)
    return (4 * n_tile * _direct_k(k)[2] + 8 * n_tile
            + DIRECT_TH * DIRECT_TW * (n_tile * out_bytes + DIRECT_Y_PAD)
            + 2 * -(-patch * 4 // 16) * 16)


def direct_plan(h: int, w: int, k: int, stride: int, pad: int, n_tile: int,
                out_bytes: int) -> DirectPlan:
    """The direct kernel's plan for a (h, w) input, a k x k conv at
    ``stride`` and ``pad``, Cout tile ``n_tile`` (its instance's N: 32, or
    64 at 7x7) and ``out_bytes`` a output element. Raises ValueError where
    the CTA's shared memory would pass 227 KB (a stride whose input patch
    does not fit: ``plan`` sends such a conv to ``gather``, and the
    kernel's entry refuses it)."""
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    k_bytes, k_steps, _ = _direct_k(k)
    patch_h = (DIRECT_TH - 1) * stride + k
    patch_w = (DIRECT_TW - 1) * stride + k
    shared = direct_shared_bytes(k, stride, n_tile, out_bytes)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(
            f"the direct int8 kernel at {k}x{k} stride {stride} needs "
            f"{shared} bytes of shared memory a CTA, more than the "
            f"{MAX_SHARED_BYTES} a CTA has")
    return DirectPlan(DIRECT_TH, DIRECT_TW, patch_h, patch_w, k_bytes,
                      k_steps, n_tile, -(-ho // DIRECT_TH),
                      -(-wo // DIRECT_TW), shared)


ACTIVATIONS = ("linear", "leaky")
EPILOGUE_DTYPES = (torch.float32, torch.bfloat16)


def check_activation(act: str) -> None:
    """Raise NotImplementedError for an activation the int8 epilogue does
    not fuse (``engine.QuantConv`` applies any other one after a linear
    epilogue)."""
    if act not in ACTIVATIONS:
        raise NotImplementedError(
            f"int8 conv fuses {ACTIVATIONS} into its epilogue, not {act!r} "
            "(ROADMAP.md, 'int8')")


def int8_accumulate(xq, w_q, *, stride: int = 1, pad: int = 0):
    """Exact int32 accumulator of an int8 conv: xq (B, Cin, H, W) and w_q
    (Cout, Cin, k, k), integer-valued tensors of any dtype. The conv runs in
    float64, which holds every product and partial sum exactly while
    |acc| < 2**53 (an int8 conv stays below 2**31)."""
    return torch.round(F.conv2d(xq.double(), w_q.double(), stride=stride,
                                padding=pad)).to(torch.int32)


def quantize_act_plain(x, s_x):
    """clamp(round(x / s_x), -127, 127) as int8, the division in float32 and
    halves to even: yolo_tensorflow_tpu/ops/quant.conv2d_int8's quantize.
    s_x is filled on x's device: PyTorch divides a CUDA tensor by a CPU
    scalar as a multiply by its reciprocal, and a host copy would sync."""
    s = _full(s_x, x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def _full(v, device):
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _quantize_cuda(x, s_x):
    """quantize_act's operator on a CUDA tensor: the prologue kernel."""
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


quantize_op = library.define(
    "quantize_act(Tensor x, float s_x) -> Tensor",
    cpu=quantize_act_plain, cuda=_quantize_cuda,
    fake=lambda x, s_x: torch.empty_like(x, dtype=torch.int8))


def quantize_act(x, s_x):
    """The int8 conv's prologue on its own: x (float32 or bfloat16,
    contiguous in its memory format) quantized to int8 with scale s_x, in
    x's shape and layout, through the operator ``yolo_torch::quantize_act``:
    the kernel on CUDA, the plain version on the CPU. ``conv2d_int8`` runs
    the same pass itself; this entry exists to test and time it, and does
    not count as a launch of the conv."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_act takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize_act runs on cpu or cuda, not {x.device}")
    return quantize_op(x, float(s_x))


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
    s = _full(s_x, x.device)
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
    check_activation(act)
    if stride < 1 or pad < 0:
        raise ValueError(f"int8 conv needs stride >= 1 and pad >= 0, got "
                         f"stride {stride} pad {pad}")
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


def _out_shape(x, w_q, stride, pad):
    batch, _, h, w = x.shape
    k = w_q.shape[-1]
    return (batch, w_q.shape[0], (h + 2 * pad - k) // stride + 1,
            (w + 2 * pad - k) // stride + 1)


def _conv_cpu(x, w_q, s_x, s_w, b, stride, pad, leaky, epilogue_dtype):
    """conv2d_int8's operator on CPU tensors: the plain version."""
    return conv2d_int8_plain(x, w_q, s_x, s_w, b, stride=stride, pad=pad,
                             act="leaky" if leaky else "linear",
                             epilogue_dtype=epilogue_dtype)


def _conv_cuda(x, w_q, s_x, s_w, b, stride, pad, leaky, epilogue_dtype):
    return _launch(x, w_q, s_x, s_w, b, stride, pad,
                   "leaky" if leaky else "linear", epilogue_dtype)


def _conv_fake(x, w_q, s_x, s_w, b, stride, pad, leaky, epilogue_dtype):
    return torch.empty(_out_shape(x, w_q, stride, pad), dtype=epilogue_dtype,
                       device=x.device, memory_format=torch.channels_last)


conv_op = library.define(
    "conv2d_int8(Tensor x, Tensor w_q, float s_x, Tensor s_w, Tensor b, "
    "int stride, int pad, bool leaky, ScalarType epilogue_dtype) -> Tensor",
    cpu=_conv_cpu, cuda=_conv_cuda, fake=_conv_fake)


def conv2d_int8(x, w_q, s_x, s_w, b, *, stride: int = 1, pad: int = None,
                act: str = "linear", epilogue_dtype=torch.float32):
    """Quantize x with s_x, int8 conv with w_q (int32 accumulation),
    dequantize with s_x * s_w, add b, apply ``act``; the result is
    (B, Cout, Ho, Wo) in channels-last memory, in ``epilogue_dtype``.
    Goes through the operator ``yolo_torch::conv2d_int8``, at any square k,
    stride and padding (by default k // 2)."""
    pad = w_q.shape[-1] // 2 if pad is None else pad
    _check(x, w_q, s_w, b, stride, pad, act, epilogue_dtype)
    return conv_op(x, w_q, float(s_x), s_w, b, int(stride), int(pad),
                   act == "leaky", epilogue_dtype)


def _fit(instance, k, stride, bn, out_bytes):
    """``instance``, except a first conv whose direct plan would pass a
    CTA's shared memory (7x7 from stride 9 with float32 out, 3x3 from
    stride 11: the input patch grows with the stride), which takes
    ``gather``: that one takes any geometry."""
    if (instance == "direct" and direct_shared_bytes(k, stride, bn, out_bytes)
            > MAX_SHARED_BYTES):
        return "gather"
    return instance


def plan(x, w_q, stride: int = 1, epilogue_dtype=torch.float32):
    """(instance, BN) of the kernel that a CUDA x and w_q launch at
    ``stride`` into ``epilogue_dtype``: the wgmma main loop fed by cp.async
    (``wgmma``) or element by element (``gather``), both after the quantize
    pass, or the direct first-conv kernel (``direct``, no pass; BN is its
    Cout tile, N of its instance). The pass writes an aligned scratch
    tensor, so of the operands only the weights' alignment matters."""
    cout, cin, k = w_q.shape[0], w_q.shape[1], w_q.shape[-1]
    bn = igemm.pick_bn(cout, 1)
    instance = igemm.pick_instance(cin, cout, k, 1, w_q.data_ptr() % 16 == 0)
    return (_fit(instance, k, stride, bn, epilogue_dtype.itemsize), bn)


def _launch(x, w_q, s_x, s_w, b, stride, pad, act, epilogue_dtype,
            lib=None):
    """The kernel's launch. ``lib``: another build of csrc/conv_int8.cu
    (ops/kernels/direct_probe.py's), given a scratch tensor whatever the
    instance (an earlier checkout's 7x7 direct kernel took one)."""
    global launches, launches_direct
    batch, cin, h, w = x.shape
    cout, k = w_q.shape[0], w_q.shape[-1]
    y = torch.empty(_out_shape(x, w_q, stride, pad), dtype=epilogue_dtype,
                    device=x.device, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    instance, bn = plan(x, w_q, stride, epilogue_dtype)
    direct = instance == "direct"
    # the quantize pass's output, the GEMM's A operand (NHWC int8); the
    # direct kernel quantizes in shared memory and takes none
    xq = (None if direct and lib is None else
          torch.empty(x.numel(), dtype=torch.int8, device=x.device))
    lib = lib or build.load()
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
    launches_direct += direct
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


def _conv_q_cpu(xq, s_in, w_q, s_w, b, stride, pad, leaky, s_out):
    """conv2d_int8_q's operator on CPU tensors: the plain version."""
    return conv2d_int8_q_plain(xq, s_in, w_q, s_w, b, stride=stride,
                               pad=pad, act="leaky" if leaky else "linear",
                               s_out=s_out)


def _conv_q_cuda(xq, s_in, w_q, s_w, b, stride, pad, leaky, s_out):
    return _launch_q(xq, s_in, w_q, s_w, b, stride, pad,
                     "leaky" if leaky else "linear", s_out)


def _conv_q_fake(xq, s_in, w_q, s_w, b, stride, pad, leaky, s_out):
    return torch.empty(_out_shape(xq, w_q, stride, pad),
                       dtype=torch.float32 if s_out is None else torch.int8,
                       device=xq.device, memory_format=torch.channels_last)


conv_q_op = library.define(
    "conv2d_int8_q(Tensor xq, float s_in, Tensor w_q, Tensor s_w, Tensor b, "
    "int stride, int pad, bool leaky, float? s_out) -> Tensor",
    cpu=_conv_q_cpu, cuda=_conv_q_cuda, fake=_conv_q_fake)


def conv2d_int8_q(xq, s_in, w_q, s_w, b, *, stride: int = 1,
                  pad: int = None, act: str = "linear", s_out=None):
    """int8 xq (B, Cin, H, W) in channels-last memory, quantized with scale
    s_in, convolved with w_q (int32 accumulation), dequantized with s_in *
    s_w, plus b, then ``act``; int8 requantized with s_out, or float32 where
    s_out is None. Channels-last (B, Cout, Ho, Wo). Goes through the
    operator ``yolo_torch::conv2d_int8_q``, at any square k, stride and
    padding (by default k // 2)."""
    pad = w_q.shape[-1] // 2 if pad is None else pad
    _check(xq, w_q, s_w, b, stride, pad, act, torch.float32,
           x_dtypes=(torch.int8,))
    return conv_q_op(xq, float(np.float32(s_in)), w_q, s_w, b, int(stride),
                     int(pad), act == "leaky",
                     None if s_out is None else float(s_out))


def plan_q(xq, w_q, int8_out: bool = True, stride: int = 1):
    """(instance, BN) of the kernel that ``conv2d_int8_q`` launches at
    ``stride``: with no quantize pass and no scratch, the input's alignment
    counts too."""
    cout, cin, k = w_q.shape[0], w_q.shape[1], w_q.shape[-1]
    aligned = w_q.data_ptr() % 16 == 0 and xq.data_ptr() % 16 == 0
    bn = igemm.pick_bn(cout, 1)
    instance = igemm.pick_instance(cin, cout, k, 1, aligned,
                                   out_chunk=16 if int8_out else 8)
    return (_fit(instance, k, stride, bn, 1 if int8_out else 4), bn)


def _launch_q(xq, s_in, w_q, s_w, b, stride, pad, act, s_out, lib=None):
    """The kernel's launch; ``lib`` as ``_launch``'s."""
    global launches_q, launches_direct
    batch, cin, h, w = xq.shape
    cout, k = w_q.shape[0], w_q.shape[-1]
    int8_out = s_out is not None
    y = torch.empty(_out_shape(xq, w_q, stride, pad),
                    dtype=torch.int8 if int8_out else torch.float32,
                    device=xq.device, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    instance, bn = plan_q(xq, w_q, int8_out, stride)
    direct = instance == "direct"
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = (lib or build.load()).yolo_conv2d_int8_q(
            xq.data_ptr(), w_q.data_ptr(), s_in, s_w.data_ptr(),
            b.data_ptr(), y.data_ptr(), int(int8_out),
            inv_scale(s_out) if int8_out else 0.0, batch, h, w, cin, cout,
            k, stride, pad, int(act == "leaky"), igemm.INSTANCES[instance],
            bn, stream)
    if err != 0:
        raise RuntimeError(f"int8-in conv kernel launch failed: CUDA error "
                           f"{err}")
    launches_q += 1
    launches_direct += direct
    return y
