"""3x3 stride-1 convolution with the BN batch statistics fused: the CUDA
kernel, its plain twin, and the autograd Function the training forward
calls.

Counterpart of the Pallas kernel tools/probe_conv_bnstat.py:47
(pallas_conv3x3_bnstat): a SAME 3x3 conv whose epilogue also returns, per
output channel, the sum and the sum of squares of the f32 accumulator over
batch and space, the inputs of the batch mean and of the onepass variance
(yolo_tensorflow_tpu/ops/layers.batch_norm_train). The kernel is
``csrc/conv_bnstat.cu`` (its header says what bounds it and how it is laid
out). The JAX package has no backward kernel for this conv: its gradient is
XLA's transpose of ``lax.conv``, so the backward here folds the statistics'
cotangents into the output's and hands the rest to
``aten.convolution_backward``.

Layouts are the port's: x is NCHW in channels-last memory (the NHWC bytes),
w is OIHW in channels-last memory (the (Cout, 3, 3, Cin) bytes the kernel
reads), both float32 or both bfloat16 (float64 too on the CPU, for gradient
checks). y has x's dtype and layout; the sums are float32 (float64 for
float64 input).

Dispatch is by the device of the input: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version. ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_tensorflow_tpu_torch.ops import layers as L
from yolo_tensorflow_tpu_torch.ops.kernels import build, igemm

launches = 0

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the f32 FFMA kernel's two instances, by the C entry point's codes
F32_INSTANCES = {"ffma_gather": 0, "ffma": 1}
F32_BN = 128


def _check(x, w):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_bnstat runs on cpu or cuda, not {x.device}")
    dtypes = KERNEL_DTYPES + ((torch.float64,) if x.device.type == "cpu"
                              else ())
    if x.dtype not in dtypes or w.dtype != x.dtype:
        raise TypeError(f"conv_bnstat takes x and w of one dtype in {dtypes}, "
                        f"not {x.dtype} and {w.dtype}")
    if w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"w must be (Cout, Cin, 3, 3), got {tuple(w.shape)}")
    if x.dim() != 4 or x.shape[1] != w.shape[1]:
        raise ValueError(f"input {tuple(x.shape)} is not (B, {w.shape[1]}, "
                         "H, W)")
    if w.device != x.device:
        raise ValueError("conv_bnstat operands must share the input's device")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"conv_bnstat needs {name} in channels-last "
                             "memory (NHWC / OHWI bytes)")


def conv3x3_bnstat_plain(x, w):
    """Plain PyTorch version, on any device: the conv of the inputs widened
    to float32 (bf16 products are exact there; float32 convolutions run
    without TF32), y rounded to x's dtype, and the accumulator summed in
    float64 and rounded once."""
    wide = torch.promote_types(x.dtype, torch.float32)
    with L.exact_f32_convs():
        acc = F.conv2d(x.to(wide), w.to(wide), padding=1)
    y = acc.to(x.dtype).contiguous(memory_format=torch.channels_last)
    a = acc.double()
    return (y, a.sum(dim=(0, 2, 3)).to(wide),
            (a * a).sum(dim=(0, 2, 3)).to(wide))


def plan(x, w):
    """(instance, BN) of the kernel that a CUDA x and w launch: for bf16 the
    shared wgmma main loop fed by cp.async (``wgmma``) or element by element
    (``gather``), or the direct first-conv kernel; for f32 the FFMA kernel
    with 16-byte loads (``ffma``) or without."""
    cin, cout = w.shape[1], w.shape[0]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if x.dtype == torch.bfloat16:
        return (igemm.pick_instance(cin, cout, 3, 2, aligned),
                igemm.pick_bn(cout, 2))
    return "ffma" if aligned and cin % 4 == 0 else "ffma_gather", F32_BN


def _launch(x, w):
    global launches
    batch, cin, h, wd = x.shape
    cout = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    instance, bn = plan(x, w)
    code = (igemm.INSTANCES if bf16 else F32_INSTANCES)[instance]
    y = torch.empty((batch, cout, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = build.load()
    tiles = lib.yolo_conv3x3_bnstat_tiles(batch, h, wd)
    part = torch.empty((2, tiles, cout), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.yolo_conv3x3_bnstat(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            int(bf16), batch, h, wd, cin, cout, code, bn, stream)
    if err != 0:
        raise RuntimeError(f"conv_bnstat kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y, stats[0], stats[1]


def conv3x3_bnstat_forward(x, w):
    """(y, sum, sumsq) without autograd: the kernel on CUDA, the plain
    version on the CPU."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3x3_bnstat_plain(x, w)
    return _launch(x, w)


class Conv3x3BNStat(torch.autograd.Function):
    """(y, sum, sumsq) = conv3x3_bnstat(x, w), differentiable in x and w.

    The statistics' cotangents fold into the output's,
    g = gy + g_sum + 2 * y * g_sumsq per channel, with y the rounded output
    as JAX differentiates it; g is cast to x's dtype, since JAX's VJP sees
    a cotangent of the conv output's dtype (ops/layers.conv2d's
    mixed-precision form), and goes to cuDNN's convolution backward. In
    float32 the caller turns TF32 off around the backward
    (train/loop.make_train_step does)."""

    @staticmethod
    def forward(ctx, x, w):
        y, s, sq = conv3x3_bnstat_forward(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s, sq

    @staticmethod
    def backward(ctx, gy, g_sum, g_sq):
        x, w, y = ctx.saved_tensors
        wide = g_sum.dtype
        g = (gy.to(wide) + g_sum.view(1, -1, 1, 1)
             + 2 * y.to(wide) * g_sq.view(1, -1, 1, 1))
        g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw


def conv3x3_bnstat(x, w):
    """3x3 stride-1 SAME conv of x (B, Cin, H, W) with w (Cout, Cin, 3, 3),
    both channels-last: returns y (B, Cout, H, W) in x's dtype and
    channels-last memory, and the per-channel sum and sum of squares of the
    float32 accumulator over (B, H, W). Differentiable."""
    return Conv3x3BNStat.apply(x, w)
