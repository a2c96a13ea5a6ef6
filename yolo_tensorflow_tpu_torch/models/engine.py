"""The layer-spec interpreter as an ``nn.Module``: folded inference only.

Counterpart of yolo_tensorflow_tpu/models/engine.py (``apply``,
``infer_shapes``, ``layer_key``) for the layer types the v3 family uses:
Conv (BN-folded or bias-only, any activation in ``ops.layers.activate``;
or int8 w8a8, linear or leaky), MaxPool, Route, Shortcut,
Upsample(mode="nearest") and Detect. Every other spec type and unfolded BN
raise NotImplementedError naming the ROADMAP item that will port them;
nothing is skipped silently.

Parameters are the TPU package's folded pytree in the port's layout:
{layer_key(i): {"w": (Cout, Cin, kh, kw), "b": (Cout,)}} as numpy arrays or
tensors (``io.weights.params_from_jax`` converts the TPU package's HWIO).
A quantized conv (``ops.quant.quantize_params``) carries {"w_q" int8 OIHW,
"s_w" (Cout,), "s_x" (), "b" (Cout,)} instead and runs through the int8
kernel (``ops.kernels.conv_int8``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from yolo_tensorflow_tpu_torch.models import specs as S
from yolo_tensorflow_tpu_torch.ops import layers as L
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8

_V1_V2_LAYERS = (S.Reorg, S.Dense, S.TransposeFlatten, S.Softmax,
                 S.GlobalAvgPool, S.Dropout)


def layer_key(i: int) -> str:
    return f"L{i:03d}"


def check_supported(spec, i: int) -> None:
    """Raise NotImplementedError for a spec the port cannot run yet."""
    if isinstance(spec, (S.Conv, S.MaxPool, S.Route, S.Shortcut, S.Detect)):
        return
    if isinstance(spec, S.Upsample):
        if spec.mode == "nearest":
            return
        item = "leave out: upsample_bilinear_sym"
    elif isinstance(spec, _V1_V2_LAYERS):
        item = "yolov2/yolov1 layers"
    else:
        item = "the long tail"
    raise NotImplementedError(f"layer {i}: {type(spec).__name__} is not "
                              f"ported yet (ROADMAP.md, {item!r})")


def infer_shapes(specs, input_shape) -> list:
    """NHWC output shape of every spec (the TPU package's shape walk, for the
    types the port runs)."""
    shapes = []
    cur = tuple(input_shape)
    for i, spec in enumerate(specs):
        check_supported(spec, i)
        b, h, w, c = cur
        if isinstance(spec, S.Conv):
            k, s = spec.size, spec.stride
            p = k // 2 if spec.pad < 0 else spec.pad
            cur = (b, (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1,
                   spec.filters)
        elif isinstance(spec, S.MaxPool):
            if spec.stride == spec.size:
                cur = (b, h // spec.stride, w // spec.stride, c)
            else:  # SAME
                cur = (b, -(-h // spec.stride), -(-w // spec.stride), c)
        elif isinstance(spec, S.Route):
            ts = [input_shape if S.resolve_ref(r, i) == S.INPUT
                  else shapes[S.resolve_ref(r, i)] for r in spec.refs]
            cur = (*ts[0][:3], sum(t[3] for t in ts))
        elif isinstance(spec, S.Upsample):
            cur = (b, h * spec.factor, w * spec.factor, c)
        shapes.append(cur)
    return shapes


class QuantConv(nn.Module):
    """One w8a8 conv: the input quantized with the static scale s_x, int8
    weights with per-output-channel scales s_w, and dequantize, bias and
    activation fused into the int8 kernel's epilogue, which runs in the
    network's compute dtype (float32 is the parity mode, bfloat16 serving,
    as the TPU package's ``engine.apply``).

    The tensors are plain attributes, not buffers: ``Module.to(dtype=)``
    would cast the float32 scales and bias to the compute dtype."""

    def __init__(self, p, spec, *, device, dtype):
        super().__init__()
        w_q = torch.as_tensor(np.asarray(p["w_q"], np.int8))
        k = w_q.shape[-1]
        self.stride = spec.stride
        self.pad = k // 2 if spec.pad < 0 else spec.pad
        self.act = spec.act
        Q8.check_geometry(k, self.stride, self.pad, self.act)
        self.dtype = dtype
        self.w_q = w_q.to(device).contiguous(memory_format=torch.channels_last)
        self.s_x = float(np.float32(p["s_x"]))
        self.s_w = torch.as_tensor(np.asarray(p["s_w"], np.float32),
                                   device=device)
        self.b = torch.as_tensor(np.asarray(p["b"], np.float32),
                                 device=device)

    def forward(self, x):
        return Q8.conv2d_int8(x, self.w_q, self.s_x, self.s_w, self.b,
                              stride=self.stride, pad=self.pad, act=self.act,
                              epilogue_dtype=self.dtype)


class Network(nn.Module):
    """Folded-inference network over a spec tuple.

    ``forward(x)`` takes the normalized input as NCHW in channels-last
    memory (``pipeline.normalize_images``) and returns [(feat_nhwc, Detect)]
    for every Detect marker in spec order, like the TPU package's ``apply``.
    Each feat is the NHWC view of a channels-last conv output, contiguous
    with no copy. ``dtype`` is the compute dtype of weights and activations;
    float32 runs with cuDNN's TF32 off. Convs whose params hold ``w_q`` are
    ``QuantConv``s; the others stay cuDNN convs in ``dtype``."""

    def __init__(self, specs, params, *, device="cpu", dtype=torch.float32):
        super().__init__()
        self.specs = tuple(specs)
        self.dtype = dtype
        self.convs = nn.ModuleDict()
        for i, spec in enumerate(self.specs):
            check_supported(spec, i)
            if not isinstance(spec, S.Conv):
                continue
            p = params[layer_key(i)]
            if "w_q" in p:
                self.convs[layer_key(i)] = QuantConv(p, spec, device=device,
                                                     dtype=dtype)
                continue
            if "gamma" in p:
                raise NotImplementedError(
                    f"{layer_key(i)}: unfolded batch norm is training's form, "
                    "not ported yet (ROADMAP.md, 'training'); load with "
                    "io.weights.load_darknet_weights, which folds")
            w = torch.as_tensor(np.asarray(p["w"], np.float32))
            conv = nn.utils.skip_init(
                nn.Conv2d, w.shape[1], w.shape[0], w.shape[2],
                stride=spec.stride,
                padding=w.shape[2] // 2 if spec.pad < 0 else spec.pad)
            with torch.no_grad():
                conv.weight.copy_(w)
                conv.bias.copy_(torch.as_tensor(np.asarray(p["b"],
                                                           np.float32)))
            self.convs[layer_key(i)] = conv
        self.requires_grad_(False)
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)

    def forward(self, x):
        outputs, detections = [], []
        x = x.to(self.dtype)
        cur = x
        cudnn = torch.backends.cudnn
        # float32 convolutions in full precision: cuDNN otherwise runs them
        # in TF32 (the TPU package forces Precision.HIGHEST in its f32
        # parity mode for the same reason); the slice runs no matmul
        with (cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                          deterministic=cudnn.deterministic, allow_tf32=False)
              if self.dtype == torch.float32 and x.is_cuda
              else contextlib.nullcontext()):
            for i, spec in enumerate(self.specs):
                if isinstance(spec, S.Conv):
                    conv = self.convs[layer_key(i)]
                    cur = (conv(cur) if isinstance(conv, QuantConv)
                           else L.activate(conv(cur), spec.act))
                elif isinstance(spec, S.MaxPool):
                    cur = L.max_pool(cur, spec.size, spec.stride)
                elif isinstance(spec, S.Route):
                    ts = [x if S.resolve_ref(r, i) == S.INPUT
                          else outputs[S.resolve_ref(r, i)]
                          for r in spec.refs]
                    cur = ts[0] if len(ts) == 1 else torch.cat(ts, dim=1)
                elif isinstance(spec, S.Shortcut):
                    r = S.resolve_ref(spec.ref, i)
                    cur = cur + (x if r == S.INPUT else outputs[r])
                elif isinstance(spec, S.Upsample):
                    cur = L.upsample_nearest(cur, spec.factor)
                elif isinstance(spec, S.Detect):
                    detections.append((cur.permute(0, 2, 3, 1), spec))
                outputs.append(cur)
        return detections


def init_params(specs, input_size: int, seed: int, *, in_channels: int = 3,
                obj_bias: float = 0.0):
    """Seeded darknet-form parameters, in the port's layout: the numpy
    counterpart of the TPU package's ``engine.init_params`` (which uses
    jax.random). Returns (params, batch_stats) with unfolded BN, i.e. what
    a .weights file holds: BN convs {"w", "gamma", "beta"} with running
    {"mean", "var"}, bias-only convs {"w", "b"}.

    Drawn so that random weights at full Darknet-53 depth give head logits
    of order 1 (no saturated scores, so no exact ties in top-k): He-scaled
    conv weights, BN scales of ~0.3 on the last conv of each residual branch
    so the residual sum grows slowly, head convs scaled by 1/sqrt(fan_in),
    and ``obj_bias`` added to every anchor's objectness logit."""
    rng = np.random.default_rng(seed)
    shapes = infer_shapes(specs, (1, input_size, input_size, in_channels))
    params, stats = {}, {}
    prev_c = in_channels
    for i, spec in enumerate(specs):
        if isinstance(spec, S.Conv):
            cout, k = spec.filters, spec.size
            fan_in = prev_c * k * k
            w = rng.standard_normal((cout, prev_c, k, k), dtype=np.float32)
            key = layer_key(i)
            if spec.bn:
                residual = (i + 1 < len(specs)
                            and isinstance(specs[i + 1], S.Shortcut))
                g = 0.15 if residual else 1.0
                params[key] = {
                    "w": w * np.float32(np.sqrt(2.0 / fan_in)),
                    "gamma": rng.uniform(0.8 * g, 1.2 * g, cout)
                    .astype(np.float32),
                    "beta": (0.1 * rng.standard_normal(cout))
                    .astype(np.float32)}
                stats[key] = {
                    "mean": (0.1 * rng.standard_normal(cout))
                    .astype(np.float32),
                    "var": rng.uniform(0.8, 1.2, cout).astype(np.float32)}
            else:
                b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
                if i + 1 < len(specs) and isinstance(specs[i + 1], S.Detect):
                    # anchor-major (x, y, w, h, obj, classes) blocks
                    b.reshape(len(specs[i + 1].anchor_mask), -1)[:, 4] \
                        += np.float32(obj_bias)
                params[key] = {"w": w * np.float32(np.sqrt(0.5 / fan_in)),
                               "b": b}
        prev_c = shapes[i][3]
    return params, stats
