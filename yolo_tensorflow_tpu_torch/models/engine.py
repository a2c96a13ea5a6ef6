"""The layer-spec interpreter as ``nn.Module``s: folded inference
(``Network``) and training (``TrainNetwork``).

Counterpart of yolo_tensorflow_tpu/models/engine.py (``apply``,
``infer_shapes``, ``layer_key``) for the layer types the v1, v2 and v3
detectors and the darknet19 classifier use: Conv (BN-folded or bias-only,
any activation in ``ops.layers.activate``; or int8 w8a8, linear or leaky),
MaxPool, Route, Shortcut, Reorg (both modes), Upsample(mode="nearest"),
TransposeFlatten, Dense (folded, with its activation; in training plain or
with batch norm), Dropout (identity in inference, a generator's mask in
training), GlobalAvgPool, Softmax and Detect. Every other spec type, and
unfolded BN in inference, raise NotImplementedError naming the ROADMAP item
that will port them; nothing is skipped silently.

Parameters are the TPU package's folded pytree in the port's layout:
{layer_key(i): {"w": (Cout, Cin, kh, kw), "b": (Cout,)}} per conv and
{"w": (In, Out), "b": (Out,)} per Dense, as numpy arrays or tensors
(``io.weights.params_from_jax`` converts the TPU package's HWIO kernels;
its (In, Out) connected weights carry over as they are).
A quantized conv (``ops.quant.quantize_params``) carries {"w_q" int8 OIHW,
"s_w" (Cout,), "s_x" (), "b" (Cout,)} instead and runs through the int8
kernel (``ops.kernels.conv_int8``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from yolo_tensorflow_tpu_torch.models import specs as S
from yolo_tensorflow_tpu_torch.ops import layers as L
from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8

_UNWEIGHTED = (S.MaxPool, S.Route, S.Shortcut, S.Reorg, S.TransposeFlatten,
               S.Dropout, S.GlobalAvgPool, S.Softmax, S.Detect)


def layer_key(i: int) -> str:
    return f"L{i:03d}"


def check_supported(spec, i: int, train: bool = False) -> None:
    """Raise NotImplementedError for a spec the port cannot run yet
    (``train``: in ``TrainNetwork``)."""
    if isinstance(spec, (S.Conv, S.Dense) + _UNWEIGHTED):
        if not isinstance(spec, S.Reorg) or spec.mode in ("darknet",
                                                          "space_to_depth"):
            return
        raise ValueError(f"layer {i}: unknown reorg mode {spec.mode!r}")
    elif isinstance(spec, S.Upsample):
        if spec.mode == "nearest":
            return
        item = "leave out: upsample_bilinear_sym"
    else:
        item = "the long tail"
    raise NotImplementedError(f"layer {i}: {type(spec).__name__} is not "
                              f"ported yet (ROADMAP.md, {item!r})")


def infer_shapes(specs, input_shape) -> list:
    """Output shape of every spec, NHWC or (B, features) after a flatten
    (the TPU package's shape walk, for the types the port runs)."""
    shapes = []
    cur = tuple(input_shape)
    for i, spec in enumerate(specs):
        check_supported(spec, i)
        if isinstance(spec, S.Conv):
            b, h, w, c = cur
            k, s = spec.size, spec.stride
            p = k // 2 if spec.pad < 0 else spec.pad
            cur = (b, (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1,
                   spec.filters)
        elif isinstance(spec, S.MaxPool):
            b, h, w, c = cur
            if spec.stride == spec.size:
                cur = (b, h // spec.stride, w // spec.stride, c)
            else:  # SAME
                cur = (b, -(-h // spec.stride), -(-w // spec.stride), c)
        elif isinstance(spec, S.Route):
            ts = [input_shape if S.resolve_ref(r, i) == S.INPUT
                  else shapes[S.resolve_ref(r, i)] for r in spec.refs]
            cur = (*ts[0][:3], sum(t[3] for t in ts))
        elif isinstance(spec, S.Reorg):
            b, h, w, c = cur
            st = spec.stride
            cur = (b, h // st, w // st, c * st * st)
        elif isinstance(spec, S.Upsample):
            b, h, w, c = cur
            cur = (b, h * spec.factor, w * spec.factor, c)
        elif isinstance(spec, S.TransposeFlatten):
            b, h, w, c = cur
            cur = (b, c * h * w)
        elif isinstance(spec, S.Dense):
            cur = (cur[0], spec.units)
        elif isinstance(spec, S.GlobalAvgPool):
            cur = (cur[0], cur[3])
        shapes.append(cur)
    return shapes


def softmax(x, spec):
    """Softmax over the last axis in float32, in ``spec.groups`` contiguous
    chunks, the logits divided by ``spec.temperature`` first."""
    x = x.to(torch.float32)
    if spec.temperature != 1.0:
        x = x / spec.temperature
    if spec.groups > 1:
        return torch.softmax(
            x.reshape(*x.shape[:-1], spec.groups, -1), dim=-1).reshape(x.shape)
    return torch.softmax(x, dim=-1)


def apply_unweighted(spec, i, cur, x, outputs):
    """Output of spec i when it holds no parameters (MaxPool, Route,
    Shortcut, Reorg, Upsample, TransposeFlatten, GlobalAvgPool, Softmax;
    Detect, and Dropout outside training, pass ``cur`` through). ``x`` is
    the network input, ``outputs`` every earlier layer's output."""
    if isinstance(spec, S.MaxPool):
        return L.max_pool(cur, spec.size, spec.stride)
    if isinstance(spec, S.Route):
        ts = [x if S.resolve_ref(r, i) == S.INPUT
              else outputs[S.resolve_ref(r, i)] for r in spec.refs]
        return ts[0] if len(ts) == 1 else torch.cat(ts, dim=1)
    if isinstance(spec, S.Shortcut):
        r = S.resolve_ref(spec.ref, i)
        return cur + (x if r == S.INPUT else outputs[r])
    if isinstance(spec, S.Reorg):
        fn = (L.darknet_reorg if spec.mode == "darknet"
              else L.space_to_depth)
        return fn(cur, spec.stride)
    if isinstance(spec, S.Upsample):
        return L.upsample_nearest(cur, spec.factor)
    if isinstance(spec, S.TransposeFlatten):
        return L.transpose_flatten(cur)
    if isinstance(spec, S.GlobalAvgPool):
        return cur.mean(dim=(2, 3))
    if isinstance(spec, S.Softmax):
        return softmax(cur, spec)
    return cur


def head_view(cur):
    """What a Detect marker hands on: the NHWC view of a conv output, or a
    connected or pooled (B, features) output as it is."""
    return cur.permute(0, 2, 3, 1) if cur.dim() == 4 else cur


class QuantConv(nn.Module):
    """One w8a8 conv: the input quantized with the static scale s_x, int8
    weights with per-output-channel scales s_w, and dequantize, bias and
    activation fused into the int8 kernel's epilogue, which runs in the
    network's compute dtype (float32 is the parity mode, bfloat16 serving,
    as the TPU package's ``engine.apply``). An activation the epilogue does
    not take (logistic and the rest of ``ops.layers.activate``) follows the
    kernel's linear epilogue, in the same dtype: the TPU package's order,
    conv2d_int8 and then its activation.

    The tensors are plain attributes, not buffers: ``Module.to(dtype=)``
    would cast the float32 scales and bias to the compute dtype."""

    def __init__(self, p, spec, *, device, dtype):
        super().__init__()
        w_q = torch.as_tensor(np.asarray(p["w_q"], np.int8))
        k = w_q.shape[-1]
        self.stride = spec.stride
        self.pad = k // 2 if spec.pad < 0 else spec.pad
        self.act = spec.act
        self.kernel_act = (spec.act if spec.act in Q8.ACTIVATIONS
                           else "linear")
        Q8.check_geometry(k, self.stride, self.pad, self.kernel_act)
        self.dtype = dtype
        self.w_q = w_q.to(device).contiguous(memory_format=torch.channels_last)
        self.s_x = float(np.float32(p["s_x"]))
        self.s_w = torch.as_tensor(np.asarray(p["s_w"], np.float32),
                                   device=device)
        self.b = torch.as_tensor(np.asarray(p["b"], np.float32),
                                 device=device)

    def forward(self, x):
        y = Q8.conv2d_int8(x, self.w_q, self.s_x, self.s_w, self.b,
                           stride=self.stride, pad=self.pad,
                           act=self.kernel_act, epilogue_dtype=self.dtype)
        return y if self.kernel_act == self.act else L.activate(y, self.act)


class DenseLayer(nn.Module):
    """One folded connected layer: ``ops.layers.dense`` and the activation.
    ``w`` is (In, Out), the TPU package's layout, held in the dtype of the
    layer's input (the TPU package rounds it to that on every call); the
    output is float32. Plain attributes, not buffers, for QuantConv's
    reason: the second connected layer of a bf16 network takes a float32
    input and must keep float32 weights."""

    def __init__(self, p, spec, *, device, dtype):
        super().__init__()
        self.act = spec.act
        self.w = torch.as_tensor(np.asarray(p["w"], np.float32)).to(
            device=device, dtype=dtype)
        self.b = torch.as_tensor(np.asarray(p["b"], np.float32),
                                 device=device)

    def forward(self, x):
        return L.activate(L.dense(x, self.w, self.b), self.act)


class Network(nn.Module):
    """Folded-inference network over a spec tuple.

    ``forward(x)`` takes the normalized input as NCHW in channels-last
    memory (``pipeline.normalize_images``) and returns [(feat_nhwc, Detect)]
    for every Detect marker in spec order, like the TPU package's ``apply``.
    Each feat is the NHWC view of a channels-last conv output, contiguous
    with no copy, or the (B, features) output of a connected head. ``dtype``
    is the compute dtype of weights and activations; float32 runs with TF32
    off. Convs whose params hold ``w_q`` are ``QuantConv``s; the others stay
    cuDNN convs in ``dtype``. Connected layers (``DenseLayer``) put out
    float32: after the first of them the activations stay float32."""

    def __init__(self, specs, params, *, device="cpu", dtype=torch.float32):
        super().__init__()
        self.specs = tuple(specs)
        self.dtype = dtype
        self.convs = nn.ModuleDict()
        self.dense = nn.ModuleDict()
        flat_dtype = dtype           # of what the next connected layer takes
        for i, spec in enumerate(self.specs):
            check_supported(spec, i)
            if isinstance(spec, S.Dense):
                p = params[layer_key(i)]
                if "gamma" in p:
                    raise NotImplementedError(
                        f"{layer_key(i)}: unfolded connected + batch norm "
                        "in inference is not ported (ROADMAP.md, Queue 1 "
                        "item 13: batch_norm_inference): fold it, as "
                        "io.weights.load_darknet_weights does")
                self.dense[layer_key(i)] = DenseLayer(
                    p, spec, device=device, dtype=flat_dtype)
                flat_dtype = torch.float32
            if not isinstance(spec, S.Conv):
                continue
            p = params[layer_key(i)]
            if "w_q" in p:
                self.convs[layer_key(i)] = QuantConv(p, spec, device=device,
                                                     dtype=dtype)
                continue
            if "gamma" in p:
                raise NotImplementedError(
                    f"{layer_key(i)}: unfolded batch norm is the training "
                    "form (engine.TrainNetwork); inference with it is not "
                    "ported (ROADMAP.md, Queue 1 item 13: "
                    "batch_norm_inference): fold it, as "
                    "io.weights.load_darknet_weights does")
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

    def layer_outputs(self, x) -> list:
        """The output of every layer, in spec order (NCHW channels-last, or
        (B, features))."""
        outputs = []
        x = x.to(self.dtype)
        cur = x
        with L.exact_f32_convs(self.dtype == torch.float32 and x.is_cuda):
            for i, spec in enumerate(self.specs):
                if isinstance(spec, S.Conv):
                    conv = self.convs[layer_key(i)]
                    cur = (conv(cur) if isinstance(conv, QuantConv)
                           else L.activate(conv(cur), spec.act))
                elif isinstance(spec, S.Dense):
                    cur = self.dense[layer_key(i)](cur)
                else:
                    cur = apply_unweighted(spec, i, cur, x, outputs)
                outputs.append(cur)
        return outputs

    def forward(self, x):
        outputs = self.layer_outputs(x)
        return [(head_view(outputs[i]), spec)
                for i, spec in enumerate(self.specs)
                if isinstance(spec, S.Detect)]


def uses_conv_bnstat(spec) -> bool:
    """Whether a train-mode conv runs the fused conv + BN-stat kernel: the
    3x3 stride-1 BN convs with darknet's padding."""
    return (isinstance(spec, S.Conv) and spec.bn and spec.size == 3
            and spec.stride == 1 and spec.pad in (-1, 1))


class TrainNetwork(nn.Module):
    """Train-mode network over a spec tuple: the TPU package's
    ``engine.apply(train=True)`` for the layer types the port runs.

    Holds unfolded parameters as float32 ``nn.Parameter``s in the port's
    layout, ``params[layer_key(i)]`` = {"w" OIHW, "gamma", "beta"} for a BN
    conv and {"w", "b"} for a bias-only one, and {"w" (In, Out), "gamma",
    "beta"} or {"w", "b"} for a connected layer (``params_tree()`` returns
    them as that dict). Conv weights live in channels-last memory.

    ``forward(x, compute_dtype=None, bn_stats="twopass", bn_eps=1e-5,
    generator=None)`` takes the normalized input (B, 3, H, W),
    channels-last, and returns (detections, batch_stats): [(feat_nhwc or
    (B, features) float32, Detect)] per Detect marker and {layer_key:
    {"mean", "var"}} float32 batch statistics, as the TPU package returns
    them. BN convs use the batch statistics (``ops.layers.batch_norm_train``);
    the 3x3 stride-1 ones run ``ops.kernels.conv_bnstat`` (the CUDA kernel
    on a CUDA input), whose sums give the batch mean and, under onepass, the
    variance. The other convs are cuDNN's. Connected layers train in float32
    whatever ``compute_dtype`` (``ops.layers.connected_forward``; the TPU
    package casts their input to float32 in training too). Dropout draws its
    mask from ``generator`` (``ops.layers.dropout``). ``compute_dtype``
    bfloat16 is the TPU package's mixed precision: BN-conv activations stay
    bf16 and are not re-cast between layers, head convs come out in float32,
    and the master weights, batch statistics and bias adds stay float32.
    ``compute_dtype`` float64 (on the CPU) evaluates the same step in
    double: a reference for the float32 one."""

    def __init__(self, specs, params, *, device="cpu"):
        super().__init__()
        self.specs = tuple(specs)
        self.params = nn.ModuleDict()
        for i, spec in enumerate(self.specs):
            check_supported(spec, i, train=True)
            if not isinstance(spec, (S.Conv, S.Dense)):
                continue
            key = layer_key(i)
            p = params[key]
            names = ("w", "gamma", "beta") if spec.bn else ("w", "b")
            if "w_q" in p or any(n not in p for n in names):
                raise ValueError(f"{key}: training takes unfolded float "
                                 f"params {names}, got {sorted(p)}")
            # copies: the parameters are updated in place
            tensors = {n: torch.tensor(np.asarray(p[n], np.float32),
                                       device=device) for n in names}
            if isinstance(spec, S.Conv):
                tensors["w"] = tensors["w"].contiguous(
                    memory_format=torch.channels_last)
            self.params[key] = nn.ParameterDict(
                {n: nn.Parameter(t) for n, t in tensors.items()})

    def params_tree(self) -> dict:
        """{layer_key: {name: Parameter}}, the TPU package's params pytree."""
        return {k: dict(p.items()) for k, p in self.params.items()}

    def _bn_conv(self, cur, spec, p, compute_dtype, bn_stats, bn_eps):
        if uses_conv_bnstat(spec):
            x = cur.to(compute_dtype or cur.dtype).contiguous(
                memory_format=torch.channels_last)
            y, s, sq = BS.conv3x3_bnstat(x, p["w"].to(x.dtype))
            sums = (s, sq)
        else:
            y = L.conv2d(cur, p["w"], stride=spec.stride,
                         pad=None if spec.pad < 0 else spec.pad,
                         compute_dtype=compute_dtype, train=True,
                         out_dtype=compute_dtype)
            sums = None
        return L.batch_norm_train(y, p["gamma"], p["beta"], bn_eps,
                                  stats=bn_stats, sums=sums)

    def forward(self, x, compute_dtype=None, bn_stats: str = "twopass",
                bn_eps: float = 1e-5, generator=None):
        outputs, detections, stats = [], [], {}
        cur = x
        for i, spec in enumerate(self.specs):
            key = layer_key(i)
            if isinstance(spec, S.Conv):
                p = self.params[key]
                if spec.bn:
                    cur, mean, var = self._bn_conv(cur, spec, p,
                                                   compute_dtype, bn_stats,
                                                   bn_eps)
                    stats[key] = {"mean": mean.detach(),
                                  "var": var.detach()}
                else:
                    cur = L.conv2d(cur, p["w"], p["b"], stride=spec.stride,
                                   pad=None if spec.pad < 0 else spec.pad,
                                   compute_dtype=compute_dtype, train=True)
                cur = L.activate(cur, spec.act)
            elif isinstance(spec, S.Dense):
                cur = cur.to(torch.promote_types(cur.dtype, torch.float32))
                cur, st = L.connected_forward(
                    cur, dict(self.params[key].items()), spec.act,
                    bn_eps=bn_eps, bn_stats=bn_stats)
                if st is not None:
                    stats[key] = {n: v.detach() for n, v in st.items()}
            elif isinstance(spec, S.Dropout):
                if generator is None:
                    raise ValueError(f"layer {i}: Dropout in training needs "
                                     "a torch.Generator (generator=)")
                cur = L.dropout(cur, spec.rate, generator)
            else:
                cur = apply_unweighted(spec, i, cur, x, outputs)
            if isinstance(spec, S.Detect):
                wide = torch.promote_types(cur.dtype, torch.float32)
                detections.append((head_view(cur.to(wide)), spec))
            outputs.append(cur)
        return detections, stats


def init_params(specs, input_size: int, seed: int, *, in_channels: int = 3,
                obj_bias: float = 0.0, size_bias: float = 0.0):
    """Seeded darknet-form parameters, in the port's layout: the numpy
    counterpart of the TPU package's ``engine.init_params`` (which uses
    jax.random). Returns (params, batch_stats) with unfolded BN, i.e. what
    a .weights file holds: BN convs {"w", "gamma", "beta"} with running
    {"mean", "var"}, bias-only convs {"w", "b"}, connected layers {"w" (In,
    Out), "b"} (with batch norm {"w", "gamma", "beta"} and running
    statistics), He-scaled (the last one before a Detect by
    1/sqrt(fan_in)).

    Drawn so that random weights at full Darknet-53 depth give head logits
    of order 1 (no saturated scores, so no exact ties in top-k): He-scaled
    conv weights, BN scales of ~0.3 on the last conv of each residual branch
    so the residual sum grows slowly, head convs scaled by 1/sqrt(fan_in),
    ``obj_bias`` added to every anchor's objectness logit and ``size_bias``
    to its two size logits (a negative one keeps seeded boxes of the region
    head's large anchors inside the image, as trained boxes are)."""
    rng = np.random.default_rng(seed)
    shapes = infer_shapes(specs, (1, input_size, input_size, in_channels))
    params, stats = {}, {}
    prev = (1, input_size, input_size, in_channels)
    for i, spec in enumerate(specs):
        key = layer_key(i)
        if isinstance(spec, S.Conv):
            cin, cout, k = prev[3], spec.filters, spec.size
            fan_in = cin * k * k
            w = rng.standard_normal((cout, cin, k, k), dtype=np.float32)
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
                head = (i + 1 < len(specs)
                        and isinstance(specs[i + 1], S.Detect))
                if head:
                    # anchor-major (x, y, w, h, obj, classes) blocks
                    blocks = b.reshape(len(specs[i + 1].anchor_mask), -1)
                    blocks[:, 4] += np.float32(obj_bias)
                    blocks[:, 2:4] += np.float32(size_bias)
                # bias-only convs inside a backbone (yolov1) keep the He
                # scale; head convs give logits of order 1
                gain = 0.5 if head else 2.0
                params[key] = {"w": w * np.float32(np.sqrt(gain / fan_in)),
                               "b": b}
        elif isinstance(spec, S.Dense):
            fan_in = prev[1]
            last = i + 1 < len(specs) and isinstance(specs[i + 1], S.Detect)
            w = rng.standard_normal((fan_in, spec.units), dtype=np.float32)
            w = w * np.float32(np.sqrt((1.0 if last else 2.0) / fan_in))
            b = (0.1 * rng.standard_normal(spec.units)).astype(np.float32)
            if spec.bn:
                # the biases are the BN's beta (load_connected_weights)
                params[key] = {
                    "w": w, "beta": b,
                    "gamma": rng.uniform(0.8, 1.2, spec.units)
                    .astype(np.float32)}
                stats[key] = {
                    "mean": (0.1 * rng.standard_normal(spec.units))
                    .astype(np.float32),
                    "var": rng.uniform(0.8, 1.2, spec.units)
                    .astype(np.float32)}
            else:
                params[key] = {"w": w, "b": b}
        prev = shapes[i]
    return params, stats
