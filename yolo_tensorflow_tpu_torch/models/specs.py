"""Declarative layer specs — the framework's replacement for darknet ``.cfg``.

The port's own copy of yolo_tensorflow_tpu/models/specs.py. The port
dispatches on these classes (``isinstance(spec, Conv)``), so it must be
given specs built from them: a spec object of the JAX package's classes is
another type and would match nothing.

The reference defines each network twice: once as a darknet ``.cfg`` parsed by
src/parser.c:730 and once as hand-written TF-Slim graph builders (e.g.
YOLO_V3/.../YOLOV3.py:274, YOLO_V2/.../model_darknet19.py:71). Here a network
is a flat tuple of small frozen dataclasses; one functional engine
(models/engine.py) interprets it, one loader (io/weights.py) walks it to
consume a ``.weights`` byte stream, and one FLOP counter prices it. No name
sniffing, no per-model copies.

Index convention: every spec produces exactly one output tensor, appended to
an outputs list; ``Route``/``Shortcut`` refer to earlier outputs by absolute
index (negative indices count back from the current position, darknet-style).
The network input is available as index ``INPUT`` (-(len so far)-1 handled by
the engine as a special case).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

INPUT = "input"  # sentinel usable in Route/Shortcut refs


@dataclass(frozen=True)
class Conv:
    """Convolution (+ optional batch norm) + activation.

    Darknet pad semantics: explicit ``size // 2`` zero padding on every side,
    matching both src/convolutional_layer.c and the reference TF builders'
    explicit-pad / fixed-pad idioms (model_darknet19.py:24-27,
    YOLOV3.py:53-57, YOLO_V1_Inference.py:136).
    """

    filters: int
    size: int
    stride: int = 1
    bn: bool = True
    act: str = "leaky"  # "leaky" | "linear" | "logistic"
    pad: int = -1       # -1 = darknet pad=1 semantics (size//2); else explicit


@dataclass(frozen=True)
class MaxPool:
    """Max pooling. ``stride=1, size=2`` uses SAME (end) padding — the
    stride-1 pool6 used by the tiny models (YOLO_V2_Tiny_Voc_convert...py:214,
    YOLO_V3_Tiny_convert...py:446)."""

    size: int = 2
    stride: int = 2


@dataclass(frozen=True)
class Route:
    """Select one earlier output or concatenate several along channels
    (darknet route layer, src/route_layer.c; tf.concat in the reference)."""

    refs: Tuple = ()


@dataclass(frozen=True)
class Shortcut:
    """Residual add with an earlier output (src/shortcut_layer.c;
    YOLOV3.py:60-66 ``_darknet53_block``)."""

    ref: int = -3


@dataclass(frozen=True)
class Reorg:
    """Passthrough reorg (YOLOv2). mode="darknet" reproduces darknet's
    reorg_cpu buffer-reinterpret semantics (src/blas.c:9) — what
    darknet-trained weights expect; mode="space_to_depth" reproduces the
    reference TF graphs' tf.space_to_depth (model_darknet19.py:41-44),
    which diverges from the C runtime."""

    stride: int = 2
    mode: str = "darknet"


@dataclass(frozen=True)
class Upsample:
    """2x spatial upsample. ``mode='nearest'`` matches darknet
    (src/upsample_layer.c); ``mode='bilinear_sym'`` reproduces the reference
    TF approximation (SYMMETRIC pad + resize_bilinear + crop, YOLOV3.py:241)."""

    factor: int = 2
    mode: str = "nearest"


@dataclass(frozen=True)
class TransposeFlatten:
    """NHWC -> NCHW -> flatten, the YOLOv1 FC-head layout quirk
    (YOLO_V1_Inference.py:196-198 trans_31/flat_32). The darknet FC weights
    expect the C,H,W flatten order."""


@dataclass(frozen=True)
class Dense:
    """Fully connected layer (darknet 'connected'; YOLOv1 heads).

    darknet's parse_connected DEFAULTS to logistic activation when the cfg
    omits the key (parser.c parse_connected), and supports batch_normalize
    (biases act as BN beta, load_connected_weights order: bias, weights,
    scales, mean, var)."""

    units: int
    act: str = "leaky"  # leaky | linear | logistic | relu | tanh
    bn: bool = False


@dataclass(frozen=True)
class Dropout:
    """Train-only dropout (YOLO_V1_Inference.py:201 dropout_35)."""

    rate: float = 0.5


@dataclass(frozen=True)
class GlobalAvgPool:
    """Global average pool over H, W -> (B, C) (src/avgpool_layer.c;
    classifier tails like darknet19's 1000-class head)."""


@dataclass(frozen=True)
class Softmax:
    """Softmax over the last axis (src/softmax_layer.c, classifier tails).

    ``groups`` splits the feature axis into contiguous chunks softmaxed
    independently (softmax_cpu's groups path); ``temperature`` divides the
    logits first (exp((x - max)/T)) — darknet's char-rnn sampling knob.
    The YOLO9000 softmax-tree variant lives in models/tree.py (region
    pipeline); a [softmax] section with tree= is rejected at parse."""

    groups: int = 1
    temperature: float = 1.0


@dataclass(frozen=True)
class Detect:
    """Marks the previous layer's output as a raw detection feature map and
    records which anchor slice decodes it. ``anchor_mask`` indexes into the
    model's full anchor table (YOLOv3's mask, src/parser.c yolo section)."""

    anchor_mask: Tuple[int, ...] = ()


@dataclass(frozen=True)
class Local:
    """Locally-connected (untied) convolution — darknet's [local] layer
    (src/local_layer.c), used by the full YOLOv1 cfg's layer 28
    (YOLO_V1/.../yolov1.txt:30). Every output location has its own
    (size*size*c, filters) weight block and its own bias.

    darknet quirk: the cfg ``pad`` value is used DIRECTLY as the pixel pad
    amount (forward_local_layer passes l.pad to im2col), while the output
    size formula assumes (h-1)/stride+1 when pad!=0 — these agree only for
    size==3 (the one configuration darknet ships); other (size, pad!=0)
    combos are rejected at spec validation.
    """

    filters: int
    size: int
    stride: int = 1
    pad: int = 0
    act: str = "logistic"   # parse_local's default activation


@dataclass(frozen=True)
class Deconv:
    """Transposed convolution — darknet's [deconvolutional] layer
    (src/deconvolutional_layer.c): out = (h-1)*stride + size - 2*pad,
    weights stored (in_c, out_c, size, size) in the .weights stream."""

    filters: int
    size: int
    stride: int = 1
    pad: int = 0
    bn: bool = False
    act: str = "logistic"   # parse_deconvolutional's default


@dataclass(frozen=True)
class Crop:
    """Crop layer (src/crop_layer.c) — classifier-era input augmentation.
    Inference: center crop to (crop_height, crop_width) then x*2-1 unless
    ``noadjust`` (forward_crop_layer's !net.train branch). Training-mode
    random crop/flip lives in the host data pipeline (data/augment.py), not
    here — the engine is deterministic inside jit."""

    crop_height: int
    crop_width: int
    flip: bool = False
    noadjust: bool = False


@dataclass(frozen=True)
class LRN:
    """Cross-channel local response normalization — darknet's
    [normalization] layer (src/normalization_layer.c), AlexNet-era
    classifier cfgs. Reproduces the C rolling-window exactly, including its
    init quirk: every channel's norm is missing the alpha*x[size/2]^2 term
    (the init loop sums squares [0, size/2) but the rolling update assumes
    it covered [0, size/2])."""

    size: int = 5
    alpha: float = 1e-4
    beta: float = 0.75
    kappa: float = 1.0


@dataclass(frozen=True)
class L2Norm:
    """Per-position channel L2 normalization (src/l2norm_layer.c via
    blas.c:126 l2normalize_cpu)."""


@dataclass(frozen=True)
class Logistic:
    """Elementwise sigmoid as a layer (src/logistic_layer.c) — segmenter /
    regressor heads."""


@dataclass(frozen=True)
class Rnn:
    """Vanilla recurrent layer — darknet's [rnn] (src/rnn_layer.c:29-128):
    three connected sublayers (input/self/output), each with the layer's
    activation and optional batch norm; the time axis is folded into the
    batch (step-major) and the step count comes from the net-level
    ``time_steps`` option, passed to engine.apply as ``time_steps``."""

    output: int
    act: str = "logistic"    # parse_rnn's default activation
    bn: bool = False
    shortcut: bool = False   # state += instead of state = (rnn_layer.c:112)


@dataclass(frozen=True)
class Gru:
    """GRU layer — darknet's [gru] (src/gru_layer.c): six LINEAR connected
    sublayers (wz/wr/wh on state, uz/ur/uh on input); darknet's gate
    convention keeps the OLD state with weight z. ``tanh`` selects the
    candidate activation (parse_gru: tanh=0 -> logistic)."""

    output: int
    bn: bool = False
    tanh: bool = False


@dataclass(frozen=True)
class Lstm:
    """LSTM layer — darknet's [lstm] (src/lstm_layer.c): eight LINEAR
    connected sublayers (w* on state, u* on input), standard gates."""

    output: int
    bn: bool = False


@dataclass(frozen=True)
class Crnn:
    """Convolutional RNN — darknet's [crnn] (src/crnn_layer.c): the [rnn]
    recurrence with 3x3 stride-1 pad-1 conv sublayers; the hidden state is
    a (H, W, hidden_filters) feature map."""

    output_filters: int
    hidden_filters: int
    act: str = "logistic"    # parse_crnn's default activation
    bn: bool = False
    shortcut: bool = False


RECURRENT = (Rnn, Gru, Lstm, Crnn)


def recurrent_plan(spec, in_dim: int, in_c: int):
    """THE single source of a recurrent layer's sublayer structure, in
    .weights file order (save_weights_upto, src/parser.c:1021-1050): RNN
    input/self/output, LSTM wi,wf,wo,wg,ui,uf,uo,ug, GRU wz,wr,wh,uz,ur,uh,
    CRNN conv input/self/output. Both engine.init_params and
    io/weights.py walk this plan — keep them from desynchronizing.

    Returns [(name, kind, fan_in, units)] with kind 'fc' (connected,
    fan_in = input features) or 'conv' (3x3 stride-1 pad-1,
    fan_in = input channels)."""
    if isinstance(spec, Rnn):
        o = spec.output
        return [("input", "fc", in_dim, o), ("self", "fc", o, o),
                ("output", "fc", o, o)]
    if isinstance(spec, Lstm):
        o = spec.output
        return [(n, "fc", o if n[0] == "w" else in_dim, o)
                for n in ("wi", "wf", "wo", "wg", "ui", "uf", "uo", "ug")]
    if isinstance(spec, Gru):
        o = spec.output
        return [(n, "fc", o if n[0] == "w" else in_dim, o)
                for n in ("wz", "wr", "wh", "uz", "ur", "uh")]
    if isinstance(spec, Crnn):
        hf, of = spec.hidden_filters, spec.output_filters
        return [("input", "conv", in_c, hf), ("self", "conv", hf, hf),
                ("output", "conv", hf, of)]
    raise TypeError(spec)

SpecT = (Conv, MaxPool, Route, Shortcut, Reorg, Upsample,
         TransposeFlatten, Dense, Dropout, GlobalAvgPool, Softmax, Detect,
         Local, Deconv, Crop, LRN, L2Norm, Logistic) + RECURRENT


def has_params(spec) -> bool:
    return isinstance(spec, (Conv, Dense, Local, Deconv) + RECURRENT)


class SpecBuilder:
    """Tiny helper to build spec tuples while tracking indices."""

    def __init__(self):
        self._specs = []

    def add(self, spec) -> int:
        self._specs.append(spec)
        return len(self._specs) - 1

    def conv(self, filters, size, stride=1, bn=True, act="leaky") -> int:
        return self.add(Conv(filters, size, stride, bn, act))

    def maxpool(self, size=2, stride=2) -> int:
        return self.add(MaxPool(size, stride))

    def route(self, *refs) -> int:
        return self.add(Route(tuple(refs)))

    def shortcut(self, ref) -> int:
        return self.add(Shortcut(ref))

    def reorg(self, stride=2) -> int:
        return self.add(Reorg(stride))

    def upsample(self, mode="nearest") -> int:
        return self.add(Upsample(2, mode))

    def transpose_flatten(self) -> int:
        return self.add(TransposeFlatten())

    def dense(self, units, act="leaky", bn=False) -> int:
        return self.add(Dense(units, act, bn))

    def dropout(self, rate=0.5) -> int:
        return self.add(Dropout(rate))

    def detect(self, anchor_mask) -> int:
        return self.add(Detect(tuple(anchor_mask)))

    def local(self, filters, size, stride=1, pad=0, act="leaky") -> int:
        return self.add(Local(filters, size, stride, pad, act))

    def deconv(self, filters, size, stride=1, pad=0, bn=False,
               act="leaky") -> int:
        return self.add(Deconv(filters, size, stride, pad, bn, act))

    def specs(self) -> Tuple:
        return tuple(self._specs)

    @property
    def last(self) -> int:
        return len(self._specs) - 1


def validate(specs) -> None:
    """Static sanity check: every Route/Shortcut ref resolves to an earlier
    layer, every Detect follows a layer, param layers are well formed."""
    n = len(specs)
    for i, s in enumerate(specs):
        if isinstance(s, Route):
            if not s.refs:
                raise ValueError(f"layer {i}: Route with no refs")
            for r in s.refs:
                _resolve(r, i, n)
        elif isinstance(s, Shortcut):
            _resolve(s.ref, i, n)
        elif isinstance(s, Detect):
            if i == 0:
                raise ValueError("Detect cannot be the first layer")
        elif isinstance(s, Local):
            if s.pad and s.size != 3:
                raise ValueError(
                    f"layer {i}: [local] pad={s.pad} with size={s.size} is "
                    "internally inconsistent in darknet itself (im2col pads "
                    f"{s.pad} px but the output-size formula assumes "
                    "size==3); only size-3 padded local layers are "
                    "supported")
        elif not isinstance(s, SpecT):
            raise TypeError(f"layer {i}: unknown spec {s!r}")


def _resolve(ref, i, n) -> int:
    if ref == INPUT:
        return -1
    if ref < 0:
        ref = i + ref
    if not (0 <= ref < i):
        raise ValueError(f"layer {i}: ref {ref} out of range")
    return ref


def resolve_ref(ref, i):
    """Resolve a Route/Shortcut ref at layer ``i`` to an absolute index
    (or INPUT)."""
    if ref == INPUT:
        return INPUT
    return i + ref if ref < 0 else ref
