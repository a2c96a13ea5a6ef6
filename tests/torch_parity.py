"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Parameters are drawn with numpy (``engine.init_params`` of the port) and
handed to both packages: the port takes them in its OIHW layout, the JAX
package in HWIO. Small hand-built specs (v3-, v2-, v1-style and a
darknet19-style classifier) cover every layer type the port runs;
"narrow-v1-train" is the v1 net with dropout rate 0 and a connected layer
with batch norm, for train-step parity.

Each package gets configs and specs built from its own classes: the port
dispatches with ``isinstance`` on its copies (``models/specs.py``), which a
JAX spec object would silently fail. ``model`` builds the port's,
``jax_model`` the JAX package's, from the same description.
"""

import numpy as np
import torch

from yolo_tensorflow_tpu import config as JC
from yolo_tensorflow_tpu.models import specs as JS
from yolo_tensorflow_tpu_torch import config as TC
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.models import engine as TE
from yolo_tensorflow_tpu_torch.models import specs as TS

# the tests run several pytest workers at once; keep each one's torch small
torch.set_num_threads(2)

NARROW_CLASSES = ("a", "b", "c", "d")


def narrow_spec(S=TS, acts=("tanh", "relu")):
    """v3-style net, 8-32 channels, 4 classes, 2 scales, using Conv (BN,
    stride 2, leaky/relu/tanh, bias-only linear heads), MaxPool (VALID and
    SAME), Route (select and concat, incl. the input), Shortcut, Upsample
    and Detect. ``S`` is the specs module whose classes build it; ``acts``
    the activations of layers 3 and 12 (all leaky: the int8-activation
    path's "narrow-leaky")."""
    per_scale = 3 * (5 + len(NARROW_CLASSES))
    return (
        S.Conv(8, 3),                                  # 0  64x64x8
        S.Conv(16, 3, stride=2),                       # 1  32x32x16
        S.Conv(8, 1),                                  # 2
        S.Conv(16, 3, act=acts[0]),                    # 3
        S.Shortcut(-3),                                # 4  32x32x16
        S.MaxPool(2, 2),                               # 5  16x16x16
        S.Conv(32, 3),                                 # 6
        S.MaxPool(2, 1),                               # 7  SAME
        S.Conv(16, 1),                                 # 8
        S.Conv(per_scale, 1, bn=False, act="linear"),  # 9
        S.Detect((3, 4, 5)),                           # 10 16x16
        S.Route((8,)),                                 # 11
        S.Conv(8, 1, act=acts[1]),                     # 12
        S.Upsample(),                                  # 13 32x32x8
        S.Route((-1, 4)),                              # 14 32x32x24
        S.Conv(16, 3),                                 # 15
        S.Conv(per_scale, 1, bn=False, act="linear"),  # 16
        S.Detect((0, 1, 2)),                           # 17 32x32
    )


def narrow_v2_spec(S=TS, reorg_mode="darknet"):
    """yolov2-style net at 4-32 channels: a passthrough Route, a 1x1 conv
    down to 4 channels (so the reorg's C/s^2 is 1), Reorg, the [reorg,
    main] concat and a 5-anchor region head over 4 classes."""
    return (
        S.Conv(8, 3),                                  # 0  64x64x8
        S.MaxPool(2, 2),                               # 1  32x32
        S.Conv(16, 3),                                 # 2
        S.MaxPool(2, 2),                               # 3  16x16x16
        S.Conv(16, 3),                                 # 4  passthrough
        S.MaxPool(2, 2),                               # 5  8x8
        S.Conv(32, 3),                                 # 6  main
        S.Route((4,)),                                 # 7  16x16x16
        S.Conv(4, 1),                                  # 8  16x16x4
        S.Reorg(2, reorg_mode),                        # 9  8x8x16
        S.Route((9, 6)),                               # 10 8x8x48
        S.Conv(16, 3),                                 # 11
        S.Conv(5 * (5 + len(NARROW_CLASSES)), 1, bn=False, act="linear"),
        S.Detect((0, 1, 2, 3, 4)),                     # 13 8x8
    )


V1_GRID, V1_BOXES = 3, 2


def narrow_v1_spec(S=TS, rate=0.5, dense_bn=False):
    """yolov1-style net: bias-only and BN convs (one 7x7 stride 2), then
    TransposeFlatten, three connected layers with a Dropout of ``rate``
    between them and the flat grid head (3x3 cells, 2 boxes, 4 classes);
    ``dense_bn``: the second connected layer with batch norm."""
    n_out = V1_GRID * V1_GRID * (len(NARROW_CLASSES) + 5 * V1_BOXES)
    return (
        S.Conv(8, 7, stride=2, bn=False),              # 0  32x32x8
        S.MaxPool(2, 2),                               # 1  16x16
        S.Conv(16, 3, bn=False),                       # 2
        S.MaxPool(2, 2),                               # 3  8x8x16
        S.Conv(8, 3, stride=2),                        # 4  4x4x8
        S.TransposeFlatten(),                          # 5  128
        S.Dense(32),                                   # 6
        S.Dense(48, bn=dense_bn),                      # 7
        S.Dropout(rate),                               # 8
        S.Dense(n_out, act="linear"),                  # 9
        S.Detect(()),                                  # 10
    )


def narrow_classifier_spec(S=TS):
    """darknet19-style classifier: 3x3 BN convs (the fused conv + BN-stat
    path), a 1x1 bottleneck, MaxPool, a bias-only 1x1 class conv,
    GlobalAvgPool, Softmax and the classifier's Detect marker."""
    return (
        S.Conv(8, 3),                                  # 0  32x32x8
        S.MaxPool(2, 2),                               # 1  16x16
        S.Conv(16, 3),                                 # 2
        S.Conv(8, 1),                                  # 3
        S.Conv(16, 3),                                 # 4
        S.MaxPool(2, 2),                               # 5  8x8x16
        S.Conv(len(NARROW_CLASSES), 1, bn=False, act="linear"),
        S.GlobalAvgPool(),                             # 7  (B, 4)
        S.Softmax(),                                   # 8
        S.Detect(()),                                  # 9
    )


def narrow_config(input_size=64, C=TC):
    """The narrow spec's config, of the ``C`` config module's class."""
    return C.ModelConfig(
        name="narrow", dataset="custom", head=3, input_size=input_size,
        anchors=C.V3_TINY_ANCHORS, anchor_units="pixel", class_softmax=False,
        custom_classes=NARROW_CLASSES)


def _model(C, S, name, input_size):
    if name == "narrow":
        return narrow_config(input_size, C), narrow_spec(S)
    if name == "narrow-leaky":
        return (narrow_config(input_size, C),
                narrow_spec(S, acts=("leaky", "leaky")))
    if name in ("narrow-v2", "narrow-v2-s2d"):
        mode = "darknet" if name == "narrow-v2" else "space_to_depth"
        return (C.ModelConfig(
            name=name, dataset="custom", head=2, input_size=input_size,
            anchors=C.V2_TINY_VOC_ANCHORS, anchor_units="grid",
            custom_classes=NARROW_CLASSES), narrow_v2_spec(S, mode))
    if name in ("narrow-v1", "narrow-v1-train"):
        train = name == "narrow-v1-train"
        return (C.ModelConfig(
            name=name, dataset="custom", head=1, input_size=input_size,
            normalization="symmetric", grid=V1_GRID,
            boxes_per_cell=V1_BOXES, conf_threshold=0.2, iou_threshold=0.4,
            max_detections=10, custom_classes=NARROW_CLASSES),
            narrow_v1_spec(S, rate=0.0 if train else 0.5, dense_bn=train))
    if name == "narrow-cls":
        return (C.ModelConfig(
            name=name, dataset="custom", head=0, input_size=input_size,
            custom_classes=NARROW_CLASSES), narrow_classifier_spec(S))
    cfg = C.get_config(name, input_size=input_size)
    return cfg, C.build_specs(cfg)


def model(name, input_size):
    """The port's (cfg, specs) for a zoo model name or "narrow"."""
    return _model(TC, TS, name, input_size)


def jax_model(name, input_size):
    """The JAX package's (cfg, specs) for the same name."""
    return _model(JC, JS, name, input_size)


def _transpose(p, key, axes):
    """Conv kernels only: a connected layer's 2-D ``w`` is (In, Out) in
    both packages."""
    return ({**p, key: np.ascontiguousarray(np.asarray(p[key]).transpose(
        axes))} if key in p and np.asarray(p[key]).ndim == 4 else p)


def to_jax(params):
    """Port-layout params (OIHW ``w`` and int8 ``w_q``) -> the JAX
    package's layout (HWIO): the inverse of ``io.weights.params_from_jax``.
    """
    return {k: _transpose(_transpose(p, "w", (2, 3, 1, 0)), "w_q",
                          (2, 3, 1, 0))
            for k, p in params.items()}


def folded_params(specs, input_size, seed=0):
    """(port_params, jax_params), BN folded with darknet's formula."""
    raw, stats = TE.init_params(specs, input_size, seed)
    port = {}
    for k, p in raw.items():
        if "gamma" in p:
            w, b = TW.fold_bn(p["w"], p["gamma"], p["beta"],
                              stats[k]["mean"], stats[k]["var"])
            port[k] = {"w": w, "b": b}
        else:
            port[k] = p
    return port, to_jax(port)


def jax_int8_params(name, input_size, *, quantize_heads=False):
    """(port cfg, port specs, JAX cfg, JAX specs, JAX int8 params): the
    JAX package's calibration (one seeded batch) and quantization of
    ``folded_params``. Convs whose activation the port's int8 kernel does
    not fuse (only linear and leaky) stay float, and so do the heads unless
    ``quantize_heads``."""
    from yolo_tensorflow_tpu.ops import quant as JQ
    cfg, specs = model(name, input_size)
    jcfg, jspecs = jax_model(name, input_size)
    _, jax_params = folded_params(specs, input_size)
    scales = JQ.calibrate_activations(jspecs, jax_params,
                                      [images(2, input_size, seed=3)],
                                      cfg=jcfg)
    skip = {i for i, spec in enumerate(specs) if isinstance(spec, TS.Conv)
            and spec.act not in ("linear", "leaky")}
    if not quantize_heads:
        skip |= JQ.head_conv_layers(jspecs)
    return cfg, specs, jcfg, jspecs, JQ.quantize_params(
        jspecs, jax_params, scales, skip=skip)


def write_weights(specs, input_size, path, seed=0):
    """A seeded .weights file written by the port's writer."""
    params, stats = TE.init_params(specs, input_size, seed)
    TW.save_darknet_weights(specs, input_size, params, stats, path)
    return params, stats


def images(batch, size, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (batch, size, size, 3),
                                                dtype=np.uint8)


def batch_invariant_conv():
    """Context in which the CPU convolutions of the port give each image
    the same bits at any batch size. oneDNN's CPU convolution picks its
    algorithm by batch, and on AVX-512 CPUs it sums an image's products in
    another order at batch 4 than at batch 1 (tests/test_torch_eval.py,
    ``test_onednn_conv_batch_dependence``); PyTorch's own CPU convolution
    does not. Tests of the port's batching (tail padding, the packed fetch,
    state carried across batches) run under it, so that they hold the
    batching and not the backend's algorithm."""
    return torch.backends.mkldnn.flags(enabled=False)
