"""End-to-end detection in PyTorch: uint8 pixels to fixed-shape Detections.

Counterpart of yolo_tensorflow_tpu/pipeline.py. The main path,
``Detector.detect_batch``: normalize -> backbone (cuDNN convolutions,
channels-last; or, for int8 params, the int8 conv kernel of
ops/kernels/conv_int8.py) -> fused decode + score (the CUDA kernel of
ops/kernels/decode.py for the v2 and v3 heads, with its bf16 scoring under
``score_dtype=torch.bfloat16``; plain PyTorch for v1's 98 boxes) -> top-k +
exact greedy NMS (the CUDA kernel of ops/kernels/nms.py) -> Detections.
The fused letterbox, ``Detector(letterbox=True, fused=True)
.detect_batch_fused``: uint8 canvases of any image size -> letterbox
(ops/preprocess.py) -> the same -> boxes in each image's own pixels.
Flip-TTA (``tta=True``, v2 and v3 heads, both ``tta_mode``s): the batch and
its mirror through one doubled backbone, the activated head outputs
averaged (models/heads.py), decoded without activating again, then NMS.
Rolling-average smoothing (``Detector.detect_batch_smoothed``): each
frame's activated head outputs averaged with the previous frames', the
tails carried on the device between calls. ``Classifier``: uint8 images ->
softmax probabilities, with the evaluation modes' preprocessing on the
device. PyTorch runs it eagerly; there is no jit. On the card no path
reads anything back to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from yolo_tensorflow_tpu_torch import config as C
from yolo_tensorflow_tpu_torch.io import weights as W
from yolo_tensorflow_tpu_torch.models import engine, heads
from yolo_tensorflow_tpu_torch.models import specs as S
from yolo_tensorflow_tpu_torch.ops import preprocess as P
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
from yolo_tensorflow_tpu_torch.post import nms as NMS

# Detector options of the TPU package that this port does not have yet, and
# the ROADMAP.md item that brings each
_NOT_PORTED = {"mesh": "Queue 1 item 10, data parallel",
               "donate": "Queue 1 item 12, the serving surface"}


def normalize_images(images_uint8, cfg: C.ModelConfig, dtype=torch.float32):
    """uint8 (B, H, W, 3) -> float (B, 3, H, W) in channels-last memory, the
    same bytes as the TPU package's NHWC result. 'unit': x / input_scale
    (v2/v3); 'symmetric': (x/255)*2-1 (v1)."""
    x = images_uint8.permute(0, 3, 1, 2).to(dtype)
    if cfg.normalization == "symmetric":
        return (x / 255.0) * 2.0 - 1.0
    return x / cfg.input_scale


def normalization_fold(cfg: C.ModelConfig):
    """(rescale, offset) such that ``px_over_255 * rescale + offset`` is
    ``normalize_images(px)``: the per-model normalization that the fused
    letterbox folds into its interpolation."""
    if cfg.normalization == "symmetric":
        return 2.0, -1.0
    return 255.0 / cfg.input_scale, 0.0


def canvas_side(*extents: int) -> int:
    """The canvas bucket covering the given extents: 256-pixel steps, at
    least 256. ``Detector.detect`` on the fused path passes (h, w,
    input_size)."""
    return max(((max(extents) + 255) // 256) * 256, 256)


def _nms_opts(cfg, max_detections, conf_threshold, iou_threshold,
              class_aware_nms, num_candidates):
    """Resolve per-call NMS overrides against the model config."""
    return dict(
        max_detections=(cfg.max_detections if max_detections is None
                        else max_detections),
        conf_threshold=(cfg.conf_threshold if conf_threshold is None
                        else conf_threshold),
        iou_threshold=(cfg.iou_threshold if iou_threshold is None
                       else iou_threshold),
        class_aware=(cfg.class_aware_nms if class_aware_nms is None
                     else class_aware_nms),
        num_candidates=num_candidates,
    )


def _check_tta(cfg, tta: bool, tta_mode: str):
    if tta and cfg.head not in (2, 3):
        raise ValueError("flip-TTA is a region/yolo-layer capability "
                         "(get_region_detections region_layer.c:368; "
                         "avg_flipped_yolo yolo_layer.c:290)")
    if tta_mode not in ("darknet", "corrected"):
        raise ValueError(f"tta_mode is 'darknet' or 'corrected', not "
                         f"{tta_mode!r}")


def activate_heads(dets, cfg):
    """The activated output of every head in float32, the buffers darknet
    averages: yolo layers (v3) and the region layer (v2) activated; the v1
    detection layer's output is linear and taken as it is."""
    if cfg.head == 3:
        return [heads.activate_v3(feat, len(det.anchor_mask),
                                  cfg.num_classes) for feat, det in dets]
    if cfg.head == 2:
        return [heads.activate_v2(feat, cfg) for feat, _ in dets]
    return [feat.to(torch.float32) for feat, _ in dets]


def flip_average(acts, batch: int, cfg, tta_mode: str):
    """Activated outputs of a doubled batch (the images, then their
    mirror) -> the flip-TTA average of each head, (batch, ...) each."""
    if cfg.head == 3:
        return [heads.yolo_flip_tta(a[:batch], a[batch:],
                                    a.shape[-1] // (5 + cfg.num_classes),
                                    cfg.num_classes, mode=tta_mode)
                for a in acts]
    return [heads.region_flip_tta(a[:batch], a[batch:], cfg, mode=tta_mode)
            for a in acts]


def decode_activated(acts, det_specs, cfg):
    """Activated (averaged) head outputs -> (boxes_xyxy, scores, labels):
    the shared tail of the flip-TTA and rolling-average paths. v3 scores
    each scale as heads.decode_v3_scale_activated, v2 and v1 as the TPU
    package's batched_nms scores a materialized decode
    (``post.nms.score_classes``)."""
    if cfg.head == 3:
        parts = [heads.decode_v3_scale_activated(
            act, [cfg.anchors[i] for i in det.anchor_mask], cfg.input_size,
            cfg.num_classes) for act, det in zip(acts, det_specs)]
        return (heads.xywh_to_xyxy(torch.cat([p[0] for p in parts], dim=1)),
                torch.cat([p[1] for p in parts], dim=1),
                torch.cat([p[2] for p in parts], dim=1))
    (act,) = acts
    decode = heads.decode_v2_activated if cfg.head == 2 else heads.decode_v1
    boxes, conf, probs = decode(act, cfg)
    return (heads.xywh_to_xyxy(boxes), *NMS.score_classes(conf, probs))


def make_forward(cfg: C.ModelConfig, *, num_candidates: int = 256,
                 max_detections: Optional[int] = None,
                 conf_threshold: Optional[float] = None,
                 iou_threshold: Optional[float] = None,
                 class_aware_nms: Optional[bool] = None,
                 tta: bool = False, tta_mode: str = "darknet",
                 score_dtype=None):
    """Build forward(network, uint8 images (B, S, S, 3)) -> Detections.

    Decode and scoring of the v2 and v3 heads always go through
    ``ops.kernels.decode.decode_fused``: the CUDA kernel on a CUDA input,
    its plain PyTorch version on a CPU one. (The TPU package's
    ``fused_decode=False`` default rests on a v5e timing that says nothing
    about this card.) ``score_dtype=torch.bfloat16`` scores the v3 head in
    bf16 (the kernel's bf16 mode). The v1 grid head (98 boxes an image) has
    no kernel, in the TPU package either: it decodes through
    ``heads.decode_scored``.

    ``tta=True`` (v2 and v3 heads; validate_detector_flip,
    examples/detector.c:234): the images and their mirror run as one doubled
    batch, each scale's activated outputs are averaged with ``tta_mode``
    (heads.yolo_flip_tta / region_flip_tta) and decoded without activating
    again (plain PyTorch, as on the TPU: the decode kernel takes raw
    logits), then NMS; ``score_dtype`` does not apply, as in the TPU
    package."""
    nms_kw = _nms_opts(cfg, max_detections, conf_threshold, iou_threshold,
                       class_aware_nms, num_candidates)
    _check_tta(cfg, tta, tta_mode)
    heads.check_score_dtype(score_dtype)

    def forward(network, images_uint8):
        x = normalize_images(images_uint8, cfg, network.dtype)
        if tta:
            return NMS.batched_nms_scored(
                *tta_decode(network, x, cfg, tta_mode), **nms_kw)
        return _detect(network, x, cfg, nms_kw, score_dtype)

    return forward


def _detect(network, x, cfg, nms_kw, score_dtype=None) -> NMS.Detections:
    """Backbone, decode and NMS of normalized input."""
    if cfg.head == 1:
        boxes, scores, labels = heads.decode_scored(network(x), cfg)
        boxes = heads.xywh_to_xyxy(boxes)
    else:
        boxes, scores, labels = K.decode_fused(network(x), cfg,
                                               score_dtype=score_dtype)
    return NMS.batched_nms_scored(boxes, scores, labels, **nms_kw)


def tta_decode(network, x, cfg, tta_mode):
    """Flip-TTA of normalized input x (B, 3, S, S): one backbone over x and
    its width mirror, the activated outputs averaged, decoded ->
    (boxes_xyxy, scores, labels)."""
    x2 = torch.cat([x, torch.flip(x, dims=[3])]).contiguous(
        memory_format=torch.channels_last)
    dets2 = network(x2)
    avgs = flip_average(activate_heads(dets2, cfg), x.shape[0], cfg,
                        tta_mode)
    return decode_activated(avgs, [d for _, d in dets2], cfg)


def make_forward_letterbox(cfg: C.ModelConfig, *, letterbox_dtype=None,
                           num_candidates: int = 256,
                           max_detections: Optional[int] = None,
                           conf_threshold: Optional[float] = None,
                           iou_threshold: Optional[float] = None,
                           class_aware_nms: Optional[bool] = None,
                           tta: bool = False, tta_mode: str = "darknet",
                           score_dtype=None):
    """Build forward(network, uint8 canvases (B, Hc, Wc, 3), int32 sizes
    (B, 2) [h, w]) -> Detections whose boxes are in each image's own pixels.

    The letterbox (``ops.preprocess``, darknet-exact, with the model's
    normalization folded in; ``letterbox_dtype=torch.bfloat16`` is its
    serving form), then ``make_forward``'s backbone, decode and NMS, then
    the box un-mapping, all on the canvases' device: the host only copies
    pixels into the canvases. ``tta=True`` mirrors the letterboxed tensor
    (pad columns and all, as validate_detector_flip flips the letterboxed
    image) and averages as ``make_forward`` does; the boxes un-map once."""
    nms_kw = _nms_opts(cfg, max_detections, conf_threshold, iou_threshold,
                       class_aware_nms, num_candidates)
    _check_tta(cfg, tta, tta_mode)
    heads.check_score_dtype(score_dtype)
    rescale, offset = normalization_fold(cfg)
    size = cfg.input_size

    def forward(network, canvas_uint8, sizes):
        x = P.letterbox_device_batch(canvas_uint8, sizes, size,
                                     compute_dtype=letterbox_dtype,
                                     rescale=rescale, offset=offset)
        if tta:
            out = NMS.batched_nms_scored(*tta_decode(
                network, x.to(network.dtype), cfg, tta_mode), **nms_kw)
        else:
            out = _detect(network, x, cfg, nms_kw, score_dtype)
        return out._replace(boxes=P.unmap_boxes_device(
            out.boxes, sizes[:, 0], sizes[:, 1], size))

    return forward


def make_forward_smoothed(cfg: C.ModelConfig, avg_frames: int, *,
                          num_candidates: int = 256,
                          max_detections: Optional[int] = None,
                          conf_threshold: Optional[float] = None,
                          iou_threshold: Optional[float] = None,
                          class_aware_nms: Optional[bool] = None):
    """Build forward(network, uint8 images (B, S, S, 3), tails) ->
    (Detections, new_tails): demo.c's rolling prediction average
    (src/demo.c:31,67-78, demo_frame = 3). Frame j of the batch is decoded
    from the mean of the activated head outputs of frames j - N + 1 .. j,
    N = ``avg_frames``; ``tails`` holds the previous N - 1 frames' activated
    outputs per head (``smooth_state_shapes``: zeros at the start, as
    darknet's calloc'd buffers), so the average slides across batches.
    The tails stay on the network's device.

    The mean is ``sliding_mean``'s."""
    nms_kw = _nms_opts(cfg, max_detections, conf_threshold, iou_threshold,
                       class_aware_nms, num_candidates)
    N = int(avg_frames)
    if N < 2:
        raise ValueError("avg_frames must be >= 2 (darknet demo_frame=3)")
    if cfg.head not in (1, 2, 3):
        raise ValueError("rolling prediction average applies to detection "
                         "heads (demo.c averages YOLO/REGION/DETECTION "
                         "layer outputs only)")

    def forward(network, images_uint8, tails):
        x = normalize_images(images_uint8, cfg, network.dtype)
        dets = network(x)
        full = [torch.cat([t, a])
                for t, a in zip(tails, activate_heads(dets, cfg))]
        B = images_uint8.shape[0]
        smoothed = [sliding_mean(f, B, N) for f in full]
        out = NMS.batched_nms_scored(*decode_activated(
            smoothed, [d for _, d in dets], cfg), **nms_kw)
        new_tails = tuple(f[B:] for f in full)
        return out, new_tails

    return forward


def sliding_mean(frames, batch: int, n: int):
    """frames (n - 1 + batch, ...) -> (batch, ...): frame j the mean of
    frames j .. j + n - 1. As the TPU package computes it on its CPU
    backend: the n slices summed left to right, then times f32(1 / n) (XLA
    compiles the ``/ n`` into that multiply)."""
    total = frames[0:batch]
    for k in range(1, n):
        total = total + frames[k:k + batch]
    return total * torch.tensor(float(np.float32(1.0) / np.float32(n)),
                                dtype=torch.float32)


def smooth_state_shapes(cfg: C.ModelConfig, specs, batch_size: int,
                        avg_frames: int, device="cpu"):
    """Zero initial tails for ``make_forward_smoothed``: per detection
    head, one float32 tensor on ``device`` of N - 1 frames of the head
    output's shape past the batch (NHWC, or features for v1)."""
    shapes = engine.infer_shapes(
        specs, (batch_size, cfg.input_size, cfg.input_size, 3))
    return tuple(torch.zeros((avg_frames - 1,) + tuple(shapes[i][1:]),
                             dtype=torch.float32, device=device)
                 for i, sp in enumerate(specs) if isinstance(sp, S.Detect))


class Detector:
    """Load a model + weights once, detect many times.

    ``detect_batch`` takes uint8 (B, S, S, 3) images already at the model's
    input size and returns Detections on ``device``; ``detect`` takes one
    HWC uint8 image of any size. ``compute_dtype``: None is float32 parity
    (TF32 off), ``torch.bfloat16`` is serving. ``params`` may be int8
    (``ops.quant.quantize_params``): its quantized convs run the int8
    kernel with the dequantize epilogue in the compute dtype.

    ``letterbox=True`` alone: ``detect`` letterboxes on the host
    (``data.augment.letterbox``, with cv2) and un-maps the boxes there
    (``unletterbox_boxes``), as the TPU package does.
    ``letterbox=True, fused=True``: the fused letterbox path.
    ``detect_batch_fused`` takes uint8 canvases of any size with each
    image's [h, w], ``detect`` copies its image into a canvas; the
    aspect-preserving resize runs on the device and boxes come back in the
    image's own pixels. ``letterbox_dtype`` defaults to bfloat16 where the
    model computes narrow (bf16 compute or int8 params), as in the TPU
    package; ``torch.float32`` is the darknet-exact form. (``fused`` without
    ``letterbox`` is ignored, as in the TPU package.)

    ``tta=True`` with ``tta_mode`` 'darknet' or 'corrected': flip-TTA on
    both paths (``make_forward``); ``score_dtype=torch.bfloat16``: bf16
    scoring of the v3 head. ``fused_decode`` is accepted and ignored: the
    port always decodes through the kernel, which at float32 equals the TPU
    package's XLA decode. ``detect_batch_smoothed`` is the rolling-average
    streaming path."""

    def __init__(self, model, weights_path: Optional[str] = None, *,
                 params=None, device="cuda", compute_dtype=None,
                 letterbox: bool = False, fused: bool = False,
                 letterbox_dtype=None, tta: bool = False,
                 tta_mode: str = "darknet", score_dtype=None,
                 fused_decode: Optional[bool] = None, **overrides):
        del fused_decode      # both values decode through the kernel
        for key, item in _NOT_PORTED.items():
            if overrides.pop(key, None):
                raise NotImplementedError(
                    f"Detector({key}=...) is not ported yet (ROADMAP.md, "
                    f"{item})")
        self.letterbox = letterbox
        self.fused = letterbox and fused
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector(device='cuda') needs a CUDA device "
                               "and torch.cuda.is_available() is false")
        nms_keys = ("num_candidates", "max_detections", "conf_threshold",
                    "iou_threshold", "class_aware_nms")
        nms_kwargs = {k: overrides.pop(k) for k in nms_keys
                      if k in overrides}
        self._nms_kwargs = dict(nms_kwargs)
        self._smooth_forwards = {}
        specs = overrides.pop("specs", None)
        if isinstance(model, C.ModelConfig):
            self.cfg = model
        else:
            self.cfg = C.get_config(model, **overrides)
        self.specs = specs if specs is not None else C.build_specs(self.cfg)
        self.header = None
        if params is None:
            if weights_path is None:
                raise ValueError("need weights_path or params")
            params, self.header = W.load_darknet_weights(
                self.specs, self.cfg.input_size, weights_path)
        self.network = engine.Network(self.specs, params, device=self.device,
                                      dtype=compute_dtype or torch.float32)
        head_kw = dict(tta=tta, tta_mode=tta_mode, score_dtype=score_dtype)
        self._forward = make_forward(self.cfg, **head_kw, **nms_kwargs)
        if self.fused:
            narrow = (self.network.dtype != torch.float32
                      or any(isinstance(p, dict) and "w_q" in p
                             for p in params.values()))
            if letterbox_dtype is None and narrow:
                letterbox_dtype = torch.bfloat16
            self.letterbox_dtype = letterbox_dtype
            self._forward_fused = make_forward_letterbox(
                self.cfg, letterbox_dtype=letterbox_dtype, **head_kw,
                **nms_kwargs)

    def detect_batch(self, images_uint8) -> NMS.Detections:
        """images_uint8: (B, S, S, 3) uint8 (numpy or tensor) already sized
        to the model input. Returns Detections on the Detector's device."""
        x = torch.as_tensor(images_uint8).to(self.device)
        with torch.inference_mode():
            return self._forward(self.network, x)

    def detect_batch_smoothed(self, images_uint8, state=None, *,
                              avg_frames: int = 3):
        """Rolling-average streaming detection (demo.c:67-78
        avg_predictions): each frame decoded from the mean of the last
        ``avg_frames`` frames' activated head outputs. ``state`` carries the
        tail frames across calls (None: zeros, darknet's calloc'd buffers);
        frames must be consecutive in batch order. Returns (Detections,
        new_state), both on the Detector's device."""
        if avg_frames not in self._smooth_forwards:
            self._smooth_forwards[avg_frames] = make_forward_smoothed(
                self.cfg, avg_frames, **self._nms_kwargs)
        x = torch.as_tensor(images_uint8).to(self.device)
        if state is None:
            state = smooth_state_shapes(self.cfg, self.specs, x.shape[0],
                                        avg_frames, device=self.device)
        with torch.inference_mode():
            return self._smooth_forwards[avg_frames](self.network, x, state)

    def detect_batch_fused(self, canvas_uint8, sizes) -> NMS.Detections:
        """Fused letterbox serving: uint8 canvases (B, Hc, Wc, 3) (numpy or
        tensor) whose top-left [0:h, 0:w] holds each image, and sizes (B, 2)
        [h, w], numpy or a tensor (one already on the device is used as it
        is: no host fetch). Returns Detections on the Detector's device,
        boxes in each image's own pixels."""
        if not self.fused:
            raise ValueError("detect_batch_fused needs "
                             "Detector(letterbox=True, fused=True)")
        x = torch.as_tensor(canvas_uint8).to(self.device)
        if not isinstance(sizes, torch.Tensor):
            sizes = torch.as_tensor(np.asarray(sizes, np.int32))
        sizes = sizes.to(device=self.device, dtype=torch.int32)
        with torch.inference_mode():
            return self._forward_fused(self.network, x, sizes)

    def detect(self, image: np.ndarray):
        """image: HWC uint8 (RGB), any size. Stretch-resized to the input
        on the host (with cv2), or letterboxed there with ``letterbox=True``;
        on the fused path letterboxed on the device instead, without cv2.
        Returns a list of dicts with pixel-space boxes in the original
        image."""
        h, w = image.shape[:2]
        s = self.cfg.input_size
        if self.fused:
            side = canvas_side(h, w, s)
            canvas = np.zeros((1, side, side, 3), np.uint8)
            canvas[0, :h, :w] = image
            dets = NMS.fetch_detections(self.detect_batch_fused(
                canvas, np.asarray([[h, w]], np.int32)))
            boxes_px = dets.boxes[0, :int(dets.num[0])]
        elif self.letterbox:
            from yolo_tensorflow_tpu_torch.data.augment import (
                letterbox, unletterbox_boxes)
            resized, scale, px, py = letterbox(image, s)
            dets = NMS.fetch_detections(self.detect_batch(resized[None]))
            boxes_px = dets.boxes[0, :int(dets.num[0])]
            if len(boxes_px):
                boxes_px = unletterbox_boxes(boxes_px, w, h, s, scale, px,
                                             py)
        else:
            import cv2
            resized = cv2.resize(image, (s, s),
                                 interpolation=cv2.INTER_LINEAR)
            dets = NMS.fetch_detections(self.detect_batch(resized[None]))
            boxes_px = (dets.boxes[0, :int(dets.num[0])]
                        * np.asarray([w, h, w, h], np.float32))
        n = int(dets.num[0])
        out = []
        for i in range(n):
            x0, y0, x1, y1 = boxes_px[i]
            out.append({
                "class_id": int(dets.classes[0, i]),
                "class": self.cfg.classes[int(dets.classes[0, i])],
                "score": float(dets.scores[0, i]),
                "box": (float(x0), float(y0), float(x1), float(y1)),
            })
        return out

    def detect_from_file(self, path: str):
        """``detect`` of the image file at ``path`` (eval.batched.read_rgb,
        with cv2)."""
        from yolo_tensorflow_tpu_torch.eval.batched import read_rgb
        return self.detect(read_rgb(path))


class Classifier:
    """Image classification (head 0 models), examples/classifier.c's predict
    path: uint8 images -> softmax probabilities, (B, classes) float32 on
    ``device``.

    ``params`` (the port's folded layout) or ``weights_path``;
    ``compute_dtype`` None is float32 parity (TF32 off), ``torch.bfloat16``
    serving; int8 ``params`` (``ops.quant.quantize_params``) run their convs
    through the int8 kernel, as in ``Detector``. ``specs`` for a model
    outside the registry.

    The evaluation modes of eval/classify.py preprocess on the device from
    uint8 canvases: ``classify_batch_center_crop`` (a square crop through
    ``letterbox_device_batch``), ``classify_batch_resize`` (darknet's
    stretch, ``ops.preprocess.resize_device_batch``),
    ``classify_batch_10crop`` and ``classify_group_fullconv``. The TPU
    package keeps an LRU cache of jitted functions per canvas and output
    shape; eager PyTorch compiles nothing, so there is none here. Canvases
    still come in ``canvas_side`` buckets, and eval/classify.snap_shape_32
    still bounds the shapes of the fully convolutional modes, so that the
    same shapes run as in the TPU package."""

    def __init__(self, model, weights_path: Optional[str] = None, *,
                 params=None, compute_dtype=None, specs=None, device="cuda",
                 **overrides):
        self.cfg = (model if isinstance(model, C.ModelConfig)
                    else C.get_config(model, **overrides))
        if self.cfg.head != 0:
            raise ValueError(f"{model} is not a classifier config")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Classifier(device='cuda') needs a CUDA "
                               "device and torch.cuda.is_available() is "
                               "false")
        self.specs = C.build_specs(self.cfg) if specs is None else specs
        if params is None:
            if weights_path is None:
                raise ValueError("need weights_path or params")
            params, _ = W.load_darknet_weights(
                self.specs, self.cfg.input_size, weights_path)
        self.network = engine.Network(self.specs, params, device=self.device,
                                      dtype=compute_dtype or torch.float32)

    def _probs(self, x):
        """Normalized input (B, 3, H, W) in channels-last memory -> probs."""
        ((probs, _),) = self.network(x.to(self.network.dtype))
        return probs

    def classify_batch(self, images_uint8):
        """uint8 (B, S, S, 3) images at the input size (numpy or tensor) ->
        probs (B, classes) on the device."""
        x = torch.as_tensor(images_uint8).to(self.device)
        with torch.inference_mode():
            return self._probs(normalize_images(x, self.cfg,
                                                self.network.dtype))

    def classify(self, image: np.ndarray, top_k: int = 5):
        """One HWC uint8 image of any size, stretch-resized on the host
        (with cv2) -> the ``top_k`` classes as dicts."""
        import cv2
        s = self.cfg.input_size
        resized = cv2.resize(image, (s, s), interpolation=cv2.INTER_LINEAR)
        probs = self.classify_batch(resized[None])[0].float().cpu().numpy()
        idx = np.argsort(-probs)[:top_k]
        return [{"class_id": int(i), "class": self.cfg.classes[int(i)],
                 "prob": float(probs[i])} for i in idx]

    def classify_batch_center_crop(self, images):
        """validate_classifier_single's preprocessing (center_crop_image,
        src/image.c): the square min-side centre crop, a host slice, then
        darknet's bilinear resize to the input size on the device: a square
        image letterboxed to S x S is resize_image(c, S, S) with no pad.
        Canvas sides come in ``canvas_side`` buckets. Returns probs (B,
        classes) on the device."""
        ms = [min(im.shape[0], im.shape[1]) for im in images]
        side = canvas_side(max(ms))
        canvas = np.zeros((len(images), side, side, 3), np.uint8)
        sizes = np.zeros((len(images), 2), np.int32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            m = ms[i]
            # crop_image's offsets (im.w - m) / 2, (im.h - m) / 2
            y0, x0 = (h - m) // 2, (w - m) // 2
            canvas[i, :m, :m] = im[y0:y0 + m, x0:x0 + m]
            sizes[i] = (m, m)
        rescale, offset = normalization_fold(self.cfg)
        with torch.inference_mode():
            x = P.letterbox_device_batch(
                torch.as_tensor(canvas).to(self.device),
                torch.as_tensor(sizes).to(self.device), self.cfg.input_size,
                rescale=rescale, offset=offset)
            return self._probs(x)

    def _pack_canvases(self, images):
        """uint8 canvases (B, side, side, 3) in a ``canvas_side`` bucket and
        sizes (B, 2) [h, w], on the device."""
        side = canvas_side(*[max(im.shape[0], im.shape[1])
                             for im in images])
        canvas = np.zeros((len(images), side, side, 3), np.uint8)
        sizes = np.zeros((len(images), 2), np.int32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            canvas[i, :h, :w] = im
            sizes[i] = (h, w)
        return (torch.as_tensor(canvas).to(self.device),
                torch.as_tensor(sizes).to(self.device))

    def _resize_forward(self, images, out_hw, views: str = "plain"):
        """darknet's stretch resize of every image to ``out_hw`` on the
        device, then the forward. ``views``: 'plain' -> (B, classes);
        'flip' -> the images and their mirror as one 2B batch, probs summed
        (validate_classifier_multi, examples/classifier.c:462-466);
        '10crop' -> ``out_hw`` is the (S + 32) base, ten S crops (four
        corners and the centre, then the same on the mirror) as one 10B
        batch, probs summed (validate_classifier_10:252-272)."""
        canvas, sizes = self._pack_canvases(images)
        rescale, offset = normalization_fold(self.cfg)
        S = self.cfg.input_size
        with torch.inference_mode():
            x = P.resize_device_batch(canvas, sizes, *out_hw,
                                      rescale=rescale, offset=offset)
            if views == "flip":
                x = torch.cat([x, torch.flip(x, dims=[3])])
            elif views == "10crop":
                # crop_image clamps reads past the edge to it
                # (src/image.c:857-875); the offsets reach 32 past the top
                # and left only, so one edge-replicating pad there makes
                # every crop a static slice
                offs = [(-32, -32), (32, -32), (0, 0), (-32, 32), (32, 32)]
                xs = []
                for base in (x, torch.flip(x, dims=[3])):
                    padded = torch.nn.functional.pad(base, (32, 0, 32, 0),
                                                     mode="replicate")
                    xs += [padded[:, :, 32 + dy:32 + dy + S,
                                  32 + dx:32 + dx + S] for dx, dy in offs]
                x = torch.cat(xs)
            probs = self._probs(x.contiguous(
                memory_format=torch.channels_last))
            if views == "plain":
                return probs
            n = 2 if views == "flip" else 10
            return probs.reshape(n, len(images), -1).sum(0)

    def classify_batch_resize(self, images):
        """validate_classifier_crop's preprocessing: the plain stretch to
        the input size (load_image_color(path, w, h), src/data.c:1122).
        Returns probs (B, classes) on the device."""
        S = self.cfg.input_size
        return self._resize_forward(images, (S, S))

    def classify_batch_10crop(self, images):
        """validate_classifier_10 (examples/classifier.c:234-305): stretch
        to (S + 32, S + 32), ten S crops, probs summed. Returns (B,
        classes) on the device."""
        S = self.cfg.input_size
        return self._resize_forward(images, (S + 32, S + 32), "10crop")

    @staticmethod
    def _resize_min_shape(h: int, w: int, size: int):
        """resize_min's integer geometry (src/image.c:997): the shorter
        side -> size."""
        if w < h:
            return (h * size) // w, size
        return size, (w * size) // h

    @staticmethod
    def _resize_max_shape(h: int, w: int, size: int):
        """resize_max's integer geometry (src/image.c:981): the longer side
        -> size."""
        if w > h:
            return (h * size) // w, size
        return size, (w * size) // h

    def classify_group_fullconv(self, images, out_hw, flip: bool = False):
        """One fully convolutional forward at ``out_hw``, the
        resize_network(net, r.w, r.h) step of validate_classifier_full and
        _multi (examples/classifier.c:340,460): the global average pool
        makes the net take any shape. ``flip``: the mirror too, probs
        summed. Returns (B, classes) on the device."""
        return self._resize_forward(images, tuple(out_hw),
                                    "flip" if flip else "plain")
