"""End-to-end detection in PyTorch: uint8 pixels to fixed-shape Detections.

Counterpart of yolo_tensorflow_tpu/pipeline.py for the main path,
``Detector.detect_batch``: normalize -> backbone (cuDNN convolutions,
channels-last; or, for int8 params, the int8 conv kernel of
ops/kernels/conv_int8.py) -> fused decode + score (the CUDA kernel of
ops/kernels/decode.py for the v2 and v3 heads, plain PyTorch for v1's 98
boxes) -> top-k + exact greedy NMS (the CUDA kernel of ops/kernels/nms.py)
-> Detections; and for the fused letterbox,
``Detector(letterbox=True, fused=True).detect_batch_fused``: uint8 canvases
of any image size -> letterbox (ops/preprocess.py) -> the same -> boxes in
each image's own pixels. PyTorch runs it eagerly; there is no jit. On the
card neither path reads anything back to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from yolo_tensorflow_tpu_torch import config as C
from yolo_tensorflow_tpu_torch.io import weights as W
from yolo_tensorflow_tpu_torch.models import engine, heads
from yolo_tensorflow_tpu_torch.ops import preprocess as P
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
from yolo_tensorflow_tpu_torch.post import nms as NMS

# Detector options of the TPU package that this port does not have yet, and
# the ROADMAP.md item that brings each
_NOT_PORTED = {"tta": "TTA and smoothing", "tta_mode": "TTA and smoothing",
               "score_dtype": "TTA and smoothing",
               "mesh": "eval, serving, export and the CLI",
               "donate": "eval, serving, export and the CLI"}


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


def make_forward(cfg: C.ModelConfig, *, num_candidates: int = 256,
                 max_detections: Optional[int] = None,
                 conf_threshold: Optional[float] = None,
                 iou_threshold: Optional[float] = None,
                 class_aware_nms: Optional[bool] = None):
    """Build forward(network, uint8 images (B, S, S, 3)) -> Detections.

    Decode and scoring of the v2 and v3 heads always go through
    ``ops.kernels.decode.decode_fused``: the CUDA kernel on a CUDA input,
    its plain PyTorch version on a CPU one. (The TPU package's
    ``fused_decode=False`` default rests on a v5e timing that says nothing
    about this card.) The v1 grid head (98 boxes an image) has no kernel,
    in the TPU package either: it decodes through ``heads.decode_scored``."""
    nms_kw = _nms_opts(cfg, max_detections, conf_threshold, iou_threshold,
                       class_aware_nms, num_candidates)

    def forward(network, images_uint8):
        x = normalize_images(images_uint8, cfg, network.dtype)
        return _detect(network, x, cfg, nms_kw)

    return forward


def _detect(network, x, cfg, nms_kw) -> NMS.Detections:
    """Backbone, decode and NMS of normalized input."""
    if cfg.head == 1:
        boxes, scores, labels = heads.decode_scored(network(x), cfg)
        boxes = heads.xywh_to_xyxy(boxes)
    else:
        boxes, scores, labels = K.decode_fused(network(x), cfg)
    return NMS.batched_nms_scored(boxes, scores, labels, **nms_kw)


def make_forward_letterbox(cfg: C.ModelConfig, *, letterbox_dtype=None,
                           num_candidates: int = 256,
                           max_detections: Optional[int] = None,
                           conf_threshold: Optional[float] = None,
                           iou_threshold: Optional[float] = None,
                           class_aware_nms: Optional[bool] = None):
    """Build forward(network, uint8 canvases (B, Hc, Wc, 3), int32 sizes
    (B, 2) [h, w]) -> Detections whose boxes are in each image's own pixels.

    The letterbox (``ops.preprocess``, darknet-exact, with the model's
    normalization folded in; ``letterbox_dtype=torch.bfloat16`` is its
    serving form), then ``make_forward``'s backbone, decode and NMS, then
    the box un-mapping, all on the canvases' device: the host only copies
    pixels into the canvases."""
    nms_kw = _nms_opts(cfg, max_detections, conf_threshold, iou_threshold,
                       class_aware_nms, num_candidates)
    rescale, offset = normalization_fold(cfg)
    size = cfg.input_size

    def forward(network, canvas_uint8, sizes):
        x = P.letterbox_device_batch(canvas_uint8, sizes, size,
                                     compute_dtype=letterbox_dtype,
                                     rescale=rescale, offset=offset)
        out = _detect(network, x, cfg, nms_kw)
        return out._replace(boxes=P.unmap_boxes_device(
            out.boxes, sizes[:, 0], sizes[:, 1], size))

    return forward


class Detector:
    """Load a model + weights once, detect many times.

    ``detect_batch`` takes uint8 (B, S, S, 3) images already at the model's
    input size and returns Detections on ``device``; ``detect`` takes one
    HWC uint8 image of any size. ``compute_dtype``: None is float32 parity
    (TF32 off), ``torch.bfloat16`` is serving. ``params`` may be int8
    (``ops.quant.quantize_params``): its quantized convs run the int8
    kernel with the dequantize epilogue in the compute dtype.

    ``letterbox=True, fused=True``: the fused letterbox path.
    ``detect_batch_fused`` takes uint8 canvases of any size with each
    image's [h, w], ``detect`` copies its image into a canvas; the
    aspect-preserving resize runs on the device and boxes come back in the
    image's own pixels. ``letterbox_dtype`` defaults to bfloat16 where the
    model computes narrow (bf16 compute or int8 params), as in the TPU
    package; ``torch.float32`` is the darknet-exact form. (``fused`` without
    ``letterbox`` is ignored, as in the TPU package.)"""

    def __init__(self, model, weights_path: Optional[str] = None, *,
                 params=None, device="cuda", compute_dtype=None,
                 letterbox: bool = False, fused: bool = False,
                 letterbox_dtype=None, **overrides):
        for key, item in _NOT_PORTED.items():
            if overrides.pop(key, None):
                raise NotImplementedError(
                    f"Detector({key}=...) is not ported yet (ROADMAP.md, "
                    f"{item!r})")
        if letterbox and not fused:
            raise NotImplementedError(
                "Detector(letterbox=True) without fused=True is the host "
                "letterbox (data/augment.letterbox, which needs cv2) and is "
                "not ported yet (ROADMAP.md, 'the fused letterbox'); "
                "Detector(letterbox=True, fused=True) is")
        self.fused = letterbox and fused
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector(device='cuda') needs a CUDA device "
                               "and torch.cuda.is_available() is false")
        nms_keys = ("num_candidates", "max_detections", "conf_threshold",
                    "iou_threshold", "class_aware_nms")
        nms_kwargs = {k: overrides.pop(k) for k in nms_keys
                      if k in overrides}
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
        self._forward = make_forward(self.cfg, **nms_kwargs)
        if self.fused:
            narrow = (self.network.dtype != torch.float32
                      or any(isinstance(p, dict) and "w_q" in p
                             for p in params.values()))
            if letterbox_dtype is None and narrow:
                letterbox_dtype = torch.bfloat16
            self.letterbox_dtype = letterbox_dtype
            self._forward_fused = make_forward_letterbox(
                self.cfg, letterbox_dtype=letterbox_dtype, **nms_kwargs)

    def detect_batch(self, images_uint8) -> NMS.Detections:
        """images_uint8: (B, S, S, 3) uint8 (numpy or tensor) already sized
        to the model input. Returns Detections on the Detector's device."""
        x = torch.as_tensor(images_uint8).to(self.device)
        with torch.inference_mode():
            return self._forward(self.network, x)

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
        on the host (with cv2); on the fused path letterboxed on the device
        instead, without cv2. Returns a list of dicts with pixel-space boxes
        in the original image."""
        h, w = image.shape[:2]
        if self.fused:
            side = canvas_side(h, w, self.cfg.input_size)
            canvas = np.zeros((1, side, side, 3), np.uint8)
            canvas[0, :h, :w] = image
            dets = NMS.fetch_detections(self.detect_batch_fused(
                canvas, np.asarray([[h, w]], np.int32)))
            scale = np.ones(4, np.float32)
        else:
            import cv2
            s = self.cfg.input_size
            resized = cv2.resize(image, (s, s),
                                 interpolation=cv2.INTER_LINEAR)
            dets = NMS.fetch_detections(self.detect_batch(resized[None]))
            scale = np.asarray([w, h, w, h], np.float32)
        n = int(dets.num[0])
        boxes_px = dets.boxes[0, :n] * scale
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
