"""End-to-end detection in PyTorch: uint8 pixels to fixed-shape Detections.

Counterpart of yolo_tensorflow_tpu/pipeline.py for the main path,
``Detector.detect_batch``: normalize -> backbone (cuDNN convolutions,
channels-last; or, for int8 params, the int8 conv kernel of
ops/kernels/conv_int8.py) -> fused decode + score (the CUDA kernel of
ops/kernels/decode.py for the v2 and v3 heads, plain PyTorch for v1's 98
boxes) -> top-k + exact greedy NMS -> Detections. PyTorch runs it eagerly;
there is no jit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from yolo_tensorflow_tpu_torch import config as C
from yolo_tensorflow_tpu_torch.io import weights as W
from yolo_tensorflow_tpu_torch.models import engine, heads
from yolo_tensorflow_tpu_torch.ops.kernels import decode as K
from yolo_tensorflow_tpu_torch.post import nms as NMS

# Detector options of the TPU package that this port does not have yet, and
# the ROADMAP.md item that brings each
_NOT_PORTED = {"letterbox": "the fused letterbox",
               "fused": "the fused letterbox",
               "letterbox_dtype": "the fused letterbox",
               "tta": "TTA and smoothing", "tta_mode": "TTA and smoothing",
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
        if cfg.head == 1:
            boxes, scores, labels = heads.decode_scored(network(x), cfg)
            boxes = heads.xywh_to_xyxy(boxes)
        else:
            boxes, scores, labels = K.decode_fused(network(x), cfg)
        return NMS.batched_nms_scored(boxes, scores, labels, **nms_kw)

    return forward


class Detector:
    """Load a model + weights once, detect many times.

    ``detect_batch`` takes uint8 (B, S, S, 3) images already at the model's
    input size and returns Detections on ``device``; ``detect`` takes one
    HWC uint8 image of any size. ``compute_dtype``: None is float32 parity
    (TF32 off), ``torch.bfloat16`` is serving. ``params`` may be int8
    (``ops.quant.quantize_params``): its quantized convs run the int8
    kernel with the dequantize epilogue in the compute dtype."""

    def __init__(self, model, weights_path: Optional[str] = None, *,
                 params=None, device="cuda", compute_dtype=None,
                 **overrides):
        for key, item in _NOT_PORTED.items():
            if overrides.pop(key, None):
                raise NotImplementedError(
                    f"Detector({key}=...) is not ported yet (ROADMAP.md, "
                    f"{item!r})")
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

    def detect_batch(self, images_uint8) -> NMS.Detections:
        """images_uint8: (B, S, S, 3) uint8 (numpy or tensor) already sized
        to the model input. Returns Detections on the Detector's device."""
        x = torch.as_tensor(images_uint8).to(self.device)
        with torch.inference_mode():
            return self._forward(self.network, x)

    def detect(self, image: np.ndarray):
        """image: HWC uint8 (RGB), any size, stretch-resized to the input.
        Returns a list of dicts with pixel-space boxes in the original
        image."""
        import cv2
        h, w = image.shape[:2]
        s = self.cfg.input_size
        resized = cv2.resize(image, (s, s), interpolation=cv2.INTER_LINEAR)
        dets = NMS.fetch_detections(self.detect_batch(resized[None]))
        n = int(dets.num[0])
        boxes_px = dets.boxes[0, :n] * np.asarray([w, h, w, h], np.float32)
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
