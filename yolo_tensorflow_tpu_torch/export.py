"""Serialized inference artifacts, the frozen-pb equivalent.

Counterpart of yolo_tensorflow_tpu/export.py. The reference froze graphs
with convert_variables_to_constants and shipped .pb files consumed by a
separate app that only knows 4 tensor names (yOLO_v2_export_graph.py:22-27,
object_detect.py:61-90); the TPU package ships a ``jax.export`` StableHLO
bundle with the weights baked in. Here the artifact is a zip of the same
``manifest.json`` (model name, class names, thresholds, input spec) and a
``model.pt2``: the Detector's forward traced by ``torch.export`` at a fixed
batch and input shape, saved with ``torch.export.save``. The network's
weights travel inside the program (its parameters, and the int8 layers'
tensors as the program's constants), so the artifact needs no weights file.

The decode, NMS and int8 conv kernels are the operators
``torch.ops.yolo_torch.*`` (ops/kernels/library.py), so the exported
program calls them by name: loaded on the card it launches the hand-written
kernels, on the CPU their plain versions. The program runs on the device it
was exported on. What it cannot carry is PyTorch's global state: a float32
program on the card must run with TF32 off in cuDNN, as ``Network.forward``
sets it (``ops.layers.exact_f32_convs``), so ``LoadedArtifact`` sets that
around each call.

Consumer side: ``LoadedArtifact`` (raw named-output call) and
``ArtifactDetector`` (the object_detect.py ObjectDetectModel analogue:
resize, run, pixel-space boxes, class names, zero model knowledge), driven
by ``python -m yolo_tensorflow_tpu_torch detect --artifact model.ytt img...``
and ``serve``.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch
from torch import nn

from yolo_tensorflow_tpu_torch.ops import layers as L
# registers the yolo_torch operators the exported program calls
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8, decode, nms  # noqa: F401
from yolo_tensorflow_tpu_torch.post import nms as NMS

MANIFEST = "manifest.json"
PROGRAM = "model.pt2"

_OUTPUT_NAMES = ("detected_boxes", "detected_scores", "detected_classes",
                 "detected_valid", "detected_num")


class _DetectorProgram(nn.Module):
    """A Detector's forward as a module to export: the network (whose
    weights become the program's parameters and constants) and the forward
    function (plain or fused letterbox) with the Detector's options."""

    def __init__(self, detector, fused: bool):
        super().__init__()
        self.network = detector.network
        self._fwd = detector._forward_fused if fused else detector._forward

    def forward(self, *inputs):
        return tuple(self._fwd(self.network, *inputs))


def export_detector(detector, path: str, *, batch_size: int = 1,
                    canvas_size: int = 0) -> None:
    """Serialize a pipeline.Detector to a self-contained artifact, on the
    Detector's device.

    A Detector built with ``letterbox=True, fused=True`` exports the
    letterbox-fused program instead: inputs are a (B, C, C, 3) uint8
    canvas (raw pixels copied top-left) plus (B, 2) int32 true [h, w],
    and detected_boxes come back in each image's ORIGINAL pixels.
    ``canvas_size`` bounds the largest feedable image (default 2x the
    model input)."""
    cfg = detector.cfg
    dev = detector.device
    fused = bool(getattr(detector, "fused", False))
    manifest = {
        "framework": "yolo_tensorflow_tpu_torch",
        "model": cfg.name,
        "outputs": list(_OUTPUT_NAMES),
        "classes": list(cfg.classes),
        "conf_threshold": cfg.conf_threshold,
        "iou_threshold": cfg.iou_threshold,
        "max_detections": cfg.max_detections,
        "device": dev.type,
        "compute_dtype": str(detector.network.dtype).replace("torch.", ""),
    }
    if fused:
        side = canvas_size or 2 * cfg.input_size
        inputs = (torch.zeros((batch_size, side, side, 3), dtype=torch.uint8,
                              device=dev),
                  torch.full((batch_size, 2), side, dtype=torch.int32,
                             device=dev))
        manifest["input"] = {
            "kind": "letterbox_canvas",
            "shape": [batch_size, side, side, 3],
            "sizes_shape": [batch_size, 2],
            "dtype": "uint8", "layout": "NHWC", "colorspace": "RGB",
            "boxes_space": "original_pixels"}
    else:
        s = cfg.input_size
        inputs = (torch.zeros((batch_size, s, s, 3), dtype=torch.uint8,
                              device=dev),)
        manifest["input"] = {
            "shape": [batch_size, s, s, 3],
            "dtype": "uint8", "layout": "NHWC", "colorspace": "RGB"}
    with torch.no_grad():
        program = torch.export.export(_DetectorProgram(detector, fused),
                                      inputs, strict=False)
    blob = io.BytesIO()
    torch.export.save(program, blob)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(MANIFEST, json.dumps(manifest, indent=2))
        z.writestr(PROGRAM, blob.getvalue())


class LoadedArtifact:
    """Consumer side (the object_detect.py analogue): no model knowledge,
    just the artifact. The program runs on the device it was exported
    on."""

    def __init__(self, path: str):
        with zipfile.ZipFile(path) as z:
            self.manifest = json.loads(z.read(MANIFEST))
            blob = z.read(PROGRAM)
        self.device = torch.device(self.manifest["device"])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("this artifact was exported on a CUDA device "
                               "and torch.cuda.is_available() is false")
        self._program = torch.export.load(io.BytesIO(blob)).module()
        self.classes = self.manifest["classes"]
        self.input_shape = tuple(self.manifest["input"]["shape"])
        self._exact_f32 = (self.manifest["compute_dtype"] == "float32"
                           and self.device.type == "cuda")

    @property
    def is_letterbox(self) -> bool:
        return self.manifest["input"].get("kind") == "letterbox_canvas"

    def __call__(self, images_uint8, sizes=None):
        """images: uint8 (numpy or tensor) matching the manifest input shape
        (a raw-pixel canvas for letterbox artifacts, with ``sizes`` (B, 2)
        int32 [h, w]). Returns a dict of the named outputs, tensors on the
        artifact's device."""
        x = torch.as_tensor(images_uint8).to(self.device)
        inputs = (x,)
        if self.is_letterbox:
            if sizes is None:
                raise ValueError("letterbox artifact needs sizes (B,2) "
                                 "[h, w]")
            if not isinstance(sizes, torch.Tensor):
                sizes = torch.as_tensor(np.asarray(sizes, np.int32))
            inputs += (sizes.to(device=self.device, dtype=torch.int32),)
        with torch.inference_mode(), L.exact_f32_convs(self._exact_f32):
            outs = self._program(*inputs)
        return dict(zip(self.manifest["outputs"], outs))


class ArtifactDetector:
    """Standalone artifact consumer app, the ObjectDetectModel analogue
    (YOLO_V1/.../object_detect.py:34-90,161: load frozen graph by output
    names, feed uint8, visualize). Knows nothing about the model beyond the
    manifest: input shape, output names, class names."""

    def __init__(self, path: str):
        self.artifact = LoadedArtifact(path)
        self.classes = self.artifact.classes
        _, self.size, _, _ = self.artifact.input_shape

    def _fetch(self, outs):
        """The named outputs -> numpy Detections in one device-to-host
        copy."""
        return NMS.fetch_detections(NMS.Detections(
            *(outs[k] for k in self.artifact.manifest["outputs"])))

    def detect(self, image: np.ndarray):
        """image: HWC uint8 (RGB), any size. Returns the same list-of-dicts
        contract as pipeline.Detector.detect (pixel-space boxes on the
        original image). cv2 is needed to resize: always for a plain
        artifact, for a letterbox one only for an image larger than its
        canvas."""
        h, w = image.shape[:2]
        if self.artifact.is_letterbox:
            # raw pixels into the canvas; resize, pad and un-map are inside
            # the program. Downscale only if the image exceeds the canvas,
            # and map boxes back with the TRUE per-axis ratios (int()
            # flooring of the resize target makes them differ from the
            # nominal scale by up to ~1px on the non-dominant axis). The
            # host pre-shrink uses cv2 INTER_AREA, a deliberate deviation
            # from the darknet bilinear inside the program (area averaging
            # is the right anti-aliasing minifier for an oversize fallback;
            # the in-program letterbox stays darknet-exact).
            side = self.size
            scale = min(1.0, side / max(h, w))
            if scale < 1.0:
                import cv2
                image = cv2.resize(image, (int(w * scale), int(h * scale)),
                                   interpolation=cv2.INTER_AREA)
            ih, iw = image.shape[:2]
            canvas = np.zeros(self.artifact.input_shape, np.uint8)
            canvas[:, :ih, :iw] = image
            sizes = np.tile(np.asarray([[ih, iw]], np.int32),
                            (self.artifact.input_shape[0], 1))
            dets = self._fetch(self.artifact(canvas, sizes))
            n = int(dets.num[0])
            boxes_px = dets.boxes[0, :n] * np.asarray(
                [w / iw, h / ih, w / iw, h / ih], np.float32)
        else:
            import cv2
            resized = cv2.resize(image, (self.size, self.size),
                                 interpolation=cv2.INTER_LINEAR)
            batch = np.broadcast_to(
                resized[None], self.artifact.input_shape).copy()
            dets = self._fetch(self.artifact(batch))
            n = int(dets.num[0])
            boxes_px = dets.boxes[0, :n] * np.asarray(
                [w, h, w, h], np.float32)
        return [{
            "class_id": int(dets.classes[0, i]),
            "class": self.classes[int(dets.classes[0, i])],
            "score": float(dets.scores[0, i]),
            "box": tuple(float(v) for v in boxes_px[i]),
        } for i in range(n)]

    def detect_from_file(self, path: str):
        """``detect`` of the image file at ``path`` (needs cv2)."""
        from yolo_tensorflow_tpu_torch.eval.batched import read_rgb
        return self.detect(read_rgb(path))
