"""Fused anchor decode + class scoring: the CUDA kernel and its plain twin.

Counterpart of yolo_tensorflow_tpu/ops/pallas/decode.py. A head scale
(B, G, G, A*(5+C)) becomes xyxy boxes (B, N, 4), score (B, N) = s(obj) *
best class probability and label (B, N) = argmax class, N = G*G*A, without
materializing the (N, C) class-probability tensor. The kernel is
``csrc/decode.cu`` (its header says what bounds it and how it is laid out);
the plain version is the port's heads.decode_scale_scored.

Dispatch is by the device of the input: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version. ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from yolo_tensorflow_tpu_torch.models import heads
from yolo_tensorflow_tpu_torch.ops.kernels import build

launches = 0


def decode_scale_plain(feat, anchors_px, input_size: int, num_classes: int,
                       *, class_softmax: bool = False):
    """Plain PyTorch version of one scale: the same math as the kernel."""
    boxes, score, label = heads.decode_scale_scored(
        feat, anchors_px, input_size, num_classes,
        class_softmax=class_softmax)
    return heads.xywh_to_xyxy(boxes), score, label


def decode_plain(detections, cfg):
    """Plain PyTorch version of ``decode_fused``, on any device."""
    boxes, scores, labels = heads.decode_scored(detections, cfg)
    return heads.xywh_to_xyxy(boxes), scores, labels


def _launch(feat, anchors_px, input_size, num_classes, class_softmax,
            boxes, score, label, row_offset):
    """Run the kernel on one scale, writing rows [row_offset, row_offset+N)
    of the preallocated outputs."""
    global launches
    B, G, Gw, ch = feat.shape
    A = ch // (5 + num_classes)
    if G != Gw or A * (5 + num_classes) != ch:
        raise ValueError(f"head scale {tuple(feat.shape)} is not "
                         f"(B, G, G, A*(5+{num_classes}))")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode kernel takes float32 or bfloat16, "
                        f"not {feat.dtype}")
    if not feat.is_contiguous():
        raise ValueError("decode kernel needs a contiguous NHWC head "
                         "(the NHWC view of a channels-last conv output)")
    if len(anchors_px) != A:
        raise ValueError(f"{len(anchors_px)} anchors for {A} per cell")
    total = boxes.shape[1]
    if row_offset + G * G * A > total:
        raise ValueError("scale rows overrun the output")
    for t, dt in ((boxes, torch.float32), (score, torch.float32),
                  (label, torch.int32)):
        if (t.device != feat.device or t.dtype != dt
                or not t.is_contiguous() or t.shape[:2] != (B, total)):
            raise ValueError("decode kernel outputs must be contiguous "
                             "(B, rows[, 4]) f32/f32/i32 on the input's "
                             "device")
    stride = input_size // G
    wh = [v / stride for anchor in anchors_px for v in anchor]
    lib = build.load()
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = lib.yolo_decode_scale(
            feat.data_ptr(), int(feat.dtype == torch.bfloat16),
            boxes.data_ptr(), score.data_ptr(), label.data_ptr(), B, G, A,
            num_classes, (ctypes.c_float * len(wh))(*wh),
            int(class_softmax), row_offset, total, stream)
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: CUDA error {err}")
    launches += 1


def _outputs(feat, batch, rows):
    return (torch.empty((batch, rows, 4), dtype=torch.float32,
                        device=feat.device),
            torch.empty((batch, rows), dtype=torch.float32,
                        device=feat.device),
            torch.empty((batch, rows), dtype=torch.int32, device=feat.device))


def _check_device(feat):
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode runs on cpu or cuda, not {feat.device}")
    return feat.device.type == "cuda"


def decode_scale_fused(feat, anchors_px, input_size: int, num_classes: int,
                       *, class_softmax: bool = False):
    """One head scale: feat (B, G, G, A*(5+C)) -> (boxes_xyxy (B, N, 4),
    score (B, N), label (B, N) int32) with N = G*G*A."""
    if not _check_device(feat):
        return decode_scale_plain(feat, anchors_px, input_size, num_classes,
                                  class_softmax=class_softmax)
    B, G = feat.shape[:2]
    out = _outputs(feat, B, G * G * len(anchors_px))
    _launch(feat, anchors_px, input_size, num_classes, class_softmax, *out,
            row_offset=0)
    return out


def decode_fused(detections, cfg):
    """All scales of a model, concatenated in spec order like the TPU
    package's decode_fused. Returns (boxes_xyxy, scores, labels). On CUDA
    every scale writes into its row range of one set of outputs."""
    scales = heads.head_scales(detections, cfg)
    feat0 = scales[0][0]
    if not _check_device(feat0):
        return decode_plain(detections, cfg)
    rows = [f.shape[1] * f.shape[2] * len(a) for f, a, _ in scales]
    out = _outputs(feat0, feat0.shape[0], sum(rows))
    offset = 0
    for (f, a, sm), n in zip(scales, rows):
        _launch(f, a, cfg.input_size, cfg.num_classes, sm, *out,
                row_offset=offset)
        offset += n
    return out
