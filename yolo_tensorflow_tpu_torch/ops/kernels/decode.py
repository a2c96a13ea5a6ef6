"""Fused anchor decode + class scoring: the CUDA kernel and its plain twin.

Counterpart of yolo_tensorflow_tpu/ops/pallas/decode.py. A head scale
(B, G, G, A*(5+C)) becomes xyxy boxes (B, N, 4), score (B, N) = s(obj) *
best class probability and label (B, N) = argmax class, N = G*G*A, without
materializing the (N, C) class-probability tensor. The kernel is
``csrc/decode.cu`` (its header says what bounds it and how it is laid out):
one launch decodes every scale of a head, cut into tiles of consecutive rows
by ``plan_tiles``. The plain version is the port's
heads.decode_scale_scored. The v1 head has no kernel, in the TPU package
either: ``pipeline.make_forward`` decodes it with heads.decode_scored.

``score_dtype=torch.bfloat16`` is the TPU package's bf16 scoring of the
sigmoid-class (v3) head (its heads.decode_scored) as a mode of the kernel:
the conf and class logits rounded to bf16, the label the argmax of the
rounded logits, the score bf16(s(conf) * s(max)) with the bf16 logistic
rounded step by step (heads.sigmoid_bf16). Softmax classes ignore it, as
the TPU package does.

The wrappers call the operator ``yolo_torch::decode`` (ops/kernels/
library.py), whose implementation is picked by the device of the input: a
CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version, a fake one (under ``torch.export``) gives the output shapes.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from yolo_tensorflow_tpu_torch.models import heads
from yolo_tensorflow_tpu_torch.ops.kernels import build, library

launches = 0


def decode_scale_plain(feat, anchors_px, input_size: int, num_classes: int,
                       *, class_softmax: bool = False):
    """Plain PyTorch version of one scale: the same math as the kernel."""
    boxes, score, label = heads.decode_scale_scored(
        feat, anchors_px, input_size, num_classes,
        class_softmax=class_softmax)
    return heads.xywh_to_xyxy(boxes), score, label


def decode_plain(detections, cfg, score_dtype=None):
    """Plain PyTorch version of ``decode_fused``, on any device."""
    boxes, scores, labels = heads.decode_scored(detections, cfg,
                                                score_dtype=score_dtype)
    return heads.xywh_to_xyxy(boxes), scores, labels


# limits of csrc/decode.cu (kMaxScales, kMaxAnchors, kMaxThreads, kMaxStages,
# kMaxSharedBytes); tests/test_torch_kernel_host.py holds them to the source
MAX_SCALES = 4
MAX_ANCHORS = 16
MAX_TILE_ROWS = 256
MAX_STAGES = 3
MAX_SHARED_BYTES = 227 * 1024
# what the tile plan starts from, and how many CTAs of shared memory it
# leaves room for on an SM
TILE_ROWS = 128
STAGES = 3
CTAS_PER_SM = 2


class TilePlan(NamedTuple):
    """How one launch cuts its scales into tiles of consecutive rows."""
    tile_rows: int        # rows a tile, a multiple of 8
    stages: int           # depth of the shared-memory ring
    shared_bytes: int     # dynamic shared memory a CTA asks for
    first_tile: tuple     # per scale, the index of its first tile
    total_tiles: int


def plan_tiles(rows, row_elems: int, elem_bytes: int) -> TilePlan:
    """The tile plan of one launch over scales of ``rows`` head rows each,
    ``row_elems`` = 5 + C values of ``elem_bytes`` a row.

    A tile is ``tile_rows`` consecutive rows of one scale, a multiple of 8,
    so that every tile of a scale spans whole 16-byte chunks from the
    scale's base for any C and either dtype; only a scale's last tile may
    be ragged. Three stages of 128 rows, two stages where
    three would leave no room for ``CTAS_PER_SM`` CTAs on an SM, and then
    fewer rows a tile (wide rows: many classes in f32)."""
    row_bytes = row_elems * elem_bytes
    budget = MAX_SHARED_BYTES // CTAS_PER_SM
    stages = STAGES if STAGES * TILE_ROWS * row_bytes <= budget else 2
    tile_rows = TILE_ROWS
    while tile_rows > 8 and stages * tile_rows * row_bytes > budget:
        tile_rows //= 2
    shared = stages * tile_rows * row_bytes
    if shared > MAX_SHARED_BYTES:
        raise ValueError(
            f"decode kernel: no tile plan for rows of {row_bytes} bytes "
            f"({stages} stages of {tile_rows} rows: {shared} bytes of "
            f"shared memory, limit {MAX_SHARED_BYTES})")
    first, total = [], 0
    for n in rows:
        first.append(total)
        total += -(-n // tile_rows)
    return TilePlan(tile_rows, stages, shared, tuple(first), total)


@functools.lru_cache(maxsize=256)
def _launch_args(batch, geometry, input_size, num_classes, elem_bytes,
                 total):
    """The host arrays of one launch, which depend only on its geometry
    ((G, anchors_px) per scale): (scale table, anchors in grid cells, tile
    plan). The scales fill the ``total`` output rows of an image one after
    the other. Cached: a serving loop launches the same geometry every
    step."""
    table, wh, rows = [], [], []
    row_offset = 0
    for G, anchors_px in geometry:
        A = len(anchors_px)
        n = G * G * A
        if batch * n >= 2 ** 31:
            raise ValueError(f"{batch * n} head rows in one scale")
        stride = input_size // G
        wh += [v / stride for anchor in anchors_px for v in anchor]
        table.append([batch * n, n, G, A, row_offset])
        rows.append(batch * n)
        row_offset += n
    plan = plan_tiles(rows, 5 + num_classes, elem_bytes)
    if row_offset != total:
        raise ValueError(f"the scales hold {row_offset} rows an image, the "
                         f"outputs {total}")
    flat = [v for t, first in zip(table, plan.first_tile)
            for v in (*t, first)]
    return ((ctypes.c_int * len(flat))(*flat),
            (ctypes.c_float * len(wh))(*wh), plan)


def _launch(scales, input_size, num_classes, boxes, score, label,
            score_bf16=False):
    """One kernel launch over the scales [(feat, anchors_px, class_softmax)]
    of a head, MAX_SCALES at most, written one after the other into the
    preallocated outputs. ``score_bf16``: the bf16 scoring mode (sigmoid
    classes only)."""
    global launches
    if not 1 <= len(scales) <= MAX_SCALES:
        raise ValueError(f"{len(scales)} scales in one decode launch "
                         f"(1 to {MAX_SCALES})")
    feat0, _, softmax = scales[0]
    B, total = boxes.shape[:2]
    if feat0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode kernel takes float32 or bfloat16, "
                        f"not {feat0.dtype}")
    for t, dt in ((boxes, torch.float32), (score, torch.float32),
                  (label, torch.int32)):
        if (t.device != feat0.device or t.dtype != dt
                or not t.is_contiguous() or t.shape[:2] != (B, total)):
            raise ValueError("decode kernel outputs must be contiguous "
                             "(B, rows[, 4]) f32/f32/i32 on the input's "
                             "device")
    for feat, anchors_px, sm in scales:
        Bf, G, Gw, ch = feat.shape
        A = ch // (5 + num_classes)
        if Bf != B or G != Gw or A * (5 + num_classes) != ch:
            raise ValueError(f"head scale {tuple(feat.shape)} is not "
                             f"({B}, G, G, A*(5+{num_classes}))")
        if (feat.dtype != feat0.dtype or feat.device != feat0.device
                or bool(sm) != bool(softmax)):
            raise ValueError("the scales of one decode launch share dtype, "
                             "device and class activation")
        if not feat.is_contiguous():
            raise ValueError("decode kernel needs a contiguous NHWC head "
                             "(the NHWC view of a channels-last conv output)")
        if len(anchors_px) != A or not 1 <= A <= MAX_ANCHORS:
            raise ValueError(f"{len(anchors_px)} anchors for {A} per cell "
                             f"(1 to {MAX_ANCHORS})")
    table, wh, plan = _launch_args(
        B, tuple((f.shape[1], tuple(tuple(a) for a in anchors))
                 for f, anchors, _ in scales),
        input_size, num_classes, feat0.element_size(), total)
    lib = build.load()
    with torch.cuda.device(feat0.device):
        stream = torch.cuda.current_stream(feat0.device).cuda_stream
        err = lib.yolo_decode(
            (ctypes.c_void_p * len(scales))(*(f.data_ptr()
                                              for f, _, _ in scales)),
            table, wh, len(scales), num_classes, int(bool(softmax)),
            int(bool(score_bf16) and not softmax),
            int(feat0.dtype == torch.bfloat16), plan.tile_rows, plan.stages,
            plan.total_tiles, total, boxes.data_ptr(), score.data_ptr(),
            label.data_ptr(), stream)
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


def _per_scale(anchors, num_anchors):
    """The flat anchor list of the operator -> [[(w, h), ...] per scale]."""
    out, i = [], 0
    for a in num_anchors:
        out.append([(anchors[2 * j], anchors[2 * j + 1])
                    for j in range(i, i + a)])
        i += a
    return out


def _decode_cpu(feats, anchors, num_anchors, input_size, num_classes,
                softmax, score_bf16):
    """The operator on CPU tensors: the plain version, scale by scale."""
    parts = [heads.decode_scale_scored(
        f, a, input_size, num_classes, class_softmax=softmax,
        score_dtype=torch.bfloat16 if score_bf16 else None)
        for f, a in zip(feats, _per_scale(anchors, num_anchors))]
    boxes, scores, labels = (torch.cat([p[k] for p in parts], dim=1)
                             for k in range(3))
    return heads.xywh_to_xyxy(boxes), scores, labels


def _rows(feats, num_anchors):
    return sum(f.shape[1] * f.shape[2] * a
               for f, a in zip(feats, num_anchors))


def _decode_cuda(feats, anchors, num_anchors, input_size, num_classes,
                 softmax, score_bf16):
    """The operator on CUDA tensors: one launch of csrc/decode.cu over every
    scale, each into its row range of one set of outputs."""
    out = _outputs(feats[0], feats[0].shape[0], _rows(feats, num_anchors))
    _launch([(f, a, softmax) for f, a in
             zip(feats, _per_scale(anchors, num_anchors))], input_size,
            num_classes, *out, score_bf16=score_bf16)
    return out


def _decode_fake(feats, anchors, num_anchors, input_size, num_classes,
                 softmax, score_bf16):
    return _outputs(feats[0], feats[0].shape[0], _rows(feats, num_anchors))


decode_op = library.define(
    "decode(Tensor[] feats, float[] anchors, int[] num_anchors, "
    "int input_size, int num_classes, bool softmax, bool score_bf16) -> "
    "(Tensor, Tensor, Tensor)",
    cpu=_decode_cpu, cuda=_decode_cuda, fake=_decode_fake)


def _call(scales, input_size, num_classes, score_bf16=False):
    """``decode_op`` over the scales [(feat, anchors_px, class_softmax)],
    which share their class activation."""
    for feat, _, _ in scales:
        _check_device(feat)
    return decode_op([f for f, _, _ in scales],
                     [float(v) for _, a, _ in scales for p in a for v in p],
                     [len(a) for _, a, _ in scales], int(input_size),
                     int(num_classes), bool(scales[0][2]), bool(score_bf16))


def decode_scale_fused(feat, anchors_px, input_size: int, num_classes: int,
                       *, class_softmax: bool = False):
    """One head scale: feat (B, G, G, A*(5+C)) -> (boxes_xyxy (B, N, 4),
    score (B, N), label (B, N) int32) with N = G*G*A."""
    return _call([(feat, anchors_px, class_softmax)], input_size,
                 num_classes)


def decode_fused(detections, cfg, score_dtype=None):
    """All scales of a v2 or v3 head, concatenated in spec order like the
    TPU package's decode_fused. Returns (boxes_xyxy, scores, labels). On
    CUDA one launch decodes every scale (MAX_SCALES at most), each into its
    row range of one set of outputs. ``score_dtype`` applies to the v3
    head only. Goes through the operator ``yolo_torch::decode``."""
    bf16 = heads.check_score_dtype(score_dtype) and cfg.head == 3
    return _call(heads.head_scales(detections, cfg), cfg.input_size,
                 cfg.num_classes, score_bf16=bf16)
