"""Greedy NMS over ranked candidates: the CUDA kernel and its plain twin.

Counterpart of the greedy step of yolo_tensorflow_tpu/post/nms.py:
``_greedy_keep`` (:103), a ``lax.while_loop`` fixpoint over the K x K IoU
matrix, and the final ``lax.top_k`` to ``max_detections`` of ``_nms_single``
(:126). On the TPU that was XLA, not a Pallas kernel; PyTorch has no loop
that stays on the device, so the plain version syncs with the host once a
fixpoint round and the card needs a kernel of its own: ``csrc/nms.cu`` (its
header says what bounds it and how it is laid out), one CTA an image.

Both take what ``post.nms.select_candidates`` gives: boxes (B, K, 4) xyxy
f32, scores (B, K) f32 in descending order, labels (B, K) int32. Both return
the five ``Detections`` fields: boxes (B, D, 4), scores (B, D), classes
(B, D) int32, valid (B, D) bool and num (B,) int32.

Dispatch is by the device of the input: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version. ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import torch

from yolo_tensorflow_tpu_torch.ops.kernels import build

launches = 0

# limits of csrc/nms.cu (kMaxThreads, kMaxSharedBytes, kBytesPerCandidate);
# tests/test_torch_kernel_host.py holds them to the source
MAX_THREADS = 256
MAX_SHARED_BYTES = 227 * 1024
BYTES_PER_CANDIDATE = 16 + 4 + 4 + 1


def shared_bytes(num_candidates: int, max_detections: int) -> int:
    """Dynamic shared memory of one CTA: every candidate's box, area, label
    and dead flag, and the indices of the kept ones. Raises where that is
    more than a CTA can have."""
    need = num_candidates * BYTES_PER_CANDIDATE + 4 * max_detections
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"nms kernel: {num_candidates} candidates and {max_detections} "
            f"detections need {need} bytes of shared memory, more than the "
            f"{MAX_SHARED_BYTES} a CTA has ({BYTES_PER_CANDIDATE} a "
            "candidate)")
    return need


def iou_matrix(boxes):
    """Pairwise IoU of (..., K, 4) xyxy boxes -> (..., K, K)."""
    x0, y0, x1, y1 = boxes.unbind(dim=-1)
    area = (x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0)
    ix0 = torch.maximum(x0[..., :, None], x0[..., None, :])
    iy0 = torch.maximum(y0[..., :, None], y0[..., None, :])
    ix1 = torch.minimum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.minimum(y1[..., :, None], y1[..., None, :])
    inter = (ix1 - ix0).clamp(min=0) * (iy1 - iy0).clamp(min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def greedy_keep_plain(boxes, scores, labels, *, conf_threshold: float,
                      iou_threshold: float, class_aware: bool):
    """Exact greedy NMS of ranked candidates -> keep (B, K) bool:
    keep[j] = active[j] and no i < j with keep[i] and iou[i, j] > thr.
    Fixpoint iteration from keep = active over the whole batch (suppressed
    suppressors release their victims each round), one convergence test (a
    host sync) a round."""
    k = scores.shape[1]
    active = scores > conf_threshold
    iou = iou_matrix(boxes)
    if class_aware:
        iou = torch.where(labels[:, :, None] == labels[:, None, :], iou,
                          torch.zeros_like(iou))
    higher = torch.ones((k, k), dtype=torch.bool,
                        device=scores.device).triu(diagonal=1)  # i < j
    overlap = (iou > iou_threshold) & higher
    keep = active
    while True:
        suppressed = (overlap & keep[:, :, None]).any(dim=1)
        new_keep = active & ~suppressed
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def greedy_select_plain(boxes, scores, labels, *, conf_threshold: float,
                        iou_threshold: float, max_detections: int,
                        class_aware: bool):
    """Plain PyTorch version of ``greedy_select``, on any device."""
    keep = greedy_keep_plain(boxes, scores, labels,
                             conf_threshold=conf_threshold,
                             iou_threshold=iou_threshold,
                             class_aware=class_aware)
    final = torch.where(keep, scores, torch.full_like(scores, -1.0))
    pad = max_detections - scores.shape[1]
    if pad > 0:
        # fewer candidates than output slots: pad the candidate set
        final = torch.cat([final, final.new_full((final.shape[0], pad),
                                                 -1.0)], dim=1)
        keep = torch.cat([keep, keep.new_zeros((keep.shape[0], pad))], dim=1)
        boxes = torch.cat([boxes, boxes.new_zeros((boxes.shape[0], pad, 4))],
                          dim=1)
        labels = torch.cat([labels, labels.new_zeros((labels.shape[0],
                                                      pad))], dim=1)
    # lax.top_k(final, D): the kept scores lie above the -1 of the others in
    # rank order, and top_k breaks ties toward the lower index, so it takes
    # the first D kept candidates, then the others in index order. A stable
    # sort says that for ties too; torch.topk leaves them unordered.
    sel = torch.argsort((~keep).to(torch.uint8), dim=1,
                        stable=True)[:, :max_detections]
    out_scores = final.gather(1, sel)
    valid = out_scores > conf_threshold
    out_boxes = boxes.gather(1, sel[:, :, None].expand(-1, -1, 4))
    return (torch.where(valid[:, :, None], out_boxes,
                        torch.zeros_like(out_boxes)),
            torch.where(valid, out_scores, torch.zeros_like(out_scores)),
            torch.where(valid, labels.gather(1, sel),
                        torch.zeros_like(sel, dtype=labels.dtype)),
            valid, valid.sum(dim=1, dtype=torch.int32))


def _check(boxes, scores, labels, conf_threshold, max_detections):
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms runs on cpu or cuda, not {boxes.device}")
    if max_detections < 1:
        raise ValueError(f"max_detections must be at least 1, not "
                         f"{max_detections}")
    if not conf_threshold >= -1.0:
        raise ValueError(f"conf_threshold {conf_threshold} is below -1, the "
                         "score that sinks a candidate that is not kept")
    b, k = scores.shape
    if boxes.shape != (b, k, 4) or labels.shape != (b, k):
        raise ValueError(f"candidates must be boxes (B, K, 4), scores "
                         f"(B, K) and labels (B, K), not "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}, "
                         f"{tuple(labels.shape)}")
    for t, dt in ((boxes, torch.float32), (scores, torch.float32),
                  (labels, torch.int32)):
        if t.dtype != dt or t.device != boxes.device:
            raise ValueError("candidates must be f32 boxes, f32 scores and "
                             "int32 labels on one device")
    return boxes.device.type == "cuda"


def greedy_select(boxes, scores, labels, *, conf_threshold: float,
                  iou_threshold: float, max_detections: int,
                  class_aware: bool):
    """Greedy NMS of the ranked candidates of every image, then the first
    ``max_detections`` kept ones in rank order, padded with zeros and
    valid = False. A CUDA input launches ``csrc/nms.cu`` once for the
    batch; its K must fit a CTA's shared memory (``shared_bytes``)."""
    if not _check(boxes, scores, labels, conf_threshold, max_detections):
        return greedy_select_plain(
            boxes, scores, labels, conf_threshold=conf_threshold,
            iou_threshold=iou_threshold, max_detections=max_detections,
            class_aware=class_aware)
    global launches
    b, k = scores.shape
    shared_bytes(k, max_detections)
    boxes, scores, labels = (t.contiguous() for t in (boxes, scores, labels))
    if boxes.data_ptr() % 16:
        raise ValueError("nms kernel reads boxes as float4: they must start "
                         "on a 16-byte boundary")
    dev = boxes.device
    out = (torch.empty((b, max_detections, 4), dtype=torch.float32,
                       device=dev),
           torch.empty((b, max_detections), dtype=torch.float32, device=dev),
           torch.empty((b, max_detections), dtype=torch.int32, device=dev),
           torch.empty((b, max_detections), dtype=torch.bool, device=dev),
           torch.empty((b,), dtype=torch.int32, device=dev))
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yolo_nms(boxes.data_ptr(), scores.data_ptr(),
                           labels.data_ptr(), b, k, max_detections,
                           conf_threshold, iou_threshold, int(class_aware),
                           *(t.data_ptr() for t in out), stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    launches += 1
    return out
