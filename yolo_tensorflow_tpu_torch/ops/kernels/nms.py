"""The NMS stage: one CUDA kernel from the decode to the Detections, and its
plain twin.

Counterpart of yolo_tensorflow_tpu/post/nms.py's ``_nms_single``: the
top-K candidates (``lax.approx_max_k`` / ``lax.top_k``, :144-146), the greedy
fixpoint ``_greedy_keep`` (:103) and the final ``lax.top_k`` to
``max_detections`` (:167). On the TPU that was XLA, not a Pallas kernel;
PyTorch has no loop that stays on the device, so the plain version syncs
with the host once a fixpoint round and the card has a kernel of its own:
``csrc/nms.cu`` (its header says what bounds it and how it works), one CTA
an image, which selects the exact top K, ranks them and walks the greedy
chain in one launch.

Both take the unranked decode: boxes (B, N, 4) xyxy f32, scores (B, N) f32,
labels (B, N) int32. Both return the five ``Detections`` fields: boxes
(B, D, 4), scores (B, D), classes (B, D) int32, valid (B, D) bool and num
(B,) int32. The plain version, ``nms_plain``, is ``select_candidates`` (a
stable sort of the masked scores and gathers: ``lax.top_k``'s order) then
``greedy_select_plain`` (the batched fixpoint over the K ranked ones).

``greedy_nms`` calls the operator ``yolo_torch::nms`` (ops/kernels/
library.py), whose implementation is picked by the device of the input: a
CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version, a fake one (under ``torch.export``) gives the output shapes.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from yolo_tensorflow_tpu_torch.ops.kernels import build, library

launches = 0

# limits of csrc/nms.cu (kThreads, kMaxSharedBytes, kBins,
# kBytesPerCandidate, kBytesPerScore, kFixedBytes);
# tests/test_torch_kernel_host.py holds them to the source
THREADS = 512
MAX_SHARED_BYTES = 227 * 1024
BINS = 256
BYTES_PER_CANDIDATE = 16 + 8 + 4 + 4 + 4
BYTES_PER_SCORE = 4
FIXED_BYTES = BINS * (THREADS // 32) * 4 + 2 * (THREADS // 32) * 4 + 8 * 4


class Plan(NamedTuple):
    candidates: int       # K = min(num_candidates, N)
    shared_bytes: int     # dynamic shared memory of one CTA
    staged: bool          # keys and candidates in shared memory
    scratch_bytes: int    # a CTA's candidates in device memory, if not


def plan(num_rows: int, num_candidates: int, max_detections: int) -> Plan:
    """How csrc/nms.cu runs an image of ``num_rows`` (N) decoded rows: with
    its keys and K candidates staged in shared memory where they fit, else
    with the candidates in scratch and the keys read again each pass. Raises
    where even the kept list does not fit a CTA."""
    k = min(num_candidates, num_rows)
    small = 4 * max_detections + FIXED_BYTES
    staged = small + k * BYTES_PER_CANDIDATE + num_rows * BYTES_PER_SCORE
    if staged <= MAX_SHARED_BYTES:
        return Plan(k, staged, True, 0)
    if small > MAX_SHARED_BYTES:
        raise ValueError(
            f"nms kernel: {max_detections} detections need {small} bytes "
            f"of shared memory, more than the {MAX_SHARED_BYTES} a CTA has")
    return Plan(k, small, False, k * BYTES_PER_CANDIDATE)


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


def select_candidates(boxes_xyxy, scores, labels, *,
                      conf_threshold: float, num_candidates: int):
    """(B, N, 4), (B, N), (B, N) -> the top K = min(num_candidates, N)
    candidates of each image in descending order of their masked scores:
    boxes (B, K, 4), scores (B, K), labels (B, K). Equal scores keep their
    index order, as the TPU package's ``lax.top_k`` does (``torch.topk``
    promises no order among them, and bf16 scores tie often)."""
    k = min(num_candidates, scores.shape[1])
    masked = torch.where(scores > conf_threshold, scores,
                         torch.full_like(scores, -1.0))
    top_scores, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = boxes_xyxy.gather(1, idx[:, :, None].expand(-1, -1, 4))
    return top_boxes, top_scores, labels.gather(1, idx)


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
    """Greedy NMS of the K ranked candidates of every image, then the first
    ``max_detections`` kept ones in rank order, padded with zeros and
    valid = False; plain PyTorch, on any device."""
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


def nms_plain(boxes, scores, labels, *, conf_threshold: float,
              iou_threshold: float, max_detections: int, num_candidates: int,
              class_aware: bool):
    """Plain PyTorch version of ``greedy_nms``, on any device:
    ``select_candidates``, then ``greedy_select_plain``."""
    candidates = select_candidates(boxes, scores, labels,
                                   conf_threshold=conf_threshold,
                                   num_candidates=num_candidates)
    return greedy_select_plain(*candidates, conf_threshold=conf_threshold,
                               iou_threshold=iou_threshold,
                               max_detections=max_detections,
                               class_aware=class_aware)


def _check(boxes, scores, labels, conf_threshold, max_detections,
           num_candidates):
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms runs on cpu or cuda, not {boxes.device}")
    if max_detections < 1 or num_candidates < 1:
        raise ValueError(f"max_detections and num_candidates must be at "
                         f"least 1, not {max_detections} and "
                         f"{num_candidates}")
    if not conf_threshold >= -1.0:
        raise ValueError(f"conf_threshold {conf_threshold} is below -1, the "
                         "score that sinks a candidate that is not kept")
    if scores.dim() != 2:
        raise ValueError(f"scores must be (B, N), not {tuple(scores.shape)}")
    b, n = scores.shape
    if boxes.shape != (b, n, 4) or labels.shape != (b, n):
        raise ValueError(f"the decode must be boxes (B, N, 4), scores "
                         f"(B, N) and labels (B, N), not "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}, "
                         f"{tuple(labels.shape)}")
    for t, dt in ((boxes, torch.float32), (scores, torch.float32),
                  (labels, torch.int32)):
        if t.dtype != dt or t.device != boxes.device:
            raise ValueError("the decode must be f32 boxes, f32 scores and "
                             "int32 labels on one device")


def _outputs(b, max_detections, device):
    return (torch.empty((b, max_detections, 4), dtype=torch.float32,
                        device=device),
            torch.empty((b, max_detections), dtype=torch.float32,
                        device=device),
            torch.empty((b, max_detections), dtype=torch.int32,
                        device=device),
            torch.empty((b, max_detections), dtype=torch.bool, device=device),
            torch.empty((b,), dtype=torch.int32, device=device))


def _nms_cpu(boxes, scores, labels, conf_threshold, iou_threshold,
             max_detections, num_candidates, class_aware):
    """The operator on CPU tensors: the plain version."""
    return nms_plain(boxes, scores, labels, conf_threshold=conf_threshold,
                     iou_threshold=iou_threshold,
                     max_detections=max_detections,
                     num_candidates=num_candidates, class_aware=class_aware)


def _nms_cuda(boxes, scores, labels, conf_threshold, iou_threshold,
              max_detections, num_candidates, class_aware):
    """The operator on CUDA tensors: one launch of csrc/nms.cu for the
    batch (scratch, where the plan needs it, from torch.empty)."""
    global launches
    b, n = scores.shape
    p = plan(n, num_candidates, max_detections)
    boxes, scores, labels = (t.contiguous() for t in (boxes, scores, labels))
    dev = boxes.device
    out = _outputs(b, max_detections, dev)
    scratch = None if p.staged else torch.empty(
        (b * p.scratch_bytes,), dtype=torch.uint8, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yolo_nms(boxes.data_ptr(), scores.data_ptr(),
                           labels.data_ptr(), b, n, p.candidates,
                           max_detections, conf_threshold, iou_threshold,
                           int(class_aware),
                           None if scratch is None else scratch.data_ptr(),
                           *(t.data_ptr() for t in out), stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _nms_fake(boxes, scores, labels, conf_threshold, iou_threshold,
              max_detections, num_candidates, class_aware):
    return _outputs(scores.shape[0], max_detections, boxes.device)


nms_op = library.define(
    "nms(Tensor boxes, Tensor scores, Tensor labels, float conf_threshold, "
    "float iou_threshold, int max_detections, int num_candidates, "
    "bool class_aware) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    cpu=_nms_cpu, cuda=_nms_cuda, fake=_nms_fake)


def greedy_nms(boxes, scores, labels, *, conf_threshold: float,
               iou_threshold: float, max_detections: int,
               num_candidates: int, class_aware: bool):
    """NMS of every image of the unranked decode: its exact top
    ``num_candidates`` active candidates (``lax.top_k``'s order), greedy
    NMS over them, and the first ``max_detections`` kept ones in rank
    order, padded with zeros and valid = False, through the operator
    ``yolo_torch::nms``. A CUDA input launches ``csrc/nms.cu`` once for the
    batch, or raises (``plan``) before any launch."""
    _check(boxes, scores, labels, conf_threshold, max_detections,
           num_candidates)
    return nms_op(boxes, scores, labels, float(conf_threshold),
                  float(iou_threshold), int(max_detections),
                  int(num_candidates), bool(class_aware))
