"""Detection mAP evaluation.

The quantitative half the reference only sketches: examples/detector.c:364
(validate_detector) writes VOC/COCO result files for *external* scorers and
:489 (validate_detector_recall) prints IoU/recall. Here the scoring is
built in: VOC-style AP per class (both VOC2007 11-point and continuous
area-under-PR) and COCO-style mAP@[.5:.95].
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) -> (N,M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ix0 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy0 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix1 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    aa = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    ab = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-9)


def average_precision(recall, precision, *, eleven_point=False) -> float:
    """VOC AP. eleven_point=True: VOC2007 11-point interpolation; else
    continuous area under the monotonized PR curve (VOC2010+/COCO style)."""
    if eleven_point:
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            mask = recall >= t
            ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def evaluate_detections(
        detections: Sequence[Dict], groundtruth: Sequence[Dict],
        num_classes: int, iou_thresholds: Sequence[float] = (0.5,),
        eleven_point: bool = False) -> Dict:
    """Score detections against ground truth.

    detections: per image {"boxes": (D,4) xyxy px, "scores": (D,),
    "classes": (D,)}. groundtruth: per image {"boxes": (G,4), "classes": (G,)}.
    Returns {"map": mean over classes & thresholds, "ap_per_class": ...,
    "map_per_threshold": ...}.
    """
    assert len(detections) == len(groundtruth)
    aps = np.zeros((len(iou_thresholds), num_classes), np.float64)
    valid = np.zeros(num_classes, bool)

    # Pre-split every image's detections/gts by class ONCE and cache the
    # per-(image, class) IoU matrix across all thresholds — the matching
    # below never touches a box again. Greedy matching is per-image state,
    # so it runs per image (in within-image score order) and the global
    # score ordering is applied to the tp/fp flags afterwards; this is
    # equivalent to the global greedy walk because matches never interact
    # across images.
    det_np = [(np.asarray(d["boxes"], np.float32),
               np.asarray(d["scores"], np.float32),
               np.asarray(d["classes"])) for d in detections]
    gt_np = [(np.asarray(g["boxes"], np.float32),
              np.asarray(g["classes"])) for g in groundtruth]

    for c in range(num_classes):
        n_gt = 0
        entries = []   # (scores_sorted, best_iou, best_j, n_gts) per image
        for i in range(len(det_np)):
            dboxes, dscores, dcls = det_np[i]
            gboxes, gcls = gt_np[i]
            gsel = gboxes[gcls == c] if len(gcls) else gboxes[:0]
            n_gt += len(gsel)
            dm = dcls == c
            if not dm.any():
                continue
            sc = dscores[dm]
            order = np.argsort(-sc, kind="stable")
            sc = sc[order]
            if len(gsel):
                ious = box_iou_xyxy(dboxes[dm][order], gsel)
                best_j = ious.argmax(axis=1)
                best_iou = ious[np.arange(len(sc)), best_j]
            else:
                best_j = np.zeros(len(sc), np.int32)
                best_iou = np.full(len(sc), -1.0, np.float32)
            entries.append((sc, best_iou, best_j, len(gsel)))
        if n_gt == 0:
            continue
        valid[c] = True
        if not entries:
            continue
        all_scores = np.concatenate([e[0] for e in entries])
        global_order = np.argsort(-all_scores, kind="stable")

        for ti, thr in enumerate(iou_thresholds):
            tps = []
            for sc, best_iou, best_j, g in entries:
                # Vectorized greedy match. Each detection claims only its
                # single best-IoU gt (best_j is fixed across thresholds), so
                # the sequential walk "TP iff IoU>=thr and gt unclaimed"
                # reduces to: the FIRST (highest-score) qualifying detection
                # per gt is TP, all later claimants are FP. np.unique's
                # return_index gives exactly those first occurrences.
                tp = np.zeros(len(sc), bool)
                if g:
                    kk = np.flatnonzero(best_iou >= thr)
                    if len(kk):
                        _, first = np.unique(best_j[kk], return_index=True)
                        tp[kk[first]] = True
                tps.append(tp)
            tp = np.concatenate(tps)[global_order]
            ctp = np.cumsum(tp)
            cfp = np.cumsum(~tp)
            recall = ctp / n_gt
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            aps[ti, c] = average_precision(recall, precision,
                                           eleven_point=eleven_point)

    per_thr = aps[:, valid].mean(axis=1) if valid.any() else np.zeros(len(iou_thresholds))
    return {
        "map": float(per_thr.mean()),
        "map_per_threshold": {float(t): float(v)
                              for t, v in zip(iou_thresholds, per_thr)},
        "ap_per_class": {c: float(aps[:, c].mean())
                         for c in range(num_classes) if valid[c]},
        "num_classes_evaluated": int(valid.sum()),
    }


def coco_map(detections, groundtruth, num_classes) -> Dict:
    """COCO mAP@[.5:.95:.05] (area under PR, continuous)."""
    thrs = np.round(np.arange(0.5, 1.0, 0.05), 2)
    return evaluate_detections(detections, groundtruth, num_classes,
                               iou_thresholds=thrs, eleven_point=False)


# --------------------------------------------------------------------------
# Interchange result files for external scorers — what validate_detector
# emits (examples/detector.c:364: print_detector_detections for VOC,
# print_cocos for COCO-json), so results diff against darknet's.
# --------------------------------------------------------------------------

# darknet's 80->91 COCO category remap (examples/detector.c:3 coco_ids[])
COCO_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19,
            20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38,
            39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
            56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75,
            76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90)


def write_voc_results(out_dir: str, class_names, per_image, *,
                      prefix: str = "comp4_det_test_") -> None:
    """VOC per-class files (print_detector_detections,
    examples/detector.c:191): one '<id> <score> <xmin> <ymin> <xmax> <ymax>'
    line per detection, 1-based coords clipped to [1, w/h].

    per_image: iterable of (image_id, width, height, results) where results
    is the Detector.detect list-of-dicts (pixel xyxy boxes)."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    files = {c: open(os.path.join(out_dir, f"{prefix}{name}.txt"), "w")
             for c, name in enumerate(class_names)}
    try:
        for image_id, w, h, results in per_image:
            for r in results:
                x0, y0, x1, y1 = r["box"]
                xmin = max(x0 + 1, 1)
                ymin = max(y0 + 1, 1)
                xmax = min(x1 + 1, w)
                ymax = min(y1 + 1, h)
                files[r["class_id"]].write(
                    f"{image_id} {r['score']:f} {xmin:f} {ymin:f} "
                    f"{xmax:f} {ymax:f}\n")
    finally:
        for f in files.values():
            f.close()


def write_coco_results(out_path: str, per_image, *,
                       category_ids=COCO_IDS) -> None:
    """COCO results json (print_cocos, examples/detector.c:165): a list of
    {image_id, category_id, bbox [x, y, w, h], score} records, boxes clipped
    to the image. per_image: iterable of (image_id, width, height, results);
    image_id must already be the numeric COCO id (get_coco_image_id)."""
    import json
    records = []
    for image_id, w, h, results in per_image:
        for r in results:
            x0, y0, x1, y1 = r["box"]
            x0 = max(x0, 0.0)
            y0 = max(y0, 0.0)
            x1 = min(x1, w)
            y1 = min(y1, h)
            records.append({
                "image_id": int(image_id),
                "category_id": int(category_ids[r["class_id"]])
                if category_ids else int(r["class_id"]),
                "bbox": [round(x0, 3), round(y0, 3),
                         round(x1 - x0, 3), round(y1 - y0, 3)],
                "score": round(float(r["score"]), 6),
            })
    with open(out_path, "w") as f:
        json.dump(records, f)


def write_imagenet_results(out_path: str, per_image) -> None:
    """ImageNet-detection results file (print_imagenet_detections,
    examples/detector.c:212-233, selected when the .data file says
    ``eval=imagenet``, detector.c:400-404): one
    '<id> <class+1> <score> <xmin> <ymin> <xmax> <ymax>' line per
    detection. Unlike the VOC writer this clamps at 0 (no 1-based +1
    shift) and the image id is the 1-based RUNNING INDEX of the image in
    the valid list (validate_detector passes ``i+t-nthreads+1``,
    detector.c:469), not the file stem; the class id is 1-based (``j+1``).

    Pinned upstream quirk (documented, not reproduced): the C forces
    ``classes = 200`` in imagenet mode (detector.c:404) but
    ``dets[i].prob`` only holds the model's own class count
    (make_network_boxes, src/network.c:616) — for any model with fewer
    than 200 classes the print loop reads past the prob array (heap
    overread, garbage lines). We write the model's real classes only.

    per_image: iterable of (image_id, width, height, results); pass the
    running 1-based index as image_id for C-equivalent output."""
    with open(out_path, "w") as f:
        for image_id, w, h, results in per_image:
            for r in results:
                x0, y0, x1, y1 = r["box"]
                xmin = max(x0, 0.0)
                ymin = max(y0, 0.0)
                xmax = min(x1, w)
                ymax = min(y1, h)
                f.write(f"{image_id} {r['class_id'] + 1} {r['score']:f} "
                        f"{xmin:f} {ymin:f} {xmax:f} {ymax:f}\n")


def coco_image_id(path: str) -> int:
    """get_coco_image_id (examples/detector.c:157): numeric tail of the
    file name after the last '_' (or '/')."""
    import os
    base = os.path.splitext(os.path.basename(path))[0]
    tail = base.rsplit("_", 1)[-1]
    digits = "".join(ch for ch in tail if ch.isdigit())
    return int(digits) if digits else 0


def recall_stats(detections, groundtruth, *, iou_threshold: float = 0.5):
    """validate_detector_recall (examples/detector.c:489-558): per ground
    truth box, the best IoU over ALL detections regardless of class;
    recall = fraction above the IoU threshold; avg_iou over truths;
    proposals per image. detections/groundtruth use the evaluate_detections
    format (pixel-space xyxy boxes)."""
    total = correct = proposals = 0
    iou_sum = 0.0
    for det, gt in zip(detections, groundtruth):
        db = np.asarray(det["boxes"], np.float32).reshape(-1, 4)
        proposals += len(db)
        gb = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)
        if not len(gb):
            continue
        ious = box_iou_xyxy(gb, db) if len(db) else \
            np.zeros((len(gb), 0), np.float32)
        best = ious.max(axis=1) if len(db) else np.zeros(len(gb))
        total += len(gb)
        iou_sum += float(best.sum())
        correct += int((best > iou_threshold).sum())
    return {
        "recall": correct / max(total, 1),
        "avg_iou": iou_sum / max(total, 1),
        "proposals_per_image": proposals / max(len(detections), 1),
        "truths": total,
        "correct": correct,
    }
