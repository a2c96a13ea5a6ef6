"""Detection visualization — the utils.py:65 draw_detection /
show_results (YOLO_V1_Inference.py:394) equivalent, plus boxes.txt output."""

from __future__ import annotations

import colorsys
from typing import Optional, Sequence


def class_colors(n: int):
    """Evenly spaced HSV colors per class (the reference's colorsys loop,
    utils.py:69-74)."""
    out = []
    for i in range(n):
        r, g, b = colorsys.hsv_to_rgb(i / max(n, 1), 1.0, 1.0)
        out.append((int(b * 255), int(g * 255), int(r * 255)))  # BGR for cv2
    return out


def draw_detections(image_bgr, results: Sequence[dict], *,
                    num_classes: Optional[int] = None, thickness: int = 2):
    """Draw boxes + 'class score' labels on a BGR image in place.
    results: dicts from Detector.detect (class/class_id/score/box px)."""
    import cv2
    n = num_classes or (max((r["class_id"] for r in results), default=0) + 1)
    colors = class_colors(n)
    for r in results:
        x0, y0, x1, y1 = (int(v) for v in r["box"])
        color = colors[r["class_id"] % len(colors)]
        cv2.rectangle(image_bgr, (x0, y0), (x1, y1), color, thickness)
        label = f"{r['class']} {r['score']:.2f}"
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(image_bgr, (x0, y0 - th - 8), (x0 + tw + 4, y0),
                      color, -1)
        cv2.putText(image_bgr, label, (x0 + 2, y0 - 5),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    return image_bgr


def write_boxes_txt(path: str, results: Sequence[dict], *,
                    append: bool = True):
    """Persist detections in the reference's boxes.txt format
    (class,x,y,w,h,score — YOLO_V1_Inference.py:418-421 writes
    center+half-extent; here corner+size which the eval tools consume)."""
    mode = "a" if append else "w"
    with open(path, mode) as f:
        for r in results:
            x0, y0, x1, y1 = r["box"]
            f.write(f"{r['class']},{x0:.1f},{y0:.1f},{x1 - x0:.1f},"
                    f"{y1 - y0:.1f},{r['score']:.4f}\n")
