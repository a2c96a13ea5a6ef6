"""Dataset adapters: PASCAL VOC (XML) and COCO (JSON) -> normalized truth
boxes.

Replaces the reference's scripts/voc_label.py:7-24 (VOC XML -> darknet txt
with xywh-normalize `convert`) and the .txt list files darknet's data loader
consumes (src/data.c fill_truth_detection). Also reads darknet-format label
txt files directly, so datasets prepared for the reference work unchanged.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

from yolo_tensorflow_tpu_torch.utils.labels import VOC_CLASSES


class Sample:
    __slots__ = ("image_path", "boxes")

    def __init__(self, image_path: str, boxes: np.ndarray):
        self.image_path = image_path
        self.boxes = boxes  # (N, 5) normalized cx, cy, w, h, class


def parse_voc_xml(xml_path: str,
                  class_names: Sequence[str] = VOC_CLASSES) -> np.ndarray:
    """VOC annotation XML -> (N,5) normalized boxes (voc_label.py convert
    semantics: xml 1-based corner coords -> center xywh / image size)."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w = float(size.find("width").text)
    h = float(size.find("height").text)
    name_to_id = {n: i for i, n in enumerate(class_names)}
    rows = []
    for obj in root.iter("object"):
        name = obj.find("name").text
        if name not in name_to_id:
            continue
        difficult = obj.find("difficult")
        if difficult is not None and difficult.text == "1":
            continue
        bb = obj.find("bndbox")
        x0 = float(bb.find("xmin").text)
        y0 = float(bb.find("ymin").text)
        x1 = float(bb.find("xmax").text)
        y1 = float(bb.find("ymax").text)
        rows.append([(x0 + x1) / 2 / w, (y0 + y1) / 2 / h,
                     (x1 - x0) / w, (y1 - y0) / h, name_to_id[name]])
    return np.asarray(rows, np.float32).reshape(-1, 5)


def load_voc(root: str, image_set: str = "train",
             year: str = "2007") -> List[Sample]:
    """VOCdevkit layout: root/VOC{year}/{ImageSets/Main,Annotations,JPEGImages}."""
    base = os.path.join(root, f"VOC{year}")
    ids_file = os.path.join(base, "ImageSets", "Main", image_set + ".txt")
    with open(ids_file) as f:
        ids = [line.strip() for line in f if line.strip()]
    samples = []
    for i in ids:
        xml = os.path.join(base, "Annotations", i + ".xml")
        img = os.path.join(base, "JPEGImages", i + ".jpg")
        samples.append(Sample(img, parse_voc_xml(xml)))
    return samples


def load_coco(annotation_json: str, image_root: str,
              category_map: Optional[Dict[int, int]] = None) -> List[Sample]:
    """COCO instances JSON -> samples. category_map maps COCO category ids
    to contiguous 0..79 (built from the json if not given)."""
    with open(annotation_json) as f:
        coco = json.load(f)
    if category_map is None:
        cats = sorted(c["id"] for c in coco["categories"])
        category_map = {cid: i for i, cid in enumerate(cats)}
    images = {im["id"]: im for im in coco["images"]}
    by_image: Dict[int, list] = {}
    for ann in coco["annotations"]:
        if ann.get("iscrowd"):
            continue
        x, y, w, h = ann["bbox"]  # pixel xywh, top-left origin
        im = images[ann["image_id"]]
        iw, ih = im["width"], im["height"]
        if w <= 1 or h <= 1:
            continue
        row = [(x + w / 2) / iw, (y + h / 2) / ih, w / iw, h / ih,
               category_map[ann["category_id"]]]
        by_image.setdefault(ann["image_id"], []).append(row)
    samples = []
    for img_id, im in images.items():
        boxes = np.asarray(by_image.get(img_id, []), np.float32).reshape(-1, 5)
        samples.append(Sample(os.path.join(image_root, im["file_name"]), boxes))
    return samples


def load_darknet_list(list_file: str) -> List[Sample]:
    """darknet train-list format: one image path per line, labels in a
    sibling 'labels/xxx.txt' with 'cls cx cy w h' rows (what voc_label.py
    emits and src/data.c fill_truth_detection reads)."""
    samples = []
    with open(list_file) as f:
        for line in f:
            img = line.strip()
            if not img:
                continue
            lab = img
            for a, b in ((os.sep + "images" + os.sep, os.sep + "labels" + os.sep),
                         (os.sep + "JPEGImages" + os.sep, os.sep + "labels" + os.sep)):
                lab = lab.replace(a, b)
            lab = os.path.splitext(lab)[0] + ".txt"
            rows = []
            if os.path.exists(lab):
                with open(lab) as lf:
                    for r in lf:
                        p = r.split()
                        if len(p) == 5:
                            rows.append([float(p[1]), float(p[2]),
                                         float(p[3]), float(p[4]), float(p[0])])
            samples.append(Sample(
                img, np.asarray(rows, np.float32).reshape(-1, 5)))
    return samples


def write_darknet_labels(root: str, image_sets, *, year: str = "2007",
                         out_list_dir: str = ".") -> List[str]:
    """The WRITE half of scripts/voc_label.py:7-24: for each VOC image-set,
    convert every annotation XML into 'labels/<id>.txt' files with
    'cls cx cy w h' rows (xywh-normalized like voc_label's convert()) and
    emit a '<year>_<set>.txt' image list. Returns the list-file paths."""
    base = os.path.join(root, f"VOC{year}")
    labels_dir = os.path.join(base, "labels")
    os.makedirs(labels_dir, exist_ok=True)
    os.makedirs(out_list_dir, exist_ok=True)
    lists = []
    for image_set in ([image_sets] if isinstance(image_sets, str)
                      else image_sets):
        ids_file = os.path.join(base, "ImageSets", "Main",
                                f"{image_set}.txt")
        with open(ids_file) as f:
            ids = [l.strip() for l in f if l.strip()]
        list_path = os.path.join(out_list_dir, f"{year}_{image_set}.txt")
        with open(list_path, "w") as lf:
            for img_id in ids:
                xml = os.path.join(base, "Annotations", f"{img_id}.xml")
                boxes = parse_voc_xml(xml)
                with open(os.path.join(labels_dir,
                                       f"{img_id}.txt"), "w") as out:
                    for cx, cy, w, h, cls in boxes:
                        out.write(f"{int(cls)} {cx:.6f} {cy:.6f} "
                                  f"{w:.6f} {h:.6f}\n")
                lf.write(os.path.join(base, "JPEGImages",
                                      f"{img_id}.jpg") + "\n")
        lists.append(list_path)
    return lists


def load_classifier_list(list_file: str, class_names) -> List[Sample]:
    """Classifier training list: one image path per line, label inferred by
    class-name substring match on the path — fill_truth's convention
    (src/data.c:504, used by examples/classifier.c train_classifier).
    Returns Samples whose single pseudo-box carries the label in column 4
    so the detection loader machinery (threading, augmentation) is reused;
    the classifier trainer reads labels from truths[:, 0, 4]."""
    samples = []
    with open(list_file) as f:
        for line in f:
            path = line.strip()
            if not path:
                continue
            hits = [i for i, n in enumerate(class_names) if n in path]
            if len(hits) != 1:
                raise ValueError(
                    f"too many or too few labels ({len(hits)}) for {path} "
                    "— exactly one class name must appear in the path")
            box = np.asarray([[0.5, 0.5, 1.0, 1.0, hits[0]]], np.float32)
            samples.append(Sample(path, box))
    return samples
