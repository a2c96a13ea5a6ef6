"""Per-model configuration: anchors, thresholds, sizes, class names.

The port's own copy of yolo_tensorflow_tpu/config.py (the JAX package is
never imported here), field for field and value for value;
tests/test_torch_config.py holds the two equal for every model name, and
``config_from_cfg`` equal on a cfg of every model.

One dataclass owns everything the reference scatters across tf.app.flags
(YOLO_V3_convert...py:32-49), constants modules (YOLO_V2/.../config.py:7,
YOLOV3.py:8-12) and hard-coded literals in the pipeline classes.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Tuple

from yolo_tensorflow_tpu_torch.utils.labels import class_names

# v2 anchors are in 13x13-grid units (YOLO_V2/.../config.py:7 and
# YOLO_V2_Tiny_Voc_convert...py:27); v3 anchors are in input pixels
# (YOLOV3.py:12, YOLO_V3_Tiny_convert...py:29).
V2_COCO_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
                   (7.88282, 3.52778), (9.77052, 9.16828))
V2_TINY_VOC_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                       (9.42, 5.11), (16.62, 10.52))
V3_COCO_ANCHORS = ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
                   (59, 119), (116, 90), (156, 198), (373, 326))
V3_TINY_ANCHORS = ((10, 14), (23, 27), (37, 58), (81, 82), (135, 169),
                   (344, 319))


@dataclass(frozen=True)
class ModelConfig:
    name: str
    dataset: str                      # "voc" | "coco"
    head: int                         # 1, 2 or 3 — decode/loss family
    input_size: int
    anchors: Tuple = ()
    anchor_units: str = "grid"        # "grid" (v2) | "pixel" (v3)
    bn_eps: float = 1e-5
    bn_momentum: float = 0.9
    # preprocessing: x/255 ("unit") or (x/255)*2-1 ("symmetric", v1 only —
    # YOLO_V1_Inference.py:69). input_scale lets parity runs reproduce the
    # reference numpy path's /225 quirk (YOLO_V2/.../utils.py:22).
    normalization: str = "unit"
    input_scale: float = 255.0
    conf_threshold: float = 0.5
    iou_threshold: float = 0.5
    max_detections: int = 20
    class_aware_nms: bool = False     # reference in-graph NMS is class-agnostic
    class_softmax: bool = True        # v1/v2 softmax classes; v3 sigmoid
    # NOTE: .weights header width (4 pre-v3 / 5 v3-era int32s) is NOT per-
    # model config: the loader derives it from the file's own version ints
    # (seen is int64 iff major*10+minor >= 2 — io/weights.py), which parses
    # every era correctly where the reference hard-codes count=4/count=5.
    # v1 grid head
    grid: int = 7
    boxes_per_cell: int = 2
    # explicit class-name override (models loaded from arbitrary .cfg files)
    custom_classes: Tuple = ()
    # YOLO9000 softmax-tree file ([region] tree= option); empty = flat
    # softmax. Loaded lazily via models.tree.SoftmaxTree.load.
    tree_file: str = ""

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def classes(self) -> Tuple[str, ...]:
        return self.custom_classes or class_names(self.dataset)

    @property
    def num_anchors(self) -> int:
        return len(self.anchors)


_CONFIGS = {
    "yolov3": ModelConfig(
        name="yolov3", dataset="coco", head=3, input_size=416,
        anchors=V3_COCO_ANCHORS, anchor_units="pixel", class_softmax=False,
        conf_threshold=0.5, iou_threshold=0.5, max_detections=20),
    "yolov3-tiny": ModelConfig(
        name="yolov3-tiny", dataset="coco", head=3, input_size=416,
        anchors=V3_TINY_ANCHORS, anchor_units="pixel", class_softmax=False,
        conf_threshold=0.5, iou_threshold=0.5, max_detections=20),
    "yolov2": ModelConfig(
        name="yolov2", dataset="coco", head=2, input_size=416,
        anchors=V2_COCO_ANCHORS, anchor_units="grid", bn_eps=1e-3,
        conf_threshold=0.5, iou_threshold=0.5, max_detections=20),
    "yolov2-tiny-voc": ModelConfig(
        name="yolov2-tiny-voc", dataset="voc", head=2, input_size=416,
        anchors=V2_TINY_VOC_ANCHORS, anchor_units="grid",
        conf_threshold=0.2, iou_threshold=0.5, max_detections=10),
    "yolov1": ModelConfig(
        name="yolov1", dataset="voc", head=1, input_size=448,
        normalization="symmetric", conf_threshold=0.2, iou_threshold=0.4,
        max_detections=10),
    "yolov1-tiny": ModelConfig(
        name="yolov1-tiny", dataset="voc", head=1, input_size=448,
        conf_threshold=0.2, iou_threshold=0.4, max_detections=10),
    # head=0: classifier (darknet's classifier path, examples/classifier.c)
    "darknet19-classifier": ModelConfig(
        name="darknet19-classifier", dataset="imagenet1k", head=0,
        input_size=256),
}

MODEL_NAMES = tuple(sorted(_CONFIGS))


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def build_specs(cfg: ModelConfig):
    """Instantiate the layer specs for a config."""
    from yolo_tensorflow_tpu_torch.models.zoo import SPEC_BUILDERS
    builder = SPEC_BUILDERS[cfg.name]
    if cfg.head == 1:
        n_out = cfg.grid * cfg.grid * (cfg.boxes_per_cell * 5 + cfg.num_classes)
        return builder(n_out)
    if cfg.head == 2:
        return builder(cfg.num_classes, cfg.num_anchors)
    return builder(cfg.num_classes)


def config_from_cfg(cfg_path: str, *, class_names_file: str = None,
                    name: str = "custom"):
    """Derive (ModelConfig, specs) from an arbitrary darknet .cfg — loads
    any yolo/region/detection network the layer set supports, registry or
    not (parse_network_cfg + the .data names file, examples/detector.c:8).
    """
    from yolo_tensorflow_tpu_torch.io.cfg import parse_cfg_file
    specs, net, heads = parse_cfg_file(cfg_path)
    if not heads:
        # headless cfg -> classifier (darknet's classifier path: any net
        # ending in [softmax]/[cost] with no detection head,
        # examples/classifier.c). The engine reports the last layer's
        # output through a Detect marker, like the registry classifier.
        from yolo_tensorflow_tpu_torch.models import specs as S
        if not isinstance(specs[-1], S.Detect):
            specs = tuple(specs) + (S.Detect(()),)
        input_size = int(net.get("height", 256))
        if class_names_file:
            with open(class_names_file) as f:
                names = tuple(l.strip() for l in f if l.strip())
        else:
            ncls = next((sp.filters if not isinstance(sp, S.Dense)
                         else sp.units for sp in reversed(specs)
                         if isinstance(sp, (S.Conv, S.Local, S.Deconv,
                                            S.Dense))), 2)
            names = tuple(f"class_{i:03d}" for i in range(ncls))
        cfg = ModelConfig(name=name, dataset="custom", head=0,
                          input_size=input_size, custom_classes=names)
        return cfg, specs
    h0 = heads[0]
    kind = h0["_type"]
    input_size = int(net.get("height", 416))
    ncls = int(h0.get("classes", 20))
    if class_names_file:
        with open(class_names_file) as f:
            names = tuple(line.strip() for line in f if line.strip())
        if len(names) != ncls:
            raise ValueError(f"{len(names)} names vs classes={ncls} in cfg")
    else:
        names = tuple(f"class_{i:03d}" for i in range(ncls))

    anchors: Tuple = ()
    if "anchors" in h0:
        vals = [float(v) for v in h0["anchors"].split(",")]
        anchors = tuple((vals[i], vals[i + 1])
                        for i in range(0, len(vals), 2))
    if kind == "yolo":
        cfg = ModelConfig(name=name, dataset="voc", head=3,
                          input_size=input_size, anchors=anchors,
                          anchor_units="pixel", class_softmax=False,
                          custom_classes=names,
                          conf_threshold=0.5, iou_threshold=0.5)
    elif kind == "region":
        tree_file = h0.get("tree", "")
        if tree_file and not os.path.isabs(tree_file):
            tree_file = os.path.join(os.path.dirname(
                os.path.abspath(cfg_path)), tree_file)
        cfg = ModelConfig(name=name, dataset="voc", head=2,
                          input_size=input_size, anchors=anchors,
                          anchor_units="grid", custom_classes=names,
                          conf_threshold=0.5, iou_threshold=0.5,
                          tree_file=tree_file)
    else:  # detection (v1)
        cfg = ModelConfig(name=name, dataset="voc", head=1,
                          input_size=input_size, custom_classes=names,
                          grid=int(h0.get("side", 7)),
                          boxes_per_cell=int(h0.get("num", 2)),
                          conf_threshold=0.2, iou_threshold=0.4)
    return cfg, specs
