"""Class-name tables for the datasets the reference models ship with.

The port's own copy of yolo_tensorflow_tpu/utils/labels.py.

Replaces the reference's file-based label readers
(YOLO_V2/.../config.py:13 ``read_coco_labels`` reading yolo2_data/coco_classes.txt,
and the hard-coded VOC list in YOLO_V1_Inference.py:37-40); the lists are
standard public datasets so we embed them.
"""

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable",
    "dog", "horse", "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
)

COCO_CLASSES = (
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "sofa", "pottedplant", "bed", "diningtable", "toilet", "tvmonitor",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)

assert len(VOC_CLASSES) == 20
assert len(COCO_CLASSES) == 80


def class_names(dataset: str):
    if dataset == "voc":
        return VOC_CLASSES
    if dataset == "coco":
        return COCO_CLASSES
    if dataset == "imagenet1k":
        # the reference reads names from .data files (examples/classifier.c);
        # placeholder ids keep the registry self-contained, pass a names
        # file through the CLI for display names
        return tuple(f"class_{i:04d}" for i in range(1000))
    raise ValueError(f"unknown dataset {dataset!r}")
