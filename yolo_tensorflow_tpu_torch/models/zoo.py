"""The six model variants of the reference, as declarative specs.

The port's own copy of yolo_tensorflow_tpu/models/zoo.py, built from the
port's spec classes (models/specs.py); tests/test_torch_config.py holds the
two equal for every model name.

Layer order inside each spec tuple is EXACTLY darknet ``.weights`` file
order — the weight loader (io/weights.py) walks the spec sequentially, so
ordering here is the load contract (replacing the reference's reliance on
TF variable-creation order + name sniffing, YOLOV3.py:385-441).

Sources in the reference repository (architecture, cited for parity
checking — not translated code):
  yolov3        YOLO_V3/YOLOv3-Tensorflow-detect-export/YOLOV3.py:15-344
  yolov3-tiny   Darknet2Tensorflow/darknet-master/YOLO_V3_Tiny_convert_darkenet_to_Tensorflow.py:376-470
  yolov2        YOLO_V2/YOLOv2-Tensorflow-detect-export/model_darknet19.py:71-116
  yolov2-tiny   Darknet2Tensorflow/darknet-master/YOLO_V2_Tiny_Voc_convert_darkenet_to_Tensorflow.py:162-226
  yolov1        YOLO_V1/YOLOv1-Tensorflow-detect-export/YOLO_V1_Inference.py:124-210
  yolov1-tiny   Darknet2Tensorflow/darknet-master/YOLO_V1_Tiny_convert_darkenet_to_Tensorflow.py:256-322
"""

from __future__ import annotations

from yolo_tensorflow_tpu_torch.models.specs import (GlobalAvgPool, Softmax,
                                                    SpecBuilder)


def _dn53_block(b: SpecBuilder, filters: int) -> int:
    """Darknet-53 residual block: 1x1 squeeze, 3x3 expand, add."""
    b.conv(filters, 1)
    b.conv(filters * 2, 3)
    return b.shortcut(-3)


def yolov3_specs(num_classes: int = 80):
    """Darknet-53 backbone + 3-scale FPN + per-scale 1x1 detect convs."""
    b = SpecBuilder()
    per_scale = 3 * (5 + num_classes)

    # --- Darknet-53 ---
    b.conv(32, 3)
    b.conv(64, 3, stride=2)
    _dn53_block(b, 32)
    b.conv(128, 3, stride=2)
    for _ in range(2):
        _dn53_block(b, 64)
    b.conv(256, 3, stride=2)
    for _ in range(8):
        _dn53_block(b, 128)
    route_1 = b.last                      # 52x52x256
    b.conv(512, 3, stride=2)
    for _ in range(8):
        _dn53_block(b, 256)
    route_2 = b.last                      # 26x26x512
    b.conv(1024, 3, stride=2)
    for _ in range(4):
        _dn53_block(b, 512)               # 13x13x1024

    # --- FPN scale 1 (13x13, large-object anchors 6:9) ---
    b.conv(512, 1)
    b.conv(1024, 3)
    b.conv(512, 1)
    b.conv(1024, 3)
    mid_1 = b.conv(512, 1)
    b.conv(1024, 3)
    b.conv(per_scale, 1, bn=False, act="linear")
    b.detect((6, 7, 8))

    # --- FPN scale 2 (26x26, anchors 3:6) ---
    b.route(mid_1)
    b.conv(256, 1)
    b.upsample()
    b.route(-1, route_2)                  # [upsampled, route_2] concat order
    b.conv(256, 1)
    b.conv(512, 3)
    b.conv(256, 1)
    b.conv(512, 3)
    mid_2 = b.conv(256, 1)
    b.conv(512, 3)
    b.conv(per_scale, 1, bn=False, act="linear")
    b.detect((3, 4, 5))

    # --- FPN scale 3 (52x52, anchors 0:3) ---
    b.route(mid_2)
    b.conv(128, 1)
    b.upsample()
    b.route(-1, route_1)
    b.conv(128, 1)
    b.conv(256, 3)
    b.conv(128, 1)
    b.conv(256, 3)
    b.conv(128, 1)
    b.conv(256, 3)
    b.conv(per_scale, 1, bn=False, act="linear")
    b.detect((0, 1, 2))
    return b.specs()


def yolov3_tiny_specs(num_classes: int = 80):
    b = SpecBuilder()
    per_scale = 3 * (5 + num_classes)

    b.conv(16, 3)
    b.maxpool()
    b.conv(32, 3)
    b.maxpool()
    b.conv(64, 3)
    b.maxpool()
    b.conv(128, 3)
    b.maxpool()
    route_1 = b.conv(256, 3)              # 26x26x256
    b.maxpool()
    b.conv(512, 3)
    b.maxpool(2, 1)                       # stride-1 SAME pool6
    b.conv(1024, 3)
    route_2 = b.conv(256, 1)              # 13x13x256
    b.conv(512, 3)
    b.conv(per_scale, 1, bn=False, act="linear")
    b.detect((3, 4, 5))

    b.route(route_2)
    b.conv(128, 1)
    b.upsample()
    b.route(-1, route_1)
    b.conv(256, 3)
    b.conv(per_scale, 1, bn=False, act="linear")
    b.detect((0, 1, 2))
    return b.specs()


def yolov2_specs(num_classes: int = 80, num_anchors: int = 5):
    """Darknet-19 + reorg passthrough; detect head 1x1 conv with bias."""
    b = SpecBuilder()
    b.conv(32, 3)
    b.maxpool()
    b.conv(64, 3)
    b.maxpool()
    b.conv(128, 3)
    b.conv(64, 1)
    b.conv(128, 3)
    b.maxpool()
    b.conv(256, 3)
    b.conv(128, 1)
    b.conv(256, 3)
    b.maxpool()
    b.conv(512, 3)
    b.conv(256, 1)
    b.conv(512, 3)
    b.conv(256, 1)
    passthrough = b.conv(512, 3)          # 26x26x512
    b.maxpool()
    b.conv(1024, 3)
    b.conv(512, 1)
    b.conv(1024, 3)
    b.conv(512, 1)
    b.conv(1024, 3)
    b.conv(1024, 3)                       # conv7_1
    main = b.conv(1024, 3)                # conv7_2
    b.route(passthrough)
    b.conv(64, 1)                         # conv_shortcut
    reorged = b.reorg(2)                  # 13x13x256
    b.route(reorged, main)                # [reorg, net] concat order
    b.conv(1024, 3)                       # conv8
    b.conv(num_anchors * (5 + num_classes), 1, bn=False, act="linear")
    b.detect(tuple(range(num_anchors)))
    return b.specs()


def yolov2_tiny_specs(num_classes: int = 20, num_anchors: int = 5):
    b = SpecBuilder()
    for f in (16, 32, 64, 128, 256):
        b.conv(f, 3)
        b.maxpool()
    b.conv(512, 3)
    b.maxpool(2, 1)                       # stride-1 SAME pool6
    b.conv(1024, 3)
    b.conv(1024, 3)
    b.conv(num_anchors * (5 + num_classes), 1, bn=False, act="linear")
    b.detect(tuple(range(num_anchors)))
    return b.specs()


def yolov1_specs(num_outputs: int = 1470):
    """GoogLeNet-style 24-conv + 3-FC YOLOv1; plain conv+bias (no BN),
    matching the YOLO_small.ckpt layout the reference loads."""
    b = SpecBuilder()

    def c(f, k, s=1):
        return b.conv(f, k, stride=s, bn=False)

    c(64, 7, 2)
    b.maxpool()
    c(192, 3)
    b.maxpool()
    c(128, 1)
    c(256, 3)
    c(256, 1)
    c(512, 3)
    b.maxpool()
    for _ in range(4):
        c(256, 1)
        c(512, 3)
    c(512, 1)
    c(1024, 3)
    b.maxpool()
    c(512, 1)
    c(1024, 3)
    c(512, 1)
    c(1024, 3)
    c(1024, 3)
    c(1024, 3, 2)
    c(1024, 3)
    c(1024, 3)
    b.transpose_flatten()
    b.dense(512)
    b.dense(4096)
    b.dropout(0.5)
    b.dense(num_outputs, act="linear")
    b.detect(())
    return b.specs()


def yolov1_tiny_specs(num_outputs: int = 1470):
    """8 BN-convs + FC head (the converter's yolov1-tiny)."""
    b = SpecBuilder()
    for f in (16, 32, 64, 128, 256, 512):
        b.conv(f, 3)
        b.maxpool()
    b.conv(1024, 3)
    b.conv(256, 3)
    b.transpose_flatten()
    b.dense(num_outputs, act="linear")
    b.detect(())
    return b.specs()


def darknet19_classifier_specs(num_classes: int = 1000):
    """Darknet-19 ImageNet classifier (the backbone yolov2 fine-tunes from;
    darknet's classifier path, examples/classifier.c): 19 convs + 1x1 head
    + global avgpool + softmax."""
    b = SpecBuilder()
    b.conv(32, 3)
    b.maxpool()
    b.conv(64, 3)
    b.maxpool()
    b.conv(128, 3)
    b.conv(64, 1)
    b.conv(128, 3)
    b.maxpool()
    b.conv(256, 3)
    b.conv(128, 1)
    b.conv(256, 3)
    b.maxpool()
    b.conv(512, 3)
    b.conv(256, 1)
    b.conv(512, 3)
    b.conv(256, 1)
    b.conv(512, 3)
    b.maxpool()
    b.conv(1024, 3)
    b.conv(512, 1)
    b.conv(1024, 3)
    b.conv(512, 1)
    b.conv(1024, 3)
    b.conv(num_classes, 1, bn=False, act="linear")
    b.add(GlobalAvgPool())
    b.add(Softmax())
    b.detect(())
    return b.specs()


SPEC_BUILDERS = {
    "darknet19-classifier": darknet19_classifier_specs,
    "yolov3": yolov3_specs,
    "yolov3-tiny": yolov3_tiny_specs,
    "yolov2": yolov2_specs,
    "yolov2-tiny-voc": yolov2_tiny_specs,
    "yolov1": yolov1_specs,
    "yolov1-tiny": yolov1_tiny_specs,
}
