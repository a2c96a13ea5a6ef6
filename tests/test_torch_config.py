"""The port's own copies of the JAX package's framework-free modules
(config.py, models/specs.py, models/zoo.py, utils/labels.py) equal the
originals: every config field by field, every spec list spec by spec, for
every model name. The port's specs are built from the port's classes, which
its engine dispatches on with ``isinstance``."""

import dataclasses

import pytest

from yolo_tensorflow_tpu import config as JC
from yolo_tensorflow_tpu.utils import labels as JLB
from yolo_tensorflow_tpu_torch import config as TC
from yolo_tensorflow_tpu_torch.models import specs as TS
from yolo_tensorflow_tpu_torch.utils import labels as TLB


def _fields(obj):
    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]


def test_model_names_and_anchors_match():
    assert TC.MODEL_NAMES == JC.MODEL_NAMES
    for name in ("V2_COCO_ANCHORS", "V2_TINY_VOC_ANCHORS", "V3_COCO_ANCHORS",
                 "V3_TINY_ANCHORS"):
        assert getattr(TC, name) == getattr(JC, name), name


@pytest.mark.parametrize("dataset", ["voc", "coco", "imagenet1k"])
def test_labels_match(dataset):
    assert TLB.class_names(dataset) == JLB.class_names(dataset)


@pytest.mark.parametrize("name", JC.MODEL_NAMES)
def test_config_and_specs_match(name):
    got, want = TC.get_config(name), JC.get_config(name)
    assert _fields(got) == _fields(want)
    assert (got.classes, got.num_classes, got.num_anchors) == (
        want.classes, want.num_classes, want.num_anchors)
    port, jax = TC.build_specs(got), JC.build_specs(want)
    assert len(port) == len(jax) > 0
    for i, (p, j) in enumerate(zip(port, jax)):
        assert type(p).__name__ == type(j).__name__, i
        assert type(p) is getattr(TS, type(p).__name__), i
        assert _fields(p) == _fields(j), i


def test_overrides_match():
    kw = dict(input_size=608, conf_threshold=0.25)
    assert (_fields(TC.get_config("yolov3", **kw))
            == _fields(JC.get_config("yolov3", **kw)))


# ---------------------------------------------------------------- copies of
# the framework-free modules the trainer and evaluation need: the source
# equal line for line, the imports pointed into the port

COPIES = ("io/cfg.py", "io/datacfg.py", "data/datasets.py",
          "data/augment.py", "post/numpy_post.py", "eval/map.py",
          "eval/__init__.py", "utils/drawing.py")


@pytest.mark.parametrize("rel", COPIES)
def test_module_copies_equal_their_originals(rel):
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "yolo_tensorflow_tpu", rel)) as f:
        want = f.read()
    with open(os.path.join(root, "yolo_tensorflow_tpu_torch", rel)) as f:
        got = f.read()
    assert "from yolo_tensorflow_tpu." not in got
    assert "from yolo_tensorflow_tpu import" not in got
    assert got.replace("yolo_tensorflow_tpu_torch", "yolo_tensorflow_tpu") \
        == want


@pytest.mark.parametrize("name", JC.MODEL_NAMES)
def test_config_from_cfg_matches(name, tmp_path):
    """config_from_cfg on the cfg that specs_to_cfg writes for every zoo
    model: the same ModelConfig and specs from both packages."""
    from yolo_tensorflow_tpu.io import cfg as JCfg
    from yolo_tensorflow_tpu_torch.io import cfg as TCfg
    path = tmp_path / f"{name}.cfg"
    text = TCfg.specs_to_cfg(TC.get_config(name))
    assert text == JCfg.specs_to_cfg(JC.get_config(name))
    path.write_text(text)
    got_cfg, got = TC.config_from_cfg(str(path), name=name)
    want_cfg, want = JC.config_from_cfg(str(path), name=name)
    assert _fields(got_cfg) == _fields(want_cfg)
    assert len(got) == len(want) > 0
    for i, (p, j) in enumerate(zip(got, want)):
        assert type(p) is getattr(TS, type(j).__name__), i
        assert _fields(p) == _fields(j), i
