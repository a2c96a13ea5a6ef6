"""The check fails a broken timed path. Each case skips the harness's look
for a card and drives the rest of a run (``run.run_cell``) of a cell on
the CPU, its configuration at input 64 and its mix cut to a few frames,
with the timed path broken underneath, and sees ``correct`` come out
false against the cell's own limits, where the same run unbroken comes out
true: for serving, every answer altered where it is produced and half of
the batch left out. (One card: no exchange between chips to leave out.)"""

import argparse

import pytest
import torch

import run as R

SERVE = ("yolov3-416.serve-int8.b256", "yolov2-416.serve-int8.b256")
torch.set_num_threads(2)


class Small(R.Registry):
    """The benchmark's files with each configuration at input 64 and each
    mix cut to a few frames."""

    def config(self, name):
        cfg = super().config(name)
        cfg["input_size"] = 64
        return cfg

    def traffic(self, name):
        mix = super().traffic(name)
        mix.update(batch=4, pool_batches=2, warmup_batches=1,
                   trace_batches=1, check_images=4, check_block=4)
        return mix


def correct(cell):
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 17, seconds=1.0,
                              trace=0)
    out, _ = R.run_cell(args, Small(), torch.device("cpu"))
    return out["correct"], out["checks"]


def altered(dets):
    """Every answer altered where it is produced: its boxes moved by a
    quarter of the frame."""
    return dets._replace(boxes=dets.boxes + 0.25 * (dets.boxes.amax()
                                                     + 1.0))


def half_left_out(dets):
    """The second half of the batch answered with nothing."""
    keep = torch.arange(dets.num.shape[0]) < dets.num.shape[0] // 2
    return dets._replace(valid=dets.valid & keep[:, None],
                         num=torch.where(keep, dets.num, 0))


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", [altered, half_left_out])
def test_serving_fault_is_not_correct(cell, fault, monkeypatch):
    ok, shown = correct(cell)
    assert ok, shown
    from yolo_tensorflow_tpu_torch.post import nms as NMS
    pack = NMS.pack_detections
    monkeypatch.setattr(NMS, "pack_detections",
                        lambda d: pack(fault(d)))
    ok, shown = correct(cell)
    assert not ok, shown

