"""yolo_tensorflow_tpu_torch/tools/sweep_train.py and bench_train.py against
tools/sweep_train.py and tools/bench_train.py, on the CPU.

- Both sweeps' ``main`` run with the same stub ``measure_train``
  (monkeypatched into each module): the same calls in the same order (the
  port's also name the device), the same printed lines, the same knee and
  results in the last JSON line.
- The port's batch draw (``bench_train.batch_inputs``) equals the
  reference's, whose statements (tools/bench_train.py's ``rng = ...``
  through the truths' classes) are executed from its source.
- The port's ``measure_train`` runs on the CPU (yolov3-tiny at 64, B=2, 2
  steps, 1 repeat) and returns the reference's keys (read from its source's
  returned dict) with a finite loss.
"""

import ast
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from tools import sweep_train as JSW
from yolo_tensorflow_tpu_torch.tools import bench_train as TB
from yolo_tensorflow_tpu_torch.tools import sweep_train as TSW

BENCH_SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "tools"
                / "bench_train.py")


def _stub(calls):
    """A measure_train that records its keywords and makes the knee 96."""
    def measure_train(**kw):
        calls.append(kw)
        b, steps = kw["batch"], kw["steps"]
        ips = 1000.0 - abs(b - 96) + steps + len(kw.get("bn_stats", ""))
        return {"train_images_per_sec": ips,
                "step_ms": round(b / ips * 1e3, 2),
                "compile_s": 1.5, "batch": b, "steps_per_dispatch": steps}
    return measure_train


@pytest.mark.parametrize("env", [{}, {"SWEEP_BATCHES": "32,160,96",
                                      "SWEEP_STEPS": "2"}])
def test_sweep_calls_lines_and_knee(monkeypatch, capsys, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref_calls, port_calls = [], []
    monkeypatch.setattr(JSW, "measure_train", _stub(ref_calls))
    JSW.main()
    ref_out = capsys.readouterr().out.strip().split("\n")
    monkeypatch.setattr(TSW, "measure_train", _stub(port_calls))
    TSW.main(device="cpu")
    port_out = capsys.readouterr().out.strip().split("\n")
    assert all(c.pop("device") == "cpu" for c in port_calls)
    assert port_calls == ref_calls and len(ref_calls) >= 9
    assert port_out[:-1] == ref_out[:-1]
    ref_json, port_json = json.loads(ref_out[-1]), json.loads(port_out[-1])
    assert port_json["device"] == "cpu"
    assert port_json["knee_batch"] == ref_json["knee_batch"] == 96
    assert port_json["results"] == ref_json["results"]


def _reference_statements(first, last):
    """tools/bench_train.py's measure_train statements from the one that
    assigns ``first`` to the one whose source starts with ``last``."""
    fn = next(n for n in ast.walk(ast.parse(BENCH_SOURCE.read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == "measure_train")
    src = BENCH_SOURCE.read_text()
    body = [ast.get_source_segment(src, st) for st in fn.body]
    i = next(k for k, s in enumerate(body) if s.startswith(f"{first} ="))
    j = next(k for k, s in enumerate(body) if s.startswith(last))
    return fn, fn.body[i:j + 1]


@pytest.mark.parametrize("steps,batch,size,classes", [(4, 2, 32, 80),
                                                      (2, 3, 16, 20)])
def test_batch_draw_is_the_reference(steps, batch, size, classes):
    _, stmts = _reference_statements("rng", "truths[..., :8, 4]")
    ns = {"np": np, "steps": steps, "batch": batch, "size": size,
          "cfg": types.SimpleNamespace(num_classes=classes)}
    exec(compile(ast.Module(body=stmts, type_ignores=[]), str(BENCH_SOURCE),
                 "exec"), ns)
    images, truths = TB.batch_inputs(classes, steps, batch, size)
    assert images.dtype == ns["images"].dtype == np.uint8
    np.testing.assert_array_equal(images, ns["images"])
    assert truths.dtype == ns["truths"].dtype
    np.testing.assert_array_equal(truths, ns["truths"])


def test_measure_train_on_the_cpu():
    fn, _ = _reference_statements("rng", "truths[..., :8, 4]")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    keys = {k.value for k in ret.value.keys}
    r = TB.measure_train("yolov3-tiny", 64, batch=2, steps=2, repeats=1,
                         compute_dtype="bfloat16", device="cpu")
    assert set(r) == keys
    assert r["loss_finite"] and r["train_images_per_sec"] > 0
    assert (r["batch"], r["steps_per_dispatch"], r["model"], r["size"],
            r["compute_dtype"]) == (2, 2, "yolov3-tiny", 64, "bfloat16")
    assert len(r["spread_img_per_sec"]) == 1


@pytest.mark.parametrize("dtype,tf32,tag", [(None, False, "float32-exact"),
                                            ("float32", True, "float32")])
def test_measure_train_float32_modes(monkeypatch, dtype, tf32, tag):
    """None trains float32 with TF32 off, "float32" builds its step with
    ``tf32`` on (the card's default precision; the CPU has no TF32)."""
    from yolo_tensorflow_tpu_torch.train import loop
    built, real = [], loop.make_multi_step

    def make_multi_step(*a, **kw):
        built.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(loop, "make_multi_step", make_multi_step)
    r = TB.measure_train("yolov3-tiny", 64, batch=2, steps=2, repeats=1,
                         compute_dtype=dtype, device="cpu")
    assert [(kw["compute_dtype"], kw["tf32"]) for kw in built] == [
        (None if dtype is None else torch.float32, tf32)]
    assert r["loss_finite"] and r["compute_dtype"] == tag
