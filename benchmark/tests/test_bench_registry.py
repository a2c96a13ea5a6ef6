"""The harness is driven by data: a configuration, a traffic mix, a
per-layer metric and a cell added as files alone (in a copy of the
benchmark) are found by name with no edit, and the benchmark's test files
do not share a name with the repository's own tests."""

import json
import shutil
from pathlib import Path

import run as R

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_added_files_resolve(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "yolov2-416.json").read_text())
    cfg["name"] = "dummy-cfg"
    (bench / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "serve_int8_b256.json")
                     .read_text())
    mix["batch"] = 8
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "dummy.metric.py").write_text(
        "def read(m):\n    return 42.0 + m.images\n")
    (bench / "limits" / "dummy-cfg.dummy_mix.json").write_text(
        json.dumps({"frame_gap": 0.5}))
    spec["workloads"].append({"name": "dummy-cfg.dummy_mix",
                              "config": "dummy-cfg", "traffic": "dummy_mix",
                              "chips": 1, "why": "added as files"})
    spec["per_layer"].append({"name": "dummy.metric", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "the device", "moves": "serve_img_s"})
    spec["end_to_end"][0]["workloads"].append("dummy-cfg.dummy_mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    reg = R.Registry(root=tmp_path, here=bench)
    cell = reg.cell("dummy-cfg.dummy_mix")
    assert reg.config(cell["config"])["name"] == "dummy-cfg"
    assert reg.traffic(cell["traffic"])["batch"] == 8
    assert reg.limits(cell["name"]) == {"frame_gap": 0.5}
    assert "dummy.metric" in [m["name"] for m in
                              reg.per_layer("dummy-cfg.dummy_mix")]
    # a metric without "workloads" goes to every cell that reports what it
    # moves, and to no other (a cell BENCHMARK.json does not list reports
    # setup_s alone)
    assert "dummy.metric" not in [m["name"] for m in reg.per_layer(
        "unlisted-cell")]

    class Probe:
        images = 1
    assert reg.reader("dummy.metric")(Probe()) == 43.0
    assert reg.driver("serve").__name__ == "serve_driver"


def test_every_cell_resolves():
    reg = R.Registry()
    for w in reg.spec["workloads"]:
        cfg = reg.config(w["config"])
        assert cfg["name"] == w["config"]
        assert reg.traffic(w["traffic"])["kind"] == "serve"
        assert reg.limits(w["name"])
        assert [m for m in reg.end_to_end(w["name"])
                if m["name"] != "setup_s"]
        assert reg.per_layer(w["name"])


def test_test_names_are_the_benchmarks_own():
    ours = {p.name for p in (HERE / "tests").glob("test_*.py")}
    theirs = {p.name for p in (ROOT / "tests").glob("*.py")}
    assert not ours & theirs
