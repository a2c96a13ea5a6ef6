"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration, ``benchmark/configs/<config>.json``, and a traffic mix,
``benchmark/traffic/<traffic>.json``, whose ``kind`` picks its driver
(``<kind>_driver.py``: ``serve_driver``); the limits of its correctness
numbers are ``benchmark/limits/<cell>.json`` and each per-layer metric is
read by ``benchmark/metrics/<metric>.py``. Nothing here needs an edit for
a new cell: its files are found by name.

The run draws its weights and inputs from ``--seed``, builds the port,
warms every shape the cell uses (set-up, ``setup_s``), measures for
``--seconds``, then checks what the window produced against the plain
reference. With ``--trace 1`` a torch.profiler window over steady batches
gives the per-layer metrics and the breakdown instead of the end-to-end
ones. The last line of standard output is one JSON object; the numbers
compared and their limits are the last lines of standard error.

Exit codes: 0 with a result; 2 without a usable card; 3 when a JAX
module is loaded at the end; 1 on any other failure.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse                                   # noqa: E402
import importlib.util                             # noqa: E402
import json                                       # noqa: E402
import math                                       # noqa: E402
import os                                         # noqa: E402
import subprocess                                 # noqa: E402
import sys                                        # noqa: E402
from pathlib import Path                          # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in the process that prints a result,
# compared by their whole top-level name
BANNED = ("jax", "jaxlib", "flax", "yolo_tensorflow_tpu")
# build and kernel caches of the program, at fixed paths in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
          "TRITON_CACHE_DIR": ".bench_cache/triton"}


def process_age() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Registry:
    """The benchmark's files, found by the names BENCHMARK.json gives."""

    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.here = here
        self.spec = load_json(root / "BENCHMARK.json")

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        return load_json(self.here / "configs" / f"{name}.json")

    def traffic(self, name):
        return load_json(self.here / "traffic" / f"{name}.json")

    def limits(self, cell):
        return load_json(self.here / "limits" / f"{cell}.json")

    def reader(self, metric):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.here / "metrics" / f"{metric}.py"
        name = "bench_metric_" + "".join(c if c.isalnum() else "_"
                                         for c in metric)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def driver(self, kind):
        """The driver module of a traffic kind: ``<kind>_driver.py``."""
        path = self.here / f"{kind}_driver.py"
        if not path.exists():
            raise KeyError(f"no driver for traffic kind {kind!r}")
        return importlib.import_module(f"{kind}_driver")

    @staticmethod
    def applies(metric, cell, reported=None) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return reported is None or metric.get("moves") in reported

    def end_to_end(self, cell):
        return [m for m in self.spec["end_to_end"]
                if self.applies(m, cell)]

    def per_layer(self, cell):
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if self.applies(m, cell, e2e)]


class Context:
    """What a driver needs for one run."""

    def __init__(self, cell, cfg, traffic, seed, seconds, trace, device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.notes = []
        self.detail = {}        # what calibrate.py prints beside a reading

    @staticmethod
    def clock() -> float:
        return process_age()

    def profile(self, fn):
        """Run fn() under torch.profiler inside the "bench.window" span;
        returns the reduced trace."""
        import torch
        from torch.profiler import ProfilerActivity, profile, \
            record_function

        import trace as T
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(T.WINDOW):
                fn()
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
        return T.read(prof)


class MetricInput:
    """What a per-layer metric's reader reads: the trace, the cell's
    configuration and mix, and the work the traced window completed."""

    def __init__(self, trace, cfg, traffic):
        self.trace, self.cfg, self.traffic = trace, cfg, traffic
        self.images = getattr(trace, "images", 0)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def judge(checks, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, every limit's number present."""
    shown = {k: {"value": checks.get(k), "limit": v}
             for k, v in limits.items()}
    ok = all(isinstance(c["value"], (int, float))
             and math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in shown.values())
    return ok, shown


def run_cell(args, reg: Registry, device):
    """Drive one run; returns the result object."""
    import torch
    cell = reg.cell(args.workload)
    cfg = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    limits = reg.limits(cell["name"])
    ctx = Context(cell["name"], cfg, traffic, args.seed, args.seconds,
                  bool(args.trace), device)
    rec = reg.driver(traffic["kind"]).run(ctx)
    metrics = {}
    if args.trace:
        mi = MetricInput(rec["trace"], cfg, traffic)
        for m in reg.per_layer(cell["name"]):
            v = reg.reader(m["name"])(mi)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(rec["e2e"], setup_s=rec["setup_s"])
        for m in reg.end_to_end(cell["name"]):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    correct, shown = judge(rec["checks"], limits)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": kind, "count": cell["chips"],
                      "memory_peak_bytes": rec["memory_peak_bytes"]}}
    if args.trace:
        tr = rec["trace"]
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = shown
    return out, rec.get("notes", [])


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    reg = Registry()
    cell = reg.cell(args.workload)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    if str(ROOT) not in sys.path:
        sys.path.append(str(ROOT))
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out, notes = run_cell(args, reg, torch.device("cuda", 0))
    found = banned_modules()
    if found:
        print(f"benchmark: modules loaded that the run may not load: "
              f"{found}", file=sys.stderr)
        return 3
    for line in notes + [f"card: {card_line()}"]:
        print(line, file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
