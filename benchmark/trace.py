"""The profiler's window, reduced: device busy time, copies, kernels by
name and the idle gaps by what the host was doing.

The union of kernel, memcpy and memset intervals over the wall is a frozen
copy of the port's ``utils/profiling.device_busy``; everything else reads
the same Chrome trace that ``torch.profiler`` exports. Times are seconds.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "cuda_driver")
WINDOW = "bench.window"


def union(spans):
    """Sorted disjoint union of (start, end) spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def total(spans) -> float:
    return sum(b - a for a, b in spans)


def subtract(spans, cover):
    """The parts of disjoint sorted ``spans`` that disjoint sorted ``cover``
    leaves uncovered."""
    out, j = [], 0
    for a, b in spans:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k, cur = j, a
        while k < len(cover) and cover[k][0] < b:
            if cover[k][0] > cur:
                out.append((cur, cover[k][0]))
            cur = max(cur, cover[k][1])
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameter list."""
    for anon in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(anon, "")
    name = name[5:] if name.startswith("void ") else name
    for sep in ("<", "("):
        if sep in name[1:]:
            name = name[:name.index(sep, 1)]
    return name[:96].strip()


class Trace:
    """One profiled window. ``kernels``, ``copies`` and ``sets`` are
    [(start, end, name)] of the device activity that starts inside it."""

    def __init__(self, events):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError(f"the trace has no {WINDOW!r} span")
        w = win[0]
        self.t0 = w["ts"] * 1e-6
        self.t1 = (w["ts"] + w["dur"]) * 1e-6
        self.window_s = self.t1 - self.t0
        dev = {c: [] for c in DEVICE_CATS}
        self.host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = e["ts"] * 1e-6
            b = a + e["dur"] * 1e-6
            cat = e.get("cat")
            if cat in dev:
                if self.t0 <= a < self.t1:
                    dev[cat].append((a, min(b, self.t1), e.get("name", "")))
            elif cat in HOST_CATS and b >= self.t0 and a <= self.t1:
                self.host.append((a, b, e.get("name", ""), cat))
        self.kernels = dev["kernel"]
        self.copies = dev["gpu_memcpy"]
        self.sets = dev["gpu_memset"]
        self.busy = union([(a, b) for a, b, _ in
                           self.kernels + self.copies + self.sets])
        self.busy_s = total(self.busy)
        self.host.sort()

    def kernel_s(self, match) -> float:
        """Summed device seconds of the kernels whose name ``match``es."""
        return sum(b - a for a, b, n in self.kernels if match(n))

    def copy_only_s(self) -> float:
        """Seconds in which a copy ran and no kernel did."""
        return total(subtract(union([(a, b) for a, b, _ in self.copies]),
                              union([(a, b) for a, b, _ in self.kernels])))

    def device_ops(self, n: int = 10):
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        by = {}
        for a, b, name in self.kernels + self.copies + self.sets:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def host_at(self, t: float) -> str:
        """What the host was doing at time t: the benchmark's own span
        around it and the innermost operation or runtime call."""
        starts = [h[0] for h in self.host]
        i = bisect.bisect_right(starts, t)
        span, inner = "", ""
        for a, b, name, cat in reversed(self.host[max(0, i - 4000):i]):
            if b < t:
                continue
            if not inner and cat != "user_annotation":
                inner = name
            if cat == "user_annotation" and name.startswith("bench.") \
                    and name != WINDOW and not span:
                span = name
            if span and inner:
                break
        return f"{span or 'bench'}/{inner or 'python'}"

    def idle_gaps(self, n: int = 10):
        """[[label, seconds]] of the device's idle time inside the window,
        summed by what the host was doing when each gap began."""
        gaps = subtract([(self.t0, self.t1)], self.busy)
        by = {}
        for a, b in gaps:
            key = self.host_at(a)
            by[key] = by.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


def read(prof) -> Trace:
    """The Trace of a stopped ``torch.profiler.profile``, through its
    exported Chrome trace (written under the run's temporary directory)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events)
