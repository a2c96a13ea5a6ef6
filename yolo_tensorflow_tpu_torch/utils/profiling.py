"""Profiling hooks of the port: the TPU package's utils/profiling.py with
``torch.profiler`` in place of jax.profiler.

The reference's tracing story is wall-clock prints around sess.run
(YOLO_V1_Inference.py:379-383) and darknet's per-batch second counts
(examples/detector.c:110). Here: a stage timer with the same printed
flavor, and a torch.profiler capture of the host and the card written as
a Chrome trace (the command line's ``--trace``). XLA's HLO dump and
``block_and_time`` (a jax.block_until_ready timing) have no counterpart."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict


class StageTimer:
    """Accumulating wall-clock stage timer; ``report()`` prints
    darknet-style 'stage: seconds' lines."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {total/n*1e3:.2f}ms "
                         f"avg over {n}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where there is one,
    the card, written to ``log_dir/trace.json`` (chrome://tracing or
    Perfetto read it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))



def cuda_ms(fn, iters=20, warmup=3, ahead_cycles=0):
    """Mean device time of fn() in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls. ``ahead_cycles``: the card
    first spins that many clock cycles, so that the host has queued every
    call before the first one runs. Without it a kernel that is shorter
    than its wrapper's host time measures the host."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if ahead_cycles:
        torch.cuda._sleep(ahead_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
