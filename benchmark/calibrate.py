"""The readings the limits of ``correct`` are set from, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        --seconds 2 --control-seeds 101 102 103

In one process (set-up is paid once for the kernels' build): for each of
``--seeds`` one run of the cell as ``run.py`` makes it, with a window of
``--seconds``, and its compared numbers (the lower readings); then for
each of ``--control-seeds`` the control's numbers: the reference at the
mix's ``control`` precision, the step below the configuration's, in the
program's place (the upper readings). One JSON line per reading on
standard output; with ``--detail <file>`` each reading's detail (the parts
of every checked frame) is appended to that file as well. The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as R


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--detail", default=None)
    args = ap.parse_args(argv)
    reg = R.Registry()
    cell = reg.cell(args.workload)
    if str(R.ROOT) not in sys.path:
        sys.path.append(str(R.ROOT))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    driver = reg.driver(traffic["kind"])

    def emit(side, seed, t, ctx, checks, **more):
        line = {"side": side, "seed": seed, "checks": checks, **more,
                "notes": ctx.notes, "s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if args.detail:
            with open(args.detail, "a") as f:
                f.write(json.dumps(dict(line, cell=cell["name"],
                                        detail=ctx.detail)) + "\n")

    def context(seed):
        return R.Context(cell["name"], cfg, traffic, seed, args.seconds,
                         False, dev)

    for seed in args.seeds:
        t, ctx = time.perf_counter(), context(seed)
        rec = driver.run(ctx)
        emit("program", seed, t, ctx, rec["checks"], e2e=rec["e2e"],
             setup_s=rec["setup_s"])
    for seed in args.control_seeds:
        t, ctx = time.perf_counter(), context(seed)
        emit("control", seed, t, ctx, driver.control(ctx),
             control=traffic["control"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
