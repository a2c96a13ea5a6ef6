"""The control comes out not correct: for each serving cell, the plain
reference computed in the precision below the configuration's (int4 for the
int8 cells), put in the program's place, is held to the reference as a run
holds the program and fails the cell's limits, on three seeds at the cell's
own size. Needs a card:

    python3 -m pytest benchmark/tests/test_bench_control.py -q
"""

import pytest

import run as R

REG = R.Registry()
SEEDS = (9101, 2 ** 31 + 9102, 9103)


@pytest.mark.card
@pytest.mark.parametrize("cell", [
    w["name"] for w in REG.spec["workloads"]
    if REG.traffic(w["traffic"])["kind"] == "serve"])
def test_control_is_not_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch.cuda.is_available() is "
                    "false")
    w = REG.cell(cell)
    cfg, mix = REG.config(w["config"]), REG.traffic(w["traffic"])
    driver = REG.driver(mix["kind"])
    for seed in SEEDS:
        ctx = R.Context(cell, cfg, mix, seed, 1.0, False,
                        torch.device("cuda", 0))
        ok, shown = R.judge(driver.control(ctx), REG.limits(cell))
        assert not ok, (seed, shown)
