"""The controls on the card: the reference put in the program's place and
computed in the precision next below the configuration's comes out not
correct under the cell's limits, while the program on the same steps comes
out correct. TF32 for the planner's matrix products, bfloat16 for the
physics. At a size a test run can hold: the cell's own configuration and
horizon, 512 samples a level, one checked control step, three seeds.

    python3 -m pytest port_bench/tests/test_bench_control.py -m card

``port_bench/control.py`` reads the same at the cell's own size."""

import dataclasses
import time

import pytest
import torch

from port_bench.harness.cells import find_cell
from port_bench.harness.check import verdict
from port_bench.harness.loop import run_cell

CELL = "allegro_reorient.sync_n2048"


@pytest.mark.card
@pytest.mark.parametrize("control", ["tf32", "bf16"])
def test_control_is_not_correct(control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the controls are read on the card")
    from port_bench.control import control_readings

    cell = find_cell(CELL)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, planner={"Nsample": 512}, check_steps=1, check_within=1))
    for seed in (7, 8, 9):
        run = run_cell(cell, seed, 0.0, False, time.perf_counter(), device="cuda")
        assert run.correct, run.limits_rows
        ok, rows = verdict(control_readings(run, seed, torch.device("cuda"), control), cell.limits)
        assert not ok, rows
