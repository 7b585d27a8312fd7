"""The control at a size a test run holds: the reference put in the
program's place with the update operator on float8 e4m3 (``check.precision``)
reads well above the program's bf16 steps, and for the tracking cell it
fails the cell's own limits. The readings the limits were set from are
the card's, at the cells' own sizes (``slam_bench/control.py``, PERF.md)."""

import torch

from slam_bench import control, harness, run
from slam_bench.tests.conftest import tiny


def test_tracking_control_fails_the_limits(torch_cpu):
    cell = tiny("tum-track-allkf", frames=20)
    cell.workload["driver_args"]["check_steps"] = 6
    got = {v: dict(n) for v, n in control.readings(run.make_context(cell, 77, torch_cpu, torch.device("cpu"))).items()}
    # the numbers that compare a side with the reference (the replay's and
    # the sessions' gaps compare the program with itself)
    both = [(n, lim) for n, lim in cell.workload["check"].items() if n in got["program"] and n in got["fp8"]]
    ok_program, _ = harness.check_lines([(n, got["program"][n], lim) for n, lim in both])
    ok_control, _ = harness.check_lines([(n, got["fp8"][n], lim) for n, lim in both])
    assert ok_program and not ok_control, got
    assert got["fp8"]["step_gap_med"] >= 3 * got["program"]["step_gap_med"]
    # a step that returns its state unchanged fails the initialisation's number
    assert got["program"]["init_unmoved"] == 0 and got["unchanged"]["init_unmoved"] == 1, got
