"""Occupied (depth frame, pose) cells of the dense-window GN step's Schur
complement per update iteration (ops/ba.py::window_schur; a work count,
of the window's Ka x Pw cells), counted on the device by the step itself
in its first GN step: the mean over every update iteration of the traced
session's replays before the profiled stretch. Moves track_fps."""

import statistics

from slam_bench.recorder import replay_rows


def read(trace):
    _, rows = replay_rows(trace)
    cells = [v for r in rows for name, v in r.items() if name.startswith("it") and name.endswith(".cells")]
    return statistics.mean(cells) if cells else None
