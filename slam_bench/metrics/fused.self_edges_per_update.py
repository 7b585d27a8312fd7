"""Valid stereo self edges (i, i) per update iteration of the fused step's
edge store (runtime/fused.py; a work count), counted on the device by the
step itself (the recorder's ``it{k}.self`` columns, written in stereo
only): the mean over every update iteration of the traced session's
replays before the profiled stretch. Moves track_fps."""

import statistics

from slam_bench.recorder import replay_rows


def read(trace):
    _, rows = replay_rows(trace)
    counts = [v for r in rows for name, v in r.items() if name.startswith("it") and name.endswith(".self")]
    return statistics.mean(counts) if counts else None
