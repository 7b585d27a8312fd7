"""Share of the traced tracking stretch in which the card ran nothing: 1 less
the union of the records' intervals over the stretch. Moves track_fps."""

from slam_bench.harness import share


def read(trace):
    if trace.kind != "track" or not trace.stretch.records:
        return None
    s = trace.stretch
    return share(s.window_s - s.busy_s(), s.window_s)
