"""Device milliseconds per tracked frame (runtime/fused.py and
runtime/graph.py, the captured step): the traced records' summed time over
the traced frames. Moves track_fps."""


def read(trace):
    if trace.kind != "track" or not trace.stretch.records or trace.stretch.units == 0:
        return None
    return 1e3 * trace.stretch.device_s() / trace.stretch.units
