"""Host milliseconds of one Droid.track call (the port's runtime/droid.py,
host side): the median of the harness's host-clock spans around each
track call of the window. Moves track_fps."""

import statistics


def read(trace):
    if trace.kind != "track" or not trace.host_ms:
        return None
    return statistics.median(trace.host_ms)
