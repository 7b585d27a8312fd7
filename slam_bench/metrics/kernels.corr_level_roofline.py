"""Share of its roofline of the fused lookup (ops/corr.py, csrc/corr_level.cu)
over the traced frames: the needed bytes and operations of every lookup the
algorithm made (from the counting pass) against the time of the kernels
named corr_level. Moves track_fps."""

from slam_bench.harness import roofline


def read(trace):
    if trace.kind != "track":
        return None
    return roofline(trace, "corr_level", ("corr_level",))
