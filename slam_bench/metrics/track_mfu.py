"""The whole tracked stretch's share of the card's peak: DroidNet's
convolutions and the correlation's dots that the traced frames needed, each
at its type's peak (bf16 989, f32 67 TFLOP/s), over the stretch's time.
Moves track_fps."""

from slam_bench.harness import mfu


def read(trace):
    return mfu(trace) if trace.kind == "track" else None
