"""Device milliseconds per tracked frame of the update's lookups (ops/corr.py,
csrc/corr_level.cu), from the step's own stamps: the sum over the frame's
update iterations of each one's start to after its lookups (the
recorder's ``it{k}.corr`` columns, written in stereo only), which holds
the edges' reprojection, the gather of each edge's two feature maps (the
right image's for a stereo self edge) and the 4-level lookup; the median
over the traced session's replays before the profiled stretch. Moves
track_fps."""

import statistics

from slam_bench.recorder import replay_rows


def read(trace):
    _, rows = replay_rows(trace)
    per_frame = []
    for r in rows:
        its = [name[:-len(".corr")] for name in r if name.startswith("it") and name.endswith(".corr")]
        if its:
            per_frame.append(sum(r[f"{it}.corr"] - r[f"{it}.start"] for it in its))
    return 1e-6 * statistics.median(per_frame) if per_frame else None
