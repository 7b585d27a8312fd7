"""Share of the tracked frames' device time in DroidNet's convolutions
(models/, on cuDNN), matched by kernel name. Moves track_fps."""

from slam_bench.harness import CONV_KERNEL, share


def read(trace):
    if trace.kind != "track" or not trace.stretch.records:
        return None
    return share(trace.stretch.device_s(CONV_KERNEL.search), trace.stretch.device_s())
