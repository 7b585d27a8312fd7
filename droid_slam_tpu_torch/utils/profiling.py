"""Device traces and wall-clock stage timers (the JAX package's
``utils/profiling.py``):

    with device_trace("/tmp/trace"):          # torch.profiler, a Chrome trace
        droid.track(...)

    timers = StageTimers()
    with timers.time("step", sync=True):      # fenced by torch.cuda.synchronize
        ...
    print(timers.report())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Trace the body with ``torch.profiler`` (host and, where CUDA is
    available, device activity) and write a Chrome trace,
    ``logdir/trace.json`` (open it in Perfetto or chrome://tracing). The
    device is synchronised on entry and on exit, so the trace holds the
    body's device work and nothing queued before it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _synchronize()
    with profile(activities=activities) as prof:
        yield
        _synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimers:
    """Named wall-clock accumulators for pipeline stages."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, sync: bool = False) -> Iterator[None]:
        """Time a stage; with ``sync`` the stage ends with
        ``torch.cuda.synchronize()``, so its device work is inside."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _synchronize()
            self.total[name] += time.perf_counter() - start
            self.count[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.total, key=lambda k: -self.total[k]):
            t, n = self.total[name], self.count[name]
            lines.append(f"{name:24s} {t:8.3f}s total  {1e3 * t / max(n, 1):8.2f} ms/call  x{n}")
        return "\n".join(lines)
