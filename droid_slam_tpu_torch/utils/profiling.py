"""Wall-clock stage timers (the JAX package's ``utils/profiling.py::StageTimers``):

    timers = StageTimers()
    with timers.time("step", sync=True):      # fenced by torch.cuda.synchronize
        ...
    print(timers.report())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
