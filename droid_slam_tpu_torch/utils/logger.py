"""Training logger: running-average metrics and, where the tensorboard
package is installed, TensorBoard scalars.

Counterpart of the JAX package's ``utils/logger.py`` (reference
droid_slam/logger.py): means over SUM_FREQ pushes, printed as a status line.
"""

from __future__ import annotations

from typing import Dict

SUM_FREQ = 100


class Logger:
    def __init__(self, name: str, total_steps: int = 0, logdir: str = "runs"):
        self.name = name
        self.total_steps = total_steps
        self.running: Dict[str, float] = {}
        # pushes since the last flush: a resumed step counter starts
        # mid-window, so dividing by SUM_FREQ would be wrong
        self._pushes = 0
        self.logdir = logdir
        self._writer = None
        self._tried = False

    @property
    def writer(self):
        """The TensorBoard writer, made at the first write (importing
        tensorboard takes seconds); None where the package is missing."""
        if not self._tried:
            self._tried = True
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(f"{self.logdir}/{self.name}")
            except ImportError:
                pass
        return self._writer

    def _print_status(self):
        keys = sorted(self.running)
        n = max(self._pushes, 1)
        line = f"[{self.name} {self.total_steps:>6d}] " + " ".join(
            f"{k}={self.running[k] / n:.4f}" for k in keys
        )
        print(line, flush=True)

    def push(self, metrics: Dict[str, float]):
        self.total_steps += 1
        self._pushes += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)

        if self.total_steps % SUM_FREQ == 0:
            if self.writer is not None:
                for k in self.running:
                    self.writer.add_scalar(k, self.running[k] / max(self._pushes, 1), self.total_steps)
            self._print_status()
            self.running = {}
            self._pushes = 0
