"""Build the JAX package's native library once, before the xdist workers start.

``tests/test_native_loader.py`` decides at collection whether to skip its
tests (``native_loader.available()``), and that first call runs ``make -C
native`` when ``native/libdroid_native.so`` is missing or older than its
source. Under ``-p xdist -n N`` every worker collects every file, so N
workers would build at once, and ``make`` writes the library in place: a
worker that loads the half-written file remembers the failure for its whole
process, and the module's tests skip (or ``tests/test_torch_native_loader.py``
fails) on some runs and not on others.

So the controller runs the loader's build here first (``make -C native``,
output captured, 120 s, a failure tolerated); every worker then finds the
library built and only loads it. Where it cannot build (no ``make``, no
decoder headers), every worker skips the same tests on every run. This file
imports neither ``jax`` nor ``droid_slam_tpu``.
"""

import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent / "native"


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    try:
        subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        pass  # each process's loader then tries again and reports the library unavailable
