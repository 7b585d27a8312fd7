"""CPU tests of the benchmark. They import no JAX: the benchmark may not.

Run from the repository's root: ``python -m pytest slam_bench/tests -q``.
A card is never looked for while a module is imported; the tests here run
on the CPU at tiny sizes."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(name: str, frames: int = 16, size=(48, 64), buffer: int = 40):
    """The cell ``name`` cut to a size the CPU runs in seconds."""
    from slam_bench import harness

    cell = harness.Cell.load(name)
    cell.workload["generator_args"]["frames"] = frames
    cell.config["droid_config"].update(image_size=list(size), buffer=buffer)
    args = cell.workload.setdefault("driver_args", {})
    args.update(warm_frames=min(frames, 14), trace_frames=4)
    if "check_frames" in args:
        args["check_frames"] = frames
    return cell


@pytest.fixture
def torch_cpu():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield torch
    finally:
        torch.set_num_threads(threads)
