"""What every cell shares: finding a cell's files by name, the program's
configuration, the profiler's reading of a traced stretch, the import guard
and the result line.

A cell is ``workloads/<name>.json``; it names a configuration
(``configs/<name>.json``), a traffic generator (``generators/<name>.py``)
and a window driver (``drivers/<name>.py``). A per-layer metric is
``metrics/<name>.py``. All are found by the names in ``BENCHMARK.json`` and
in the cell's file, so a later cell, configuration or metric is new files
and new entries only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
# top-level module names no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "droid_slam_tpu")
STRETCH_RANGE = "slam_bench.stretch"  # the profiler range around a traced stretch


class BenchError(RuntimeError):
    """A cell, configuration or environment the benchmark refuses."""


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise BenchError(f"not a name: {name!r}")
    return name


def load_json(kind: str, name: str) -> Dict[str, Any]:
    path = BENCH_DIR / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)} is missing)")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by path
    (a metric's name may hold dots)."""
    path = BENCH_DIR / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)} is missing)")
    spec = importlib.util.spec_from_file_location(f"slam_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> Dict[str, Any]:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(spec: Dict[str, Any], workload: str, section: str) -> List[Dict[str, Any]]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those that list it, and those that list no cells."""
    return [m for m in spec[section] if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class Cell:
    """One cell as its files give it."""

    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]

    @staticmethod
    def load(name: str) -> "Cell":
        w = load_json("workloads", name)
        return Cell(name=name, workload=w, config=load_json("configs", w["config"]))

    def droid_fields(self) -> Dict[str, Any]:
        """The program's configuration fields: the preset's, then what the
        traffic forces (``config_overrides`` of the cell)."""
        fields = dict(self.config["droid_config"])
        fields.update(self.workload.get("config_overrides", {}))
        fields["image_size"] = tuple(fields["image_size"])
        return fields

    def weights_path(self) -> Path:
        """The configuration's weights file, held to its recorded digest so
        that a changed file cannot move the yardstick unseen."""
        path = ROOT / self.config["weights"]
        if not path.is_file():
            raise BenchError(f"weights file {self.config['weights']} is missing")
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        if digest != self.config["weights_sha256"]:
            raise BenchError(f"weights file {self.config['weights']} has digest {digest}, "
                             f"not the configuration's {self.config['weights_sha256']}")
        return path


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark may not load (``droid_slam_tpu_torch`` is not
    ``droid_slam_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN_MODULES})


def device_info(torch) -> Dict[str, Any]:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    info = {"kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["nvidia_smi"] = out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        info["nvidia_smi"] = f"not read ({e})"
    return info


# ---------------------------------------------------------------------------
# a traced stretch
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Stretch:
    """The device records of one traced stretch: (name, start ns, end ns)
    of every kernel, memset and copy the card ran inside the stretch's
    profiler range, the range's own bounds, and the units of work (frames)
    it holds."""

    records: List[Tuple[str, int, int]]
    start_ns: int
    end_ns: int
    units: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some record ran: the union of their intervals,
        clipped to the range."""
        spans = sorted((max(s, self.start_ns), min(e, self.end_ns)) for _, s, e in self.records)
        busy, cur_s, cur_e = 0, None, None
        for s, e in spans:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9

    def device_s(self, match=None) -> float:
        """Summed seconds of the records (``match(name)`` picks some)."""
        return sum(e - s for n, s, e in self.records if match is None or match(n)) / 1e9

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.records:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest stretches with no record running, named by the
        record that ended before each."""
        spans = sorted((s, e, n) for n, s, e in self.records)
        gaps, last_end, last_name = [], self.start_ns, "stretch start"
        for s, e, n in spans:
            if s > last_end:
                gaps.append((f"after {last_name}", (s - last_end) / 1e9))
            if e > last_end:
                last_end, last_name = e, n
        if self.end_ns > last_end:
            gaps.append((f"after {last_name}", (self.end_ns - last_end) / 1e9))
        return sorted(gaps, key=lambda g: -g[1])[:top]


def profile_stretch(torch, fn, units: int) -> Stretch:
    """Run ``fn`` once under torch.profiler (device activity only), inside
    the range STRETCH_RANGE that ends after a synchronize, and keep the
    device records in memory: nothing is written to disk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH_RANGE):
            fn()
            torch.cuda.synchronize()
    start = end = None
    records = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() == STRETCH_RANGE:
                start, end = e.start_ns(), e.end_ns()
        elif not e.is_user_annotation():
            records.append((e.name(), e.start_ns(), e.end_ns()))
    if start is None:
        raise BenchError("the profiler kept no record of the stretch's range")
    records = [r for r in records if r[2] > start and r[1] < end]
    return Stretch(records=records, start_ns=start, end_ns=end, units=units)


@dataclasses.dataclass
class Trace:
    """What the per-layer metrics read: the traced stretch, the host spans
    and counters of the run, and the work the algorithm did over the
    stretch (from the counting pass)."""

    kind: str  # the window driver's kind of unit: "track" (frames)
    stretch: Stretch
    host_ms: List[float] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: Dict[str, Any] = dataclasses.field(default_factory=dict)


def free_device(ctx) -> None:
    """Drop what the collector can, and hand the allocator's cache back."""
    import gc

    gc.collect()
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def read_metrics(trace: Trace, metrics: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric's reader over the trace; a reader that finds
    nothing to read returns None, and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# the check's numbers
# ---------------------------------------------------------------------------


def p95(values) -> float:
    """The 95th percentile of ``values`` (numpy's linear interpolation)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), 95))


def check_lines(numbers: List[Tuple[str, float, float]]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(all numbers within their limits, {name: {value, limit}})."""
    table = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    ok = bool(numbers) and all(v == v and v <= lim for _, v, lim in numbers)
    return ok, table


# DroidNet's convolutions on the card, by kernel name: cuDNN's direct and
# implicit-GEMM kernels, its FFT convolutions (the transforms and their
# complex products) and the layout transforms it runs around them. No
# cuBLAS kernel of the BA carries any of these names.
CONV_KERNEL = re.compile(r"conv|fprop|dgrad|wgrad|implicit|winograd|fft|cf32|cudnn|nchwToNhwc|nhwcToNchw",
                         re.IGNORECASE)


def share(part: float, whole: float) -> Optional[float]:
    """part / whole in percent, or None where there is nothing to divide."""
    return 100.0 * part / whole if whole > 0 else None


def roofline(trace: Trace, work_key: str, names) -> Optional[float]:
    """The share of its roofline of the kernels whose name holds one of
    ``names``: the least time the card needs for the work counted under
    ``work_key`` (the larger of the bytes over the memory's rate and the
    operations over the peak of their type) over those kernels' traced time."""
    from slam_bench import costs

    work = trace.work.get(work_key)
    t = trace.stretch.device_s(lambda n: any(k in n for k in names))
    if not work or t <= 0:
        return None
    t_bytes = work["bytes"] / costs.MEM_BYTES_PER_S
    t_ops = costs.peak_seconds(work["ops"])
    return share(max(t_bytes, t_ops), t)


def mfu(trace: Trace) -> Optional[float]:
    """The needed operations of the stretch (DroidNet's convolutions and the
    correlation's dots, each at its type's peak) over the stretch's time."""
    from slam_bench import costs

    flops = trace.work.get("flops")
    if not flops or not trace.stretch.records:
        return None
    return share(costs.peak_seconds(flops), trace.stretch.window_s)
