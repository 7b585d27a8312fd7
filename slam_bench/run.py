"""The benchmark of droid_slam_tpu_torch, one cell per run.

  python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the machine it is started on and needs as many CUDA devices as
the cell asks for; without them it prints no result and exits 2. It
renders the cell's inputs from ``--seed``, sets the program up (warming
every shape the cell's traffic uses), measures for ``--seconds`` seconds,
reads the peak of reserved device memory, and with ``--trace 1`` profiles
a fixed stretch of whole units of work and reads the per-layer metrics.
Then it frees the program's state and checks what the window produced
against the plain reference (``slam_bench/reference/``). Its last line on
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``check``, each compared number beside its limit (also the last
lines on standard error).
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from slam_bench import harness  # noqa: E402

# build and kernel caches at fixed paths inside the checkout
CACHE_DIR = ROOT / ".bench_cache"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def import_port():
    """The system under test: the PyTorch and CUDA port."""
    from droid_slam_tpu_torch.models.weights import load_weights
    from droid_slam_tpu_torch.ops import kernels
    from droid_slam_tpu_torch.runtime import Droid, DroidConfig

    return types.SimpleNamespace(Droid=Droid, DroidConfig=DroidConfig, load_weights=load_weights,
                                 kernels=kernels)


def make_context(cell: harness.Cell, seed: int, torch, device):
    """What a driver works with: the program, its weights and
    configuration, and the cell's inputs rendered from ``seed``."""
    port = import_port()
    weights = cell.weights_path()
    fields = cell.droid_fields()
    w = cell.workload
    gen = harness.load_module("generators", w["generator"])
    return types.SimpleNamespace(
        torch=torch, device=device, cell=cell, seed=seed, port=port, weights=weights,
        params=port.load_weights(str(weights)), fields=fields, droid_config=port.DroidConfig(**fields),
        inputs=gen.generate(seed, image_size=fields["image_size"], **w["generator_args"]),
        args=w.get("driver_args", {}),
    )


def log(msg: str) -> None:
    print(f"slam_bench: {msg}", file=sys.stderr, flush=True)


def measure(cell: harness.Cell, seed: int, seconds: float, trace: bool, torch, device,
            t0: float = None, spec=None):
    """One run of ``cell``. Returns the result object; on a device that is
    not CUDA it withholds every metric (a dry run of the control flow)."""
    t0 = _T0 if t0 is None else t0
    cuda = device.type == "cuda"
    spec = harness.benchmark_spec() if spec is None else spec
    ctx = make_context(cell, seed, torch, device)
    if cuda:
        ctx.port.kernels.build()
    driver = harness.load_module("drivers", cell.workload["driver"])
    log(f"inputs {tuple(ctx.inputs['images'].shape)} at {time.perf_counter() - t0:.2f} s")
    state = driver.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.2f} s")
    e2e, attempted = driver.window(ctx, state, seconds)
    log(f"window: {e2e}, {attempted} units")
    peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    e2e["setup_s"] = setup_s
    e2e["peak_mem_gib"] = peak / 2**30

    traced = driver.trace(ctx, state) if trace and cuda else None
    # the check replays the program where it must, then frees the
    # program's state, then runs the reference
    t_check = time.perf_counter()
    numbers = driver.check(ctx, state)
    del state
    log(f"check {time.perf_counter() - t_check:.2f} s")
    correct, table = harness.check_lines(numbers)

    result = {"correct": correct, "attempted": attempted, "failed": 0 if correct else attempted}
    device_out = {"platform": "gpu" if cuda else device.type, "count": 1}
    if not cuda:
        result.update(metrics={}, device=device_out, refused="not a CUDA device: no metric is printed",
                      check=table)
        return result
    card = harness.device_info(torch)
    device_out.update(kind=card["kind"], memory_peak_bytes=int(peak))
    section = "per_layer" if trace else "end_to_end"
    wanted = harness.cell_metrics(spec, cell.name, section)
    if trace:
        metrics = harness.read_metrics(traced, wanted)
        device_out.update(busy_s=traced.stretch.busy_s(), window_s=traced.stretch.window_s)
        top = sorted(traced.stretch.by_name().items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in top],
                               "idle_gaps": [[n, s] for n, s in traced.stretch.idle_gaps()]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in wanted}
    result["metrics"] = metrics
    result["device"] = device_out
    result["card"] = card["nvidia_smi"]
    result["check"] = table
    return result


def main(argv=None) -> int:
    args = parse(argv)
    CACHE_DIR.mkdir(exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    try:
        spec = harness.benchmark_spec()
        entry = next((x for x in spec["workloads"] if x["name"] == args.workload), None)
        if entry is None:
            raise harness.BenchError(f"BENCHMARK.json has no workload {args.workload!r}")
        cell = harness.Cell.load(args.workload)
        if cell.workload["config"] != entry["config"] or cell.workload["traffic"] != entry["traffic"]:
            raise harness.BenchError(f"workloads/{args.workload}.json does not match BENCHMARK.json's entry")
    except (harness.BenchError, OSError, ValueError) as e:
        print(f"slam_bench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"slam_bench: the cell needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    # the precision the configurations state: TF32 off for matmuls and cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        result = measure(cell, args.seed, args.seconds, bool(args.trace), torch, torch.device("cuda"),
                         spec=spec)
    except harness.BenchError as e:
        print(f"slam_bench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"slam_bench: the process holds modules it may not load: {found}", file=sys.stderr)
        return 3
    for name, row in result["check"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
