"""The control of the check, and the readings its limits are set from.

  python3 slam_bench/control.py --workload <cell> --seeds 1 2 3 [--out DIR]

For each seed, on the card at the cell's own size, it follows the program
as a run's check does (a replay of the timed path, keeping the state
before and after each followed step) and reads, against the float32
reference from the same states:

* ``program``: the program's own steps, as the configuration states it
  (bf16 update operator, TF32 off): the lower readings;
* ``fp8``: the control, the reference in the program's place with the
  update operator's convolutions on float8 e4m3 inputs and weights
  (``check.precision``): the upper readings;
* ``unchanged``: the fault of a step that returns its state unchanged,
  read from the state before each step without a run (and, for ``ate``,
  keyframes that never leave the origin).

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from slam_bench import check as compare  # noqa: E402
from slam_bench import harness, run  # noqa: E402


def readings(ctx):
    """{variant: [(name, value), ...]} of one seed."""
    driver = harness.load_module("drivers", ctx.cell.workload["driver"])
    replay, steps = driver.follow(ctx)
    ref = driver.reference_steps(ctx, steps)
    low = driver.reference_steps(ctx, steps, "fp8")
    prog = [after for _, _, after in steps]
    gt = ctx.inputs["poses"]
    diag = lambda rows: [(f"step{k}_{n}", v) for (k, b, _), a, r in zip(steps, rows, ref)  # noqa: E731
                         for n, v in driver.step_diagnostics(k, b, a, r).items()
                         if not driver._initialises(b, a, r)]
    unchanged = [before for _, before, _ in steps]  # a step that returns its state unchanged
    still = dict(replay, poses=np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (len(replay["poses"]), 1)))
    return {"program": driver.step_readings(steps, prog, ref) + driver.init_readings(steps, prog, ref, gt)
            + [("ate", compare.ate(replay, gt))] + diag(prog),
            "fp8": driver.step_readings(steps, low, ref) + driver.init_readings(steps, low, ref, gt) + diag(low),
            "unchanged": driver.init_readings(steps, unchanged, ref, gt) + [("ate", compare.ate(still, gt))]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell.load(args.workload)
    run.import_port().kernels.build()
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(run.make_context(cell, seed, torch, torch.device("cuda")))
        for variant, numbers in got.items():
            line = json.dumps({"workload": args.workload, "seed": seed, "variant": variant, **dict(numbers)})
            print(line, flush=True)
            if args.out:
                Path(args.out).mkdir(parents=True, exist_ok=True)
                with (Path(args.out) / f"control_{args.workload}.jsonl").open("a") as f:
                    f.write(line + "\n")
        print(f"control: seed {seed} took {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
