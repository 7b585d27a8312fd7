"""In-process accuracy sweep over weights × seeds on the synthetic protocol.

Counterpart of the JAX repo's ``tools/eval_sweep.py``: one process renders
each seed once and runs every weights file on it through
:func:`..apps.evaluate.run_slam`, the protocol of ``apps/evaluate.py
--dataset synthetic`` (the same renderer call, t_sigma 0.25 and r_sigma
0.02, a buffer of max(96, frames), warmup 8, scale-corrected ATE). The
port compiles nothing per shape, so one process saves the renders and the
kernels' build, not compiles. Each row is the JAX tool's, with the
unrounded ATE and scale beside the rounded ones.

  python -m droid_slam_tpu_torch.tools.eval_sweep --weights A.msgpack B.pth --seeds 7 11 23 \\
      [--frames 48] [--image_size 192 256] [--compute_dtype float32] [--json out] [--device cpu]

It runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Sequence

import numpy as np


def sweep(weights: Sequence[str], seeds: Sequence[int], frames: int = 48, image_size=(192, 256),
          compute_dtype: str = "float32", device=None) -> List[Dict]:
    """One row per (weights file, seed), weights outermost; each row is
    printed as it is done."""
    from ..apps.evaluate import run_slam, score, synthetic_streams
    from ..runtime import DroidConfig

    H, W = image_size
    config = DroidConfig(image_size=(H, W), buffer=max(96, frames), warmup=8, compute_dtype=compute_dtype)
    # each seed rendered once, for every weights file
    streams = {seed: synthetic_streams(seed, frames, (H, W)) for seed in seeds}
    tstamps = np.arange(frames, dtype=np.float64)
    rows = []
    for wts in weights:
        for seed in seeds:
            track, fill, ref = streams[seed]
            t0 = time.perf_counter()
            traj, droid, _ = run_slam(config, wts, track, fill, device=device)
            r = score(ref, tstamps, traj, correct_scale=True)
            row = {
                "weights": wts, "seed": seed, "dtype": compute_dtype,
                "kf": int(droid.counter),
                "ate": round(float(r["ate_rmse"]), 4),
                "scale": round(float(r["scale"]), 3),
                "wall_s": round(time.perf_counter() - t0, 1),
                "ate_rmse": float(r["ate_rmse"]),
                "scale_fit": float(r["scale"]),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            del droid
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 11, 23])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--image_size", type=int, nargs=2, default=[192, 256])
    ap.add_argument("--compute_dtype", default="float32", choices=["bfloat16", "float32"])
    ap.add_argument("--json", default=None, help="append JSONL here too")
    ap.add_argument("--device", default=None, help="device (default: cuda)")
    args = ap.parse_args(argv)
    rows = sweep(args.weights, args.seeds, args.frames, tuple(args.image_size), args.compute_dtype, args.device)
    if args.json:
        with open(args.json, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
