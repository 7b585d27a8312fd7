"""Reference-scale synthetic evaluation: the long courtyard loop with a
revisit, on the port.

Counterpart of the JAX repo's ``tools/longloop.py``. It tracks every frame
of :func:`..data.synthetic.render_loop_sequence`, then runs
``warm_terminate`` and ``terminate`` with the fill stream (both global-BA
passes, then the trajectory filler), and reports the keyframes, the walls
and the scale-corrected ATE before and after terminate: the regime of a
keyframe buffer of 150 or more with a loop revisit that the reference
validates on (its ``evaluation_scripts/test_eth3d.py`` runs a buffer of
1024). Beside the JAX tool's row it reports each global-BA pass's edges
and update-operator chunks, the kernel launches of tracking and of
terminate by name and feature type, and the peak of allocated device
memory.

Rendering 240 frames at 384×512 takes about a minute on one host core
(``load_or_render(workers=)`` spreads it over threads), so the sequence is
cached as ``.npz`` (by default in the gitignored
``droid_slam_tpu_torch/data/cache/``), keyed by seed, frames and size.

  python -m droid_slam_tpu_torch.tools.longloop [--frames 288] [--image_size 384 512] \\
      [--seed 7] [--compute_dtype bfloat16] [--json out.json] [--device cpu] \\
      [--cache_dir DIR] [--weights weights/droid_synth.msgpack] [--no-capture]

It runs on CUDA unless ``--device`` names another device, with the fused
step and the factor graphs' steps replayed as CUDA graphs unless
``--no-capture`` (the CPU always runs them eagerly).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

DEFAULT_CACHE = Path(__file__).resolve().parents[1] / "data" / "cache"
SHIPPED_WEIGHTS = Path(__file__).resolve().parents[2] / "weights" / "droid_synth.msgpack"
MAX_DT = 0.25  # the synthetic protocol's association window (s)
PASS_STEPS = (7, 12)  # terminate's two global-BA passes


def load_or_render(seed: int, frames: int, H: int, W: int, cache_dir=None, workers: int = 1
                   ) -> Dict[str, np.ndarray]:
    """The loop sequence of ``seed`` (``frames`` frames at H×W), from the
    cache when it holds it, else rendered (on ``workers`` threads) and
    cached."""
    cache = Path(cache_dir) if cache_dir is not None else DEFAULT_CACHE
    path = cache / f"droid_longloop_{seed}_{frames}_{H}x{W}.npz"
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    from ..data.synthetic import render_loop_sequence

    t0 = time.perf_counter()
    seq = render_loop_sequence(np.random.default_rng(seed), n_frames=frames, image_size=(H, W), workers=workers)
    print(f"rendered {frames} frames at {H}x{W} in {time.perf_counter() - t0:.1f}s; caching to {path}",
          flush=True)
    cache.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")  # whole files only
    np.savez(tmp, **seq)
    os.replace(tmp, path)
    return seq


def run_sequence(seq: Dict[str, np.ndarray], config, weights=None, device=None, warm: bool = True,
                 on_frame: Optional[Callable] = None, profile: Optional[Callable] = None,
                 capture: bool = True) -> Tuple[Dict, np.ndarray]:
    """The loop protocol on a rendered sequence with ``config``: track
    every frame of ``seq``, ``warm_terminate`` at the tracked keyframe
    count (with ``warm``), then ``terminate`` with every frame as the fill
    stream, with the network of the file ``weights`` (random weights
    without one). ``on_frame(k, droid)``, when given, runs after frame k is
    tracked. ``profile``, when given, is called last with the Droid and
    the fill stream (a list), so that it may run the same terminate once
    more, and what it returns is the row's ``"profile"``. ``capture`` is
    ``Droid``'s. Terminate's launches are given as the wrappers count them
    (``launches``) and as the card ran them (``terminate_device_launches``:
    a captured launch runs on every replay), with its captures' cost
    (``terminate_capture``); the peaks of allocated and of reserved memory
    (the captured steps' pools among it) by stage. Returns (the row, the
    filled camera-to-world trajectory [frames, 7])."""
    import torch

    from ..eval.ate import Trajectory, ate_rmse
    from ..ops import kernels, lie
    from ..runtime import Droid

    frames = len(seq["images"])
    droid = Droid(config, weights=weights, device=device, capture=capture)
    cuda = droid.device.type == "cuda"
    peaks, reserved = {}, {}

    def peak(stage: str) -> None:
        """The peaks of allocated and of reserved memory (the captured
        steps' pools among it) since the last stage's, in GB."""
        if cuda:
            peaks[stage] = round(torch.cuda.max_memory_allocated(droid.device) / 1e9, 3)
            reserved[stage] = round(torch.cuda.max_memory_reserved(droid.device) / 1e9, 3)
            torch.cuda.reset_peak_memory_stats(droid.device)

    if cuda:
        torch.cuda.reset_peak_memory_stats(droid.device)
    ref = Trajectory.from_poses(np.arange(frames), seq["poses"])

    before = kernels.launch_counts()
    t0 = time.perf_counter()
    for k in range(frames):
        droid.track(k, seq["images"][k], intrinsics=seq["intrinsics"][k])
        if on_frame is not None:
            on_frame(k, droid)
    droid.sync()
    track_s = time.perf_counter() - t0
    track_launches = kernels.launches_since(before)
    peak("track")

    # the keyframe trajectory before terminate: separates the frontend's
    # drift from what the backend does
    kf = droid.counter
    est_kf = lie.inv(droid.poses).cpu().numpy()
    pre = ate_rmse(ref, Trajectory.from_poses(droid.tstamps.cpu().numpy(), est_kf), correct_scale=True,
                   max_dt=MAX_DT)

    warm_s = None
    if warm:
        t0 = time.perf_counter()
        droid.warm_terminate(expected_keyframes=kf)
        warm_s = time.perf_counter() - t0
        peak("warm_terminate")

    stream = [(k, seq["images"][k], seq["intrinsics"][k]) for k in range(frames)]
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    traj = droid.terminate(iter(stream))
    droid.sync()
    term_s = time.perf_counter() - t0
    term_launches = kernels.launches_since(before)
    peak("terminate")

    r = ate_rmse(ref, Trajectory.from_poses(np.arange(frames), traj), correct_scale=True, max_dt=MAX_DT)
    H, W = config.image_size
    row = {
        "frames": frames, "image_size": [H, W], "compute_dtype": config.compute_dtype,
        "keyframes": int(droid.video.counter),
        "track_s": round(track_s, 2),
        "track_fps": round(frames / track_s, 2),
        "terminate_s": round(term_s, 2),
        "ate_rmse": round(float(r["ate_rmse"]), 4),
        "scale": round(float(r["scale"]), 4),
        "ate_kf_pre_terminate": round(float(pre["ate_rmse"]), 4),
        "scale_kf_pre_terminate": round(float(pre["scale"]), 4),
        # the port's own readings
        "warm_terminate_s": None if warm_s is None else round(warm_s, 2),
        "poses_filled": int(len(traj)),
        "poses_finite": bool(np.isfinite(traj).all()),
        "backend_runs": [dict(steps=s, edges=e, chunks=c) for s, (e, c) in zip(PASS_STEPS, droid.backend_runs)],
        "launches": {"track": track_launches, "terminate": term_launches},
        "terminate_device_launches": droid.terminate_stats.device_launches(term_launches),
        "terminate_capture": {k: getattr(droid.terminate_stats, k)
                              for k in ("graphs", "held_max", "replays", "capture_s", "pool_bytes")},
        "peak_allocated_gb": max(peaks.values()) if cuda else None,
        "peak_allocated_gb_by_stage": peaks,
        "peak_reserved_gb_by_stage": reserved,
    }
    if profile is not None:
        row["profile"] = profile(droid, stream)
    return row, traj


def run(seed: int, frames: int, H: int, W: int, compute_dtype: str, warm: bool = True, device=None,
        cache_dir=None, weights=SHIPPED_WEIGHTS, profile: Optional[Callable] = None, capture: bool = True) -> Dict:
    """The JAX tool's protocol: the loop of ``seed`` at H×W, a buffer of
    ``frames`` + 24 (every frame may keyframe, and the filler needs free
    slots for its batches), warmup 8, the shipped weights. ``profile`` and
    ``capture`` as in :func:`run_sequence`."""
    from ..runtime import DroidConfig

    seq = load_or_render(seed, frames, H, W, cache_dir, workers=min(8, os.cpu_count() or 1))
    config = DroidConfig(image_size=(H, W), buffer=frames + 24, warmup=8, compute_dtype=compute_dtype)
    row, _ = run_sequence(seq, config, weights=str(weights), device=device, warm=warm, profile=profile,
                          capture=capture)
    return {"seed": seed, **row}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--frames", type=int, default=288)
    ap.add_argument("--image_size", type=int, nargs=2, default=[384, 512])
    ap.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--json", default=None, help="append the row here too")
    ap.add_argument("--device", default=None, help="device (default: cuda)")
    ap.add_argument("--cache_dir", default=None, help=f"where rendered loops are cached (default {DEFAULT_CACHE})")
    ap.add_argument("--weights", default=str(SHIPPED_WEIGHTS))
    ap.add_argument("--capture", action=argparse.BooleanOptionalAction, default=True,
                    help="replay the steps as CUDA graphs (default; CUDA only)")
    args = ap.parse_args(argv)

    row = run(args.seed, args.frames, *args.image_size, args.compute_dtype, device=args.device,
              cache_dir=args.cache_dir, weights=args.weights, capture=args.capture)
    print(json.dumps(row))
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(row) + "\n")
    return row


if __name__ == "__main__":
    main()
