"""Evaluation runner of the port: the synthetic protocol.

The port's counterpart of the JAX package's ``apps/evaluate.py`` for
``--dataset synthetic``: render a sequence with exact ground truth
(:mod:`..data.synthetic`), track it with :class:`..runtime.Droid` (mono,
``--rgbd`` with the rendered depth, or ``--stereo`` with the rendered right
image), ``terminate`` with every frame as the fill stream, and score the
trajectory (:mod:`..eval.ate`): scale-corrected ATE in mono, unscaled in
the two metric modes. The file-based protocols (tum, euroc, eth3d,
tartanair) need the port's dataset streams and image loader, the next item
of ROADMAP.md's queue 1; they exit with an error.

Usage:
  python -m droid_slam_tpu_torch.apps.evaluate --dataset synthetic
      [--stereo | --rgbd] [--datapath seed:7] [--frames 96]
      [--image_size 192 256] [--weights weights/droid_synth.msgpack]
      [--compute_dtype float32] [--save_traj traj.txt] [--device cpu]

It runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

SHIPPED_WEIGHTS = Path(__file__).resolve().parents[2] / "weights" / "droid_synth.msgpack"
FILE_DATASETS = ("tum", "euroc", "eth3d", "tartanair")
# the synthetic protocol's association window (the JAX package's)
SYNTHETIC_MAX_DT = 0.25


def synthetic_streams(seed: int, frames: int, image_size, stereo: bool = False, rgbd: bool = False):
    """The synthetic protocol's inputs: (track, fill, ref). ``track`` holds
    (t, image, intrinsics) items, in stereo with the pair [2, H, W, 3] as
    the image, with ``rgbd`` (t, image, depth, intrinsics); ``fill`` holds
    (t, left image, intrinsics) for every frame; ``ref`` is the ground-truth
    :class:`..eval.ate.Trajectory`. Motion is sized so that the flow between
    frames at the 1/8 feature grid is ~2-3 px, the regime of the reference's
    keyframe threshold."""
    from ..data.synthetic import render_sequence
    from ..eval.ate import Trajectory

    seq = render_sequence(np.random.default_rng(seed), n_frames=frames, image_size=tuple(image_size),
                          t_sigma=0.25, r_sigma=0.02, stereo=stereo)
    if stereo:
        track = [(k, np.stack([seq["images"][k], seq["images_right"][k]]), seq["intrinsics"][k])
                 for k in range(frames)]
    elif rgbd:
        track = [(k, seq["images"][k], seq["depths"][k], seq["intrinsics"][k]) for k in range(frames)]
    else:
        track = [(k, seq["images"][k], seq["intrinsics"][k]) for k in range(frames)]
    fill = [(k, seq["images"][k], seq["intrinsics"][k]) for k in range(frames)]
    ref = Trajectory(np.arange(frames, dtype=np.float64), seq["poses"][:, :3].astype(np.float64),
                     seq["poses"][:, 3:].astype(np.float64))
    return track, fill, ref


def run_slam(config, weights: Optional[str], track_stream: Sequence, fill_stream: Sequence,
             device=None, fused: bool = True):
    """Track every item of ``track_stream`` ((t, image, intrinsics) or
    (t, image, depth, intrinsics)) with the fused engine, or with the
    host-driven one when ``fused`` is false, then ``terminate`` with
    ``fill_stream``. Returns (camera-to-world poses [T, 7], the Droid,
    walls): walls holds the seconds of tracking and of terminate, each
    ended by a device synchronise."""
    from ..runtime import Droid

    droid = Droid(config, weights=weights, device=device, fused=fused)
    t0 = time.perf_counter()
    for item in track_stream:
        if len(item) == 4:
            t, image, depth, intrinsics = item
            droid.track(t, image, depth=depth, intrinsics=intrinsics)
        else:
            t, image, intrinsics = item
            droid.track(t, image, intrinsics=intrinsics)
    droid.sync()
    t1 = time.perf_counter()
    traj = droid.terminate(iter(fill_stream))
    walls = dict(track_s=t1 - t0, terminate_s=time.perf_counter() - t1)
    return traj, droid, walls


def score(ref, tstamps, traj: np.ndarray, correct_scale: bool) -> Dict:
    """ATE of the camera-to-world poses ``traj`` [T, 7] at ``tstamps``
    against ``ref`` (the synthetic protocol's association window)."""
    from ..eval.ate import Trajectory, ate_rmse

    est = Trajectory.from_poses(tstamps, traj)
    return ate_rmse(ref, est, correct_scale=correct_scale, max_dt=SYNTHETIC_MAX_DT)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the protocol named by ``argv``; print and return the result."""
    parser = argparse.ArgumentParser(description="Evaluate the port on the synthetic protocol.")
    parser.add_argument("--dataset", required=True, choices=FILE_DATASETS + ("synthetic",))
    parser.add_argument("--datapath", default=None, help="synthetic: 'seed:<int>' (default seed:7)")
    parser.add_argument("--frames", type=int, default=96, help="synthetic: sequence length")
    parser.add_argument("--image_size", type=int, nargs=2, default=[192, 256],
                        help="synthetic: render resolution H W (multiples of 8)")
    parser.add_argument("--weights", default=str(SHIPPED_WEIGHTS) if SHIPPED_WEIGHTS.exists() else None,
                        help="weights file: the JAX package's .msgpack or a reference .pth "
                        "(default: the shipped weights; random weights when absent)")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--stereo", action="store_true", help="synthetic: track the rendered stereo pair")
    mode.add_argument("--rgbd", action="store_true", help="synthetic: feed the rendered depth")
    parser.add_argument("--compute_dtype", default=None, choices=["bfloat16", "float32"],
                        help="override the runtime compute dtype (default bfloat16)")
    parser.add_argument("--save_traj", default=None, help="write the trajectory in TUM format")
    parser.add_argument("--device", default=None, help="tracking device (default: cuda)")
    args = parser.parse_args(argv)
    if args.dataset in FILE_DATASETS:
        parser.error(f"--dataset {args.dataset} needs the port's dataset streams and native image "
                     "loader, which are not ported yet (ROADMAP.md, queue 1); the port runs "
                     "--dataset synthetic")

    from ..runtime.config import DroidConfig

    seed = 7
    if args.datapath:
        if not args.datapath.startswith("seed:"):
            parser.error("--datapath for synthetic is 'seed:<int>'")
        seed = int(args.datapath.split(":", 1)[1])
    track, fill, ref = synthetic_streams(seed, args.frames, args.image_size, args.stereo, args.rgbd)
    config = DroidConfig(image_size=tuple(args.image_size), buffer=max(96, args.frames), warmup=8,
                         stereo=args.stereo)
    if args.compute_dtype:
        config = dataclasses.replace(config, compute_dtype=args.compute_dtype)
    if args.weights is None:
        print("no weights file: random weights")

    traj, droid, walls = run_slam(config, args.weights, track, fill, device=args.device)
    tstamps = np.asarray([item[0] for item in fill], np.float64)
    if args.save_traj:
        from ..eval.ate import Trajectory

        Trajectory.from_poses(tstamps, traj).save_tum(args.save_traj)
        print(f"saved trajectory to {args.save_traj}")
    # stereo and RGB-D are metric: ATE without scale correction
    result = score(ref, tstamps, traj, correct_scale=not (args.stereo or args.rgbd))
    result.update(keyframes=droid.counter, frames=len(track), device=str(droid.device),
                  compute_dtype=config.compute_dtype, **walls)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
