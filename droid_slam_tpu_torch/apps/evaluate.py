"""Evaluation runner of the port: the four file protocols and the synthetic
one.

The port's counterpart of the JAX package's ``apps/evaluate.py``
(reference evaluation_scripts/test_{tum,euroc,eth3d}.py and
validate_tartanair.py, with the ``evo`` tool replaced by
:mod:`..eval.ate`). Each protocol tracks its stream with
:class:`..runtime.Droid`, ``terminate``s with its fill stream and scores the
trajectory against the ground truth:

  tum:       stride 2, mono, ``preset("tum")``, scale-corrected ATE
             (test_tum.py:106-119)
  euroc:     track stride 2 (``--stereo``: rectified pairs), fill stride 1,
             positions ×1.10, scale-corrected (test_euroc.py:111-138); the
             ground truth defaults to the sequence's own ``data.csv``
  eth3d:     RGB-D with depth/5000, unscaled ATE (test_eth3d.py:94-131);
             ``--mono`` drops the depth and scores scale-corrected
  tartanair: 384×512, scale-corrected, every row of ``pose_left.txt``
             associated by index (``max_dt`` 1e16; validate_tartanair.py:64-100)
  synthetic: a rendered sequence with exact ground truth
             (:mod:`..data.synthetic`): mono, ``--rgbd`` with the rendered
             depth, or ``--stereo`` with the rendered right image

The file streams yield frame indices as t; the epoch stamps of the
association come from the ``*_times`` helpers (:mod:`..data.streams`).

Usage:
  python -m droid_slam_tpu_torch.apps.evaluate --dataset tum --datapath <seq>
      [--gt groundtruth.txt] [--weights weights/droid_synth.msgpack]
      [--compute_dtype float32] [--save_traj traj.txt] [--device cpu]
  python -m droid_slam_tpu_torch.apps.evaluate --dataset synthetic
      [--stereo | --rgbd] [--datapath seed:7] [--frames 96] [--image_size 192 256]

It runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

SHIPPED_WEIGHTS = Path(__file__).resolve().parents[2] / "weights" / "droid_synth.msgpack"
FILE_DATASETS = ("tum", "euroc", "eth3d", "tartanair")
# association windows (s) of the synthetic protocol and of the file protocols;
# TartanAir stamps every frame with its index
SYNTHETIC_MAX_DT = 0.25
FILE_MAX_DT = 0.02
TARTANAIR_MAX_DT = 1e16


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


def file_protocol(dataset: str, datapath: str, stereo: bool = False, mono: bool = False,
                  gt: Optional[str] = None) -> Dict:
    """The inputs of a file protocol: its track and fill streams, its
    DroidConfig (the preset, at the stream's resolution), whether the ATE is
    scale-corrected, the factor on the estimated positions, the
    ground-truth file (``gt``, else the sequence's own where it exists),
    and the stamps of the fill stream's frames for the association."""
    from ..data import streams
    from ..runtime.config import preset

    pos_scale, correct_scale = 1.0, True
    if dataset == "tum":
        track = list(streams.tum_stream(datapath, stride=2))
        fill = track
        config = preset("tum")
        default_gt = f"{datapath}/groundtruth.txt"
        tstamps = streams.tum_times(datapath, stride=2)
    elif dataset == "euroc":
        track = list(streams.euroc_stream(datapath, stereo=stereo, stride=2))
        fill = list(streams.euroc_stream(datapath, stereo=False, stride=1))
        config = preset("euroc", stereo=stereo)
        pos_scale = 1.10
        default_gt = f"{datapath}/mav0/state_groundtruth_estimate0/data.csv"
        tstamps = streams.euroc_times(datapath, stride=1)
    elif dataset == "eth3d":
        # the protocol is RGB-D (test_eth3d.py:34), metric, unscaled; a
        # --mono run has an arbitrary scale and is scored scale-corrected
        track = list(streams.eth3d_stream(datapath, use_depth=not mono, stride=1))
        fill = list(streams.eth3d_stream(datapath, use_depth=False, stride=1))
        config = preset("eth3d")
        correct_scale = mono
        default_gt = f"{datapath}/groundtruth.txt"
        tstamps = streams.eth3d_times(datapath, stride=1)
    else:  # tartanair
        track = streams.tartanair_stream(datapath, stereo=stereo)
        fill = track  # the filler reads a stereo item's left image
        config = preset("tartanair", stereo=stereo)
        default_gt = f"{datapath}/pose_left.txt"
        tstamps = np.asarray([item[0] for item in fill], np.float64)
    if not track:
        raise ValueError(f"--dataset {dataset}: no frames under {datapath}")
    first = track[0][1]
    config = dataclasses.replace(config, image_size=tuple(first.shape[-3:-1]))
    if gt is None and os.path.exists(default_gt):
        gt = default_gt
    return dict(track=track, fill=fill, config=config, correct_scale=correct_scale, pos_scale=pos_scale, gt=gt,
                tstamps=np.asarray(tstamps, np.float64)[: len(fill)],
                max_dt=TARTANAIR_MAX_DT if dataset == "tartanair" else FILE_MAX_DT)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the protocol named by ``argv``; print and return the result."""
    parser = argparse.ArgumentParser(description="Evaluate the port on a dataset protocol.")
    parser.add_argument("--dataset", required=True, choices=FILE_DATASETS + ("synthetic",))
    parser.add_argument("--datapath", default=None,
                        help="the sequence's folder; for synthetic 'seed:<int>' (default seed:7)")
    parser.add_argument("--gt", default=None,
                        help="ground-truth file (TUM text, EuRoC .csv or TartanAir pose_left.txt; "
                        "default: the sequence's own)")
    parser.add_argument("--frames", type=int, default=96, help="synthetic: sequence length")
    parser.add_argument("--image_size", type=int, nargs=2, default=[192, 256],
                        help="synthetic: render resolution H W (multiples of 8)")
    parser.add_argument("--weights", default=str(SHIPPED_WEIGHTS) if SHIPPED_WEIGHTS.exists() else None,
                        help="weights file: the JAX package's .msgpack or a reference .pth "
                        "(default: the shipped weights; random weights when absent)")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--stereo", action="store_true",
                      help="euroc, tartanair: track the rectified stereo pairs; synthetic: the rendered pair")
    mode.add_argument("--rgbd", action="store_true", help="synthetic: feed the rendered depth")
    parser.add_argument("--mono", action="store_true",
                        help="eth3d: drop the depth stream (scored scale-corrected)")
    parser.add_argument("--compute_dtype", default=None, choices=["bfloat16", "float32"],
                        help="override the runtime compute dtype (default bfloat16)")
    parser.add_argument("--save_traj", default=None, help="write the trajectory in TUM format")
    parser.add_argument("--device", default=None, help="tracking device (default: cuda)")
    args = parser.parse_args(argv)
    if args.dataset in FILE_DATASETS and not args.datapath:
        parser.error(f"--dataset {args.dataset} needs --datapath")
    if args.stereo and args.dataset in ("tum", "eth3d"):
        parser.error(f"--dataset {args.dataset} has no stereo stream")
    if args.rgbd and args.dataset != "synthetic":
        parser.error("--rgbd is the synthetic protocol's (eth3d is RGB-D by default)")
    if args.mono and args.dataset != "eth3d":
        parser.error("--mono is eth3d's")

    from ..eval.ate import Trajectory, ate_rmse
    from ..runtime.config import DroidConfig

    if args.dataset == "synthetic":
        seed = 7
        if args.datapath:
            if not args.datapath.startswith("seed:"):
                parser.error("--datapath for synthetic is 'seed:<int>'")
            seed = int(args.datapath.split(":", 1)[1])
        track, fill, ref = synthetic_streams(seed, args.frames, args.image_size, args.stereo, args.rgbd)
        config = DroidConfig(image_size=tuple(args.image_size), buffer=max(96, args.frames), warmup=8,
                             stereo=args.stereo)
        # stereo and RGB-D are metric: ATE without scale correction
        correct_scale, pos_scale, max_dt = not (args.stereo or args.rgbd), 1.0, SYNTHETIC_MAX_DT
        tstamps = np.asarray([item[0] for item in fill], np.float64)
    else:
        proto = file_protocol(args.dataset, args.datapath, stereo=args.stereo, mono=args.mono, gt=args.gt)
        track, fill, config = proto["track"], proto["fill"], proto["config"]
        correct_scale, pos_scale, max_dt = proto["correct_scale"], proto["pos_scale"], proto["max_dt"]
        tstamps = proto["tstamps"]
        ref = None
        if proto["gt"]:
            ref = (Trajectory.load_tartanair(proto["gt"]) if args.dataset == "tartanair"
                   else Trajectory.load(proto["gt"]))
    if args.compute_dtype:
        config = dataclasses.replace(config, compute_dtype=args.compute_dtype)
    if args.weights is None:
        print("no weights file: random weights")

    traj, droid, walls = run_slam(config, args.weights, track, fill, device=args.device)
    est = Trajectory(tstamps, pos_scale * traj[:, :3].astype(np.float64), traj[:, 3:].astype(np.float64))
    if args.save_traj:
        est.save_tum(args.save_traj)
        print(f"saved trajectory to {args.save_traj}")
    result = {}
    if ref is not None:
        result = ate_rmse(ref, est, correct_scale=correct_scale, max_dt=max_dt)
    else:
        print("no ground truth: no ATE")
    result.update(dataset=args.dataset, keyframes=droid.counter, frames=len(track), device=str(droid.device),
                  compute_dtype=config.compute_dtype, image_size=list(config.image_size), **walls)
    print(json.dumps(result))
    result["trajectory"] = traj
    return result


if __name__ == "__main__":
    main()
