"""SLAM demo on a folder of images, or on a synthetic stream.

The port's counterpart of the JAX package's ``apps/demo.py`` (reference
demo.py): stream calibrated images (:func:`..data.streams.image_stream`:
resized to about ``--image_size``'s area, cropped to multiples of 8),
track them, ``terminate`` with global BA and the trajectory fill over
every streamed frame, and optionally save the reconstruction (tstamps,
images, disps, poses, intrinsics as ``.npy``, demo.py:64-81).

Usage:
  python -m droid_slam_tpu_torch.apps.demo --imagedir <dir> --calib <calib.txt>
      [--weights weights/droid_synth.msgpack] [--stride 3] [--buffer 512]
      [--image_size 384 512] [--t0 0] [--t1 N] [--reconstruction_path out]
      [--visualize] [--profile DIR] [--warm_terminate] [--device cpu]
  python -m droid_slam_tpu_torch.apps.demo --synthetic    # no data needed

The calibration file holds ``fx fy cx cy [k1 k2 p1 p2 [k3]]`` (``calib/``).
It runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def save_reconstruction(droid, path: str) -> None:
    """Write the terminated keyframe map (demo.py:64-81): tstamps, images,
    upsampled disparities, world→camera poses and intrinsics."""
    video = droid.video
    t = video.counter
    os.makedirs(path, exist_ok=True)
    for name, buf in (("tstamps", video.tstamp), ("images", video.images), ("disps", video.disps_up),
                      ("poses", video.poses), ("intrinsics", video.intrinsics)):
        np.save(os.path.join(path, f"{name}.npy"), buf[:t].cpu().numpy())


def synthetic_stream(n: int = 24, H: int = 64, W: int = 64, seed: int = 0):
    """Random frames with a fixed pinhole camera (a smoke drive)."""
    rng = np.random.default_rng(seed)
    intr = np.array([W, W, W / 2, H / 2], np.float32)
    for t in range(n):
        yield t, rng.integers(0, 255, (H, W, 3), np.uint8), intr


# the synthetic drive's configuration: every frame a keyframe, small buffers
SYNTHETIC_CONFIG = dict(buffer=64, warmup=4, max_factors=16, inactive_pad=16, window_pad=16,
                        schur_pair_floor=512, filter_thresh=-1.0, keyframe_thresh=0.0, frontend_window=8,
                        frontend_thresh=1e9, backend_thresh=1e9)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Run the port's SLAM system on a folder of images.")
    ap.add_argument("--imagedir", type=str, help="path to the image folder")
    ap.add_argument("--calib", type=str, help="path to the calibration file")
    ap.add_argument("--weights", default=None,
                    help="weights file: the JAX package's .msgpack or a reference .pth (default: random)")
    ap.add_argument("--buffer", type=int, default=512)
    ap.add_argument("--image_size", default=None, nargs=2, type=int,
                    help="working resolution: frames are resized (aspect kept) to about H*W pixels "
                    "(default: the reference's 384*512 area, demo.py:47-52)")
    ap.add_argument("--t0", default=0, type=int, help="first frame")
    ap.add_argument("--t1", default=None, type=int, help="last frame (inclusive)")
    ap.add_argument("--stride", default=3, type=int)
    ap.add_argument("--filter_thresh", type=float, default=2.4)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--keyframe_thresh", type=float, default=4.0)
    ap.add_argument("--frontend_thresh", type=float, default=16.0)
    ap.add_argument("--frontend_window", type=int, default=25)
    ap.add_argument("--frontend_radius", type=int, default=2)
    ap.add_argument("--frontend_nms", type=int, default=1)
    ap.add_argument("--backend_thresh", type=float, default=22.0)
    ap.add_argument("--backend_radius", type=int, default=2)
    ap.add_argument("--backend_nms", type=int, default=3)
    ap.add_argument("--upsample", action="store_true")
    ap.add_argument("--visualize", action="store_true",
                    help="the live map (an Open3D window where open3d imports, else headless)")
    ap.add_argument("--reconstruction_path", default=None, help="save the map here (forces --upsample)")
    ap.add_argument("--synthetic", action="store_true", help="run on random frames (a smoke drive)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of tracking to DIR/trace.json")
    ap.add_argument("--warm_terminate", action="store_true",
                    help="pay terminate's first-use costs before tracking (Droid.warm_terminate)")
    ap.add_argument("--compute_dtype", default=None, choices=["bfloat16", "float32"],
                    help="the update operator's dtype (default bfloat16)")
    ap.add_argument("--device", default=None, help="tracking device (default: cuda)")
    return ap


def load_stream(args: argparse.Namespace) -> List[Tuple]:
    """The frames ``args`` names: (t, image, intrinsics) items."""
    from ..data.streams import image_stream

    if args.synthetic:
        return list(synthetic_stream())
    area = args.image_size[0] * args.image_size[1] if args.image_size else 384 * 512
    stream = list(image_stream(args.imagedir, args.calib, args.stride, target_area=area))
    # t1 inclusive (reference demo.py:87-88,124-126)
    return stream[args.t0 : None if args.t1 is None else args.t1 + 1]


def config_for(args: argparse.Namespace, hw):
    """The DroidConfig of ``args`` at the stream's resolution ``hw``."""
    from ..runtime import DroidConfig

    if args.synthetic:
        config = DroidConfig(image_size=tuple(hw), upsample=args.upsample, **SYNTHETIC_CONFIG)
    else:
        config = DroidConfig(
            image_size=tuple(hw), buffer=args.buffer, filter_thresh=args.filter_thresh, warmup=args.warmup,
            keyframe_thresh=args.keyframe_thresh, frontend_thresh=args.frontend_thresh,
            frontend_window=args.frontend_window, frontend_radius=args.frontend_radius,
            frontend_nms=args.frontend_nms, backend_thresh=args.backend_thresh,
            backend_radius=args.backend_radius, backend_nms=args.backend_nms, upsample=args.upsample,
        )
    if args.compute_dtype:
        config = dataclasses.replace(config, compute_dtype=args.compute_dtype)
    return config


def main(argv: Optional[List[str]] = None) -> Tuple[np.ndarray, Dict]:
    """Run the demo named by ``argv``. Returns (camera-to-world poses of
    every streamed frame [T, 7], a record: frames, keyframes, the tracking
    and terminate walls, each ended by a device synchronise, frames/s)."""
    ap = parser()
    args = ap.parse_args(argv)
    if not args.synthetic and not (args.imagedir and args.calib):
        ap.error("--imagedir and --calib are required unless --synthetic")
    # the exported map's dense depths are the upsampled disparities; without
    # them disps.npy would be zeros (demo.py:118-119)
    if args.reconstruction_path is not None:
        args.upsample = True

    from ..runtime import Droid
    from ..utils.profiling import device_trace

    stream = load_stream(args)
    if not stream:
        ap.error(f"no frames in {args.imagedir}")
    config = config_for(args, stream[0][1].shape[:2])
    droid = Droid(config, weights=args.weights, device=args.device, visualize=args.visualize)
    if args.warm_terminate:
        # a sequence keyframes about a third of its frames
        droid.warm_terminate(expected_keyframes=max(len(stream) // 3, 8))

    trace = device_trace(args.profile) if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with trace:
        for t, image, intrinsics in stream:
            droid.track(t, image, intrinsics=intrinsics)
        droid.sync()
    track_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    traj = droid.terminate(iter(stream))
    droid.sync()
    terminate_s = time.perf_counter() - t0

    record = dict(frames=len(stream), keyframes=droid.counter, image_size=list(config.image_size),
                  track_s=track_s, fps=len(stream) / track_s, terminate_s=terminate_s, device=str(droid.device))
    print(f"tracked {len(stream)} frames / {droid.counter} keyframes on {droid.device}")
    print(f"timings: track {track_s:.2f}s ({record['fps']:.2f} fps), terminate {terminate_s:.2f}s")
    print("trajectory (first 5 poses, tx ty tz qx qy qz qw):")
    print(np.array2string(traj[:5], precision=4, suppress_small=True))
    if args.reconstruction_path:
        save_reconstruction(droid, args.reconstruction_path)
        print(f"saved reconstruction to {args.reconstruction_path}")
    return traj, record


if __name__ == "__main__":
    main()
