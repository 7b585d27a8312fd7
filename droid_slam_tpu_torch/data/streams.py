"""Image streams of the demo and the four evaluation datasets (numpy on the
host).

The port's counterpart of the JAX package's ``data/streams.py`` (reference
demo.py:25-60, evaluation_scripts/test_tum.py:23-51, test_euroc.py:26-86,
test_eth3d.py:25-57, validate_tartanair.py:18-39). Every stream yields
(t, image, intrinsics) or (t, image, depth, intrinsics), the image **RGB**
uint8 [H, W, 3], in stereo the pair [2, H, W, 3], ready for
``Droid.track``.

``t`` is the ORIGINAL integer frame index, stride·k, as the reference's
streams yield it (test_euroc.py:76): the runtime keeps t in a float32
buffer and the trajectory filler interpolates on it, so a strided track
stream and a stride-1 fill stream share one small axis. The epoch
timestamps (TUM seconds, EuRoC nanoseconds), which float32 would collapse
(ulp(1.3e9 s) is 128 s), come from the ``*_times`` helpers, for the
ground-truth association only.

Decode, remap and resize go through the native library
(:mod:`.native_loader`, threaded prefetch in C++) when it builds, else
through ``cv2``, imported only then.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List

import numpy as np

from . import native_loader as _nl


def _cv2():
    import cv2

    return cv2


def _imread_rgb(path: str) -> np.ndarray:
    """Decode to RGB uint8 via the native library, falling back to cv2."""
    if _nl.available():
        img = _nl.imread(path)
        if img is not None and img.ndim == 3:
            return img
    return _bgr2rgb(_cv2().imread(path))


def _imread_depth16(path: str, scale: float) -> np.ndarray:
    """16-bit depth PNG → float32 metres (value/scale)."""
    if _nl.available():
        d = _nl.imread(path)
        if d is not None and d.dtype == np.uint16:
            return d.astype(np.float32) / scale
    cv2 = _cv2()
    return cv2.imread(path, cv2.IMREAD_ANYDEPTH).astype(np.float32) / scale


def _resize_rgb(img: np.ndarray, hw) -> np.ndarray:
    if _nl.available():
        return _nl.resize(img, hw)
    return _cv2().resize(img, (hw[1], hw[0]))


def _resize_to_area(image: np.ndarray, target_area: int = 384 * 512):
    """Resize so H·W ≈ target_area and crop to multiples of 8 (demo.py:46-52)."""
    h0, w0 = image.shape[:2]
    s = np.sqrt(target_area / (h0 * w0))
    h1, w1 = int(h0 * s), int(w0 * s)
    image = _resize_rgb(image, (h1, w1))
    image = image[: h1 - h1 % 8, : w1 - w1 % 8]
    return image, (w1 / w0, h1 / h0)


def _bgr2rgb(image: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(image[..., ::-1])


def image_stream(
    imagedir: str, calib: str, stride: int = 1, target_area: int = 384 * 512
) -> Iterator:
    """Generic calibrated monocular stream (demo.py:25-60). `calib` is a text
    file `fx fy cx cy [dist…]` (README.md:93-97). Frames are resized (aspect
    preserved) to ≈`target_area` pixels and cropped to multiples of 8."""
    calib_arr = np.loadtxt(calib, delimiter=" ")
    fx, fy, cx, cy = calib_arr[:4]
    K = np.eye(3)
    K[0, 0], K[0, 2], K[1, 1], K[1, 2] = fx, cx, fy, cy

    image_list = sorted(os.listdir(imagedir))[::stride]
    paths = [os.path.join(imagedir, f) for f in image_list]

    if _nl.available() and paths:
        # native worker-pool pipeline: decode -> [undistort] -> resize -> %8
        # crop all run ahead of the track loop in C++ threads
        first = _nl.imread(paths[0])
        h0, w0 = first.shape[:2]
        s = np.sqrt(target_area / (h0 * w0))
        h1, w1 = int(h0 * s), int(w0 * s)
        maps = (
            _nl.build_undistort_rectify_map(K, calib_arr[4:], (w0, h0))
            if len(calib_arr) > 4 else None
        )
        sx, sy = w1 / w0, h1 / h0
        intrinsics = np.array([fx * sx, fy * sy, cx * sx, cy * sy], np.float32)
        pipe = _nl.Pipeline(
            paths, maps=maps, resize_hw=(h1, w1),
            crop=(0, 0, h1 % 8, w1 % 8),  # (top, left, bottom, right)
        )
        for t, image in enumerate(pipe):
            yield t, image, intrinsics
        return

    for t, path in enumerate(paths):
        image = _imread_rgb(path)
        if len(calib_arr) > 4:
            image = _cv2().undistort(image, K, calib_arr[4:])
        image, (sx, sy) = _resize_to_area(image, target_area)
        intrinsics = np.array([fx * sx, fy * sy, cx * sx, cy * sy], np.float32)
        yield t, image, intrinsics


def tum_stream(datapath: str, stride: int = 2) -> Iterator:
    """TUM-RGBD fr1 monocular protocol (test_tum.py:23-51): fixed fr1
    intrinsics, undistort, resize to 352×256, crop 16/8 margins."""
    cv2 = _cv2() if not _nl.available() else None
    fx, fy, cx, cy = 517.3, 516.5, 318.6, 255.3
    K = np.array([fx, 0, cx, 0, fy, cy, 0, 0, 1]).reshape(3, 3)
    d = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])

    images_list = sorted(glob.glob(os.path.join(datapath, "rgb", "*.png")))[::stride]
    # fr1 frames are 640x480 -> resize to 256+16 x 352(=320+32) -> crop margins
    intr = np.array(
        [fx * 352 / 640.0, fy * 256 / 480.0,
         cx * 352 / 640.0 - 16, cy * 256 / 480.0 - 8],
        np.float32,
    )
    if _nl.available():
        # full decode -> undistort-remap -> resize -> crop chain runs in the
        # native C++ worker pool, overlapping with device tracking
        maps = _nl.build_undistort_rectify_map(K, d, (640, 480))
        pipe = _nl.Pipeline(
            images_list, maps=maps, resize_hw=(256, 352),
            crop=(8, 16, 8, 16),  # (top, left, bottom, right) -> 240x320
        )
        for t, image in enumerate(pipe):
            yield stride * t, image, intr
        return
    for t, imfile in enumerate(images_list):
        image = cv2.undistort(_bgr2rgb(cv2.imread(imfile)), K, d)
        image = cv2.resize(image, (352, 256))[8:-8, 16:-16]
        yield stride * t, image, intr


def tum_times(datapath: str, stride: int = 2) -> np.ndarray:
    """Epoch timestamps (seconds, float64) of the strided TUM frames, for
    ground-truth association only."""
    files = sorted(glob.glob(os.path.join(datapath, "rgb", "*.png")))[::stride]
    return np.array([float(os.path.basename(f)[:-4]) for f in files], np.float64)


# EuRoC factory rectification (test_euroc.py:28-51)
_EUROC_K_L = np.array([458.654, 0, 367.215, 0, 457.296, 248.375, 0, 0, 1]).reshape(3, 3)
_EUROC_D_L = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
_EUROC_R_L = np.array(
    [0.999966347530033, -0.001422739138722922, 0.008079580483432283,
     0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
     -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
).reshape(3, 3)
_EUROC_P_L = np.array(
    [435.2046959714599, 0, 367.4517211914062, 0,
     0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]
).reshape(3, 4)
_EUROC_K_R = np.array([457.587, 0, 379.999, 0, 456.134, 255.238, 0, 0, 1]).reshape(3, 3)
_EUROC_D_R = np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0])
_EUROC_R_R = np.array(
    [0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
     0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
     -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
).reshape(3, 3)
_EUROC_P_R = np.array(
    [435.2046959714599, 0, 367.4517211914062, -47.90639384423901,
     0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]
).reshape(3, 4)


def euroc_stream(
    datapath: str, image_size=(320, 512), stereo: bool = False, stride: int = 1
) -> Iterator:
    """EuRoC MAV stream with stereo rectification (test_euroc.py:26-86)."""
    map_l = _nl.build_undistort_rectify_map(
        _EUROC_K_L, _EUROC_D_L, (752, 480), R=_EUROC_R_L, P=_EUROC_P_L[:3, :3]
    )
    map_r = _nl.build_undistort_rectify_map(
        _EUROC_K_R, _EUROC_D_R, (752, 480), R=_EUROC_R_R, P=_EUROC_P_R[:3, :3]
    )
    intr_vec = np.array(
        [435.2046959714599, 435.2046959714599, 367.4517211914062, 252.2008514404297]
    )
    ht0, wd0 = 480, 752
    H, W = image_size

    images_left = sorted(glob.glob(os.path.join(datapath, "mav0/cam0/data/*.png")))[::stride]
    images_right = [x.replace("cam0", "cam1") for x in images_left]

    def _remap(img, maps):
        if _nl.available():
            return _nl.remap(img, *maps)
        cv2 = _cv2()
        return cv2.remap(img, maps[0], maps[1], cv2.INTER_LINEAR)

    intr = (intr_vec * np.array([W / wd0, H / ht0, W / wd0, H / ht0])).astype(
        np.float32
    )
    if not stereo and _nl.available():
        # mono: the decode -> rectify-remap -> resize chain runs in the
        # native C++ worker pool, overlapping with device tracking
        pipe = _nl.Pipeline(images_left, maps=map_l, resize_hw=(H, W))
        for t, image in enumerate(pipe):
            yield stride * t, image, intr
        return

    for t, (imgL, imgR) in enumerate(zip(images_left, images_right)):
        if stereo and not os.path.isfile(imgR):
            continue
        frames = [_remap(_imread_rgb(imgL), map_l)]
        if stereo:
            frames.append(_remap(_imread_rgb(imgR), map_r))
        image = np.stack([_resize_rgb(f, (H, W)) for f in frames], 0)
        if not stereo:
            image = image[0]
        intr = intr_vec * np.array([W / wd0, H / ht0, W / wd0, H / ht0])
        yield stride * t, image, intr.astype(np.float32)


def euroc_times(datapath: str, stride: int = 1) -> np.ndarray:
    """Epoch timestamps (seconds, float64; filenames are nanoseconds) of the
    strided EuRoC cam0 frames, for ground-truth association only."""
    files = sorted(glob.glob(os.path.join(datapath, "mav0/cam0/data/*.png")))[::stride]
    return np.array(
        [float(os.path.basename(f)[:-4]) for f in files], np.float64
    ) / 1e9


def eth3d_stream(datapath: str, use_depth: bool = False, stride: int = 1) -> Iterator:
    """ETH3D SLAM RGB-D stream, depth scale 1/5000 (test_eth3d.py:25-57)."""
    fx, fy, cx, cy = np.loadtxt(os.path.join(datapath, "calibration.txt")).tolist()
    image_list = sorted(glob.glob(os.path.join(datapath, "rgb", "*.png")))[::stride]
    depth_list = sorted(glob.glob(os.path.join(datapath, "depth", "*.png")))[::stride]

    for t, (image_file, depth_file) in enumerate(zip(image_list, depth_list)):
        image = _imread_rgb(image_file)
        h0, w0 = image.shape[:2]
        image, (sx, sy) = _resize_to_area(image)
        intr = np.array([fx * sx, fy * sy, cx * sx, cy * sy], np.float32)
        if not use_depth:
            # don't decode the 16-bit depth PNG just to discard it
            yield stride * t, image, intr
            continue

        depth = _imread_depth16(depth_file, 5000.0)
        # the uncropped resize target of _resize_to_area (sx/sy carry it)
        h1, w1 = int(round(h0 * sy)), int(round(w0 * sx))
        if _nl.available():
            depth = _nl.resize_nearest(depth, (h1, w1))
        else:
            cv2 = _cv2()
            depth = cv2.resize(depth, (w1, h1), interpolation=cv2.INTER_NEAREST)
        depth = depth[: h1 - h1 % 8, : w1 - w1 % 8]
        yield stride * t, image, depth.astype(np.float32), intr


def eth3d_times(datapath: str, stride: int = 1) -> np.ndarray:
    """Epoch timestamps (seconds, float64) of the strided ETH3D frames, for
    ground-truth association only."""
    files = sorted(glob.glob(os.path.join(datapath, "rgb", "*.png")))[::stride]
    return np.array([float(os.path.basename(f)[:-4]) for f in files], np.float64)


def tartanair_stream(
    datapath: str,
    image_size=(384, 512),
    intrinsics_vec=(320.0, 320.0, 320.0, 240.0),
    stereo: bool = False,
) -> List:
    """TartanAir validation stream (validate_tartanair.py:18-39)."""
    H, W = image_size
    images_left = sorted(glob.glob(os.path.join(datapath, "image_left/*.png")))
    images_right = sorted(glob.glob(os.path.join(datapath, "image_right/*.png")))

    data = []
    for t in range(len(images_left)):
        frames = [_resize_rgb(_imread_rgb(images_left[t]), (H, W))]
        if stereo:
            frames.append(_resize_rgb(_imread_rgb(images_right[t]), (H, W)))
        image = np.stack(frames, 0)
        if not stereo:
            image = image[0]
        intr = 0.8 * np.asarray(intrinsics_vec, np.float32)
        data.append((t, image, intr))
    return data
