"""Single dataclass config with per-dataset presets.

The port's own copy of ``droid_slam_tpu/runtime/config.py``: same fields,
defaults and presets, so one configuration drives both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class DroidConfig:
    # --- geometry / buffers ---
    image_size: Tuple[int, int] = (240, 320)  # full-res (H, W), multiples of 8
    buffer: int = 512  # keyframe capacity (demo.py:93)
    stereo: bool = False
    upsample: bool = False

    # --- motion filter ---
    filter_thresh: float = 2.4  # mean flow (px) to trigger a keyframe

    # --- frontend ---
    warmup: int = 8
    keyframe_thresh: float = 4.0
    frontend_thresh: float = 16.0
    frontend_window: int = 25
    frontend_radius: int = 2
    frontend_nms: int = 1
    max_age: int = 25
    frontend_iters1: int = 4
    frontend_iters2: int = 2
    max_factors: int = 48

    # --- backend ---
    backend_thresh: float = 22.0
    backend_radius: int = 2
    backend_nms: int = 3

    # --- shared ---
    beta: float = 0.3  # frame-distance rotation/translation blend

    # --- static capacities of the tracking state ---
    window_pad: int = 64  # max frontend BA window (t1 - t0)
    inactive_pad: int = 96  # capacity of the inactive-edge store
    schur_pair_floor: int = 4096  # min pad of the backend's Schur pair list
    backend_chunk: int = 256  # edges per update-op chunk in the backend

    # --- misc ---
    # computation dtype of the update operator's convolutions and of the
    # stored features ("bfloat16" | "float32"); parameters, encoders and all
    # BA geometry stay float32
    compute_dtype: str = "bfloat16"

    @property
    def feat_size(self) -> Tuple[int, int]:
        return (self.image_size[0] // 8, self.image_size[1] // 8)


# Presets matching the reference's tuned per-dataset flags.
PRESETS = {
    # demo.py:84-111
    "demo": DroidConfig(),
    # test_tum.py:55-74
    "tum": DroidConfig(
        buffer=512,
        beta=0.6,
        warmup=12,
        filter_thresh=1.75,
        keyframe_thresh=2.25,
        frontend_thresh=12.0,
        backend_thresh=15.0,
        frontend_window=25,
        frontend_radius=2,
        frontend_nms=1,
        image_size=(240, 320),
    ),
    # test_euroc.py:80-101
    "euroc": DroidConfig(
        buffer=512,
        warmup=15,
        filter_thresh=2.4,
        keyframe_thresh=3.5,
        frontend_thresh=17.5,
        frontend_window=20,
        frontend_radius=2,
        frontend_nms=1,
        backend_thresh=24.0,
        backend_radius=2,
        backend_nms=2,
        image_size=(320, 512),
    ),
    # test_eth3d.py:59-81
    "eth3d": DroidConfig(
        buffer=1024,
        beta=0.5,
        warmup=8,
        filter_thresh=2.0,
        keyframe_thresh=3.5,
        frontend_thresh=16.0,
        frontend_window=16,
        frontend_radius=1,
        frontend_nms=0,
        image_size=(240, 320),
    ),
    # validate_tartanair.py:41-63
    "tartanair": DroidConfig(
        buffer=1000,
        image_size=(384, 512),
        beta=0.3,
        filter_thresh=2.4,
        warmup=12,
        frontend_thresh=15.0,
        frontend_window=20,
        frontend_radius=1,
        frontend_nms=1,
        keyframe_thresh=3.5,
        backend_thresh=20.0,
        backend_radius=2,
        backend_nms=3,
    ),
}


def preset(name: str, **overrides) -> DroidConfig:
    return dataclasses.replace(PRESETS[name], **overrides)
