"""Droid: the SLAM system facade of the port.

Counterpart of the JAX package's ``runtime/droid.py``: ``track()`` runs the
motion filter and the frontend for one input frame (monocular, RGB-D or a
stereo pair) on the tracking device; ``terminate()`` runs the global
backend twice (7 then 12 steps) and returns the keyframe trajectory, or
with a stream the trajectory of every frame. Two tracking engines share the
math and the state layout:

* ``fused=True`` (default): the per-frame step of :mod:`.fused`, all state
  in one device structure, two host reads per frame; ``terminate`` works on
  a copy of the tracked state, so it may run more than once;
* ``fused=False``: the host-driven engine with the reference's per-stage
  objects (:class:`.motion_filter.MotionFilter`,
  :class:`.frontend.DroidFrontend` and its :class:`.factor_graph.FactorGraph`)
  over a live :class:`.video.VideoState`, about three blocking reads per
  frame; ``terminate`` runs on that video, once.

``visualize=True`` starts a :class:`..utils.visualization.VisualizerThread`
(an Open3D window where open3d imports, headless otherwise). The sharded BA
is a later slice of the port (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import copy
import warnings
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..models.droid_net import DroidNet, init_params
from ..models.weights import load_weights
from ..ops import lie
from . import fused as fused_step
from .backend import DroidBackend
from .config import DroidConfig
from .frontend import DroidFrontend
from .motion_filter import MotionFilter
from .trajectory_filler import PoseTrajectoryFiller
from .video import VideoState, _depth_to_disp_sens

# what the visualiser's point cloud reads of the fused state
_VIEW_BUFFERS = ("tstamp", "images", "poses", "disps", "intrinsics")
_TRACKING_BUFFERS = ("disps_sens", "fmaps", "nets", "inps")


def resolve_device(device=None) -> torch.device:
    """The tracking device: CUDA unless the caller names another. Without a
    CUDA device and without an explicit device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "droid_slam_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


class Droid:
    """Per-frame tracking, global BA and trajectory fill at the end.

    ``params`` is a state dict for :class:`DroidNet` (from
    :func:`..models.weights.params_from_jax` or :func:`init_params`);
    without it, ``weights`` names a weights file
    (:func:`..models.weights.load_weights`: the JAX package's ``.msgpack``
    or a reference ``.pth``); with neither, random ``init_params(0)``.
    ``fused`` picks the tracking engine (module docstring); the host engine
    keeps the JAX package's dtypes: f32 encoders, probe, video features and
    per-edge hidden state, with only the update operator in
    ``config.compute_dtype``.
    """

    def __init__(
        self,
        config: DroidConfig,
        params: Optional[Dict[str, torch.Tensor]] = None,
        weights: Optional[str] = None,
        device=None,
        fused: bool = True,
        visualize: bool = False,
        vis_refresh_hz: float = 2.0,
    ):
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            params = load_weights(weights) if weights is not None else init_params(0)
        net = DroidNet()
        net.load_state_dict(params)
        self.net = net.to(self.device).eval()
        cdt = getattr(torch, config.compute_dtype)
        self._update_op = (
            self.net.update if cdt == torch.float32 else copy.deepcopy(self.net.update).to(cdt)
        )
        self.fused = fused
        if fused:
            self._state = fused_step.init_state(config, self.device)
            self._track_step = fused_step.build_track_step(self.net, config)
            self.video: Optional[VideoState] = None  # copied out by terminate and the visualiser
        else:
            self.video = VideoState(config, self.device)
            self.filterx = MotionFilter(self.net, self.video, thresh=config.filter_thresh)
            self.frontend = DroidFrontend(self._update_op, self.video, config)
        # (edges, update-operator chunks per step) of terminate's two
        # global-BA passes
        self.backend_runs: List[Tuple[int, int]] = []

        self.visualizer = None
        if visualize:
            from ..utils.visualization import VisualizerThread

            self.visualizer = VisualizerThread(self, refresh_hz=vis_refresh_hz, open_window=True)

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None) -> None:
        """Track one frame: image [H, W, 3] (or [1, H, W, 3]) uint8 RGB, in
        stereo the pair [2, H, W, 3] (left, right); intrinsics [4] at full
        resolution, optional depth [H, W]."""
        img = torch.as_tensor(image, device=self.device)
        if img.dim() == 3:
            img = img[None]
        rig = 2 if self.config.stereo else 1
        if img.dim() != 4 or img.shape[0] != rig:
            raise ValueError(f"expected {rig} image(s) [H, W, 3] per frame, got {tuple(img.shape)}")
        intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=self.device)
        if not self.fused:
            dep = None if depth is None else torch.as_tensor(depth, device=self.device)
            self.filterx.track(float(tstamp), img, dep, intr)
            self.frontend()
            return
        h, w = self.config.feat_size
        if depth is not None:
            sens = _depth_to_disp_sens(torch.as_tensor(depth, device=self.device), h, w)
        else:
            sens = torch.zeros((h, w), device=self.device)
        self._track_step(self._state, float(tstamp), img, intr, sens)

    def sync(self) -> None:
        """Block until the queued tracking work has finished on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- read access to the tracking state (either engine) ----

    def _buffers(self):
        return self._state if self.fused else self.video

    @property
    def counter(self) -> int:
        """Number of keyframes."""
        return self._buffers().counter

    @property
    def tstamps(self) -> torch.Tensor:
        return self._buffers().tstamp[: self.counter]

    @property
    def poses(self) -> torch.Tensor:
        """World→camera keyframe poses [counter, 7] as (t, q_xyzw)."""
        return self._buffers().poses[: self.counter]

    @property
    def disps(self) -> torch.Tensor:
        """Keyframe inverse depths [counter, h, w] at 1/8 resolution."""
        return self._buffers().disps[: self.counter]

    @staticmethod
    def _edge_set(ii, jj, valid) -> Set[Tuple[int, int]]:
        return {(int(i), int(j)) for i, j, v in zip(ii.tolist(), jj.tolist(), valid.tolist()) if v}

    @property
    def edges(self) -> Set[Tuple[int, int]]:
        """Active factor-graph edges (i, j) of the tracking engine."""
        if self.fused:
            st = self._state
            return self._edge_set(st.ii, st.jj, st.valid)
        g = self.frontend.graph
        return self._edge_set(g.ii, g.jj, g.valid)

    @property
    def inactive_edges(self) -> Set[Tuple[int, int]]:
        """Edges retired to the inactive store."""
        if self.fused:
            st = self._state
            return self._edge_set(st.inac_ii, st.inac_jj, st.inac_valid)
        g = self.frontend.graph
        return self._edge_set(g.ii_inac, g.jj_inac, g.valid_inac)

    def _sync_fused_state(self, view_only: bool = False) -> VideoState:
        """Copy the fused engine's tracked state into a fresh
        :class:`VideoState` with every keyframe marked dirty. The buffers
        are copies, not aliases: terminate may run more than once, and each
        run starts again from the tracked state. ``view_only`` copies just
        what the visualiser's point cloud reads (poses, disps, images,
        tstamp, intrinsics), not the features."""
        st = self._state
        v = VideoState.__new__(VideoState)  # no default buffers: all are copied in
        v.config = self.config
        v.counter = st.counter
        if v.counter >= st.poses.shape[0] and not view_only:
            warnings.warn(
                f"keyframe buffer saturated ({v.counter}/{st.poses.shape[0]}): later "
                "keyframes were dropped; rerun with a larger DroidConfig.buffer",
                RuntimeWarning,
            )
        for name in _VIEW_BUFFERS + (() if view_only else _TRACKING_BUFFERS):
            setattr(v, name, getattr(st, name).clone())
        v.disps_up = st.disps_up.clone() if self.config.upsample else None
        v.dirty = np.zeros(st.poses.shape[0], bool)
        v.dirty[: v.counter] = True
        self.video = v
        return v

    @torch.no_grad()
    def terminate(self, stream=None) -> np.ndarray:
        """Global BA (7 then 12 steps) and, with ``stream`` (yielding
        (tstamp, image, intrinsics) for every frame), the trajectory fill.
        Returns camera-to-world poses [T, 7] as (t, q_xyzw): the keyframes'
        without a stream, every stream frame's with one. The fused engine
        works on a copy of its state; the host engine retires its frontend
        and optimises its live video."""
        # stop the visualiser before global BA: in fused mode its poll would
        # replace the video with the tracked state between backend steps
        if self.visualizer is not None:
            self.visualizer.close()
        if self.fused:
            v = self._sync_fused_state()
        else:
            del self.frontend
            v = self.video
        backend = DroidBackend(self._update_op, v, self.config)
        self.backend_runs = [backend(7), backend(12)]
        # one refresh of the optimised map for the visualiser's consumers
        if self.visualizer is not None:
            self.visualizer.final_update()
        if stream is not None:
            return PoseTrajectoryFiller(self.net, self._update_op, v, self.config)(stream)
        return lie.inv(v.poses[: v.counter]).cpu().numpy()
