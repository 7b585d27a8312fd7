"""Droid: the SLAM system facade of the port.

Counterpart of the JAX package's ``runtime/droid.py`` in its default fused
engine: ``track()`` runs the motion filter and the frontend for one input
frame on the tracking device; ``terminate()`` runs the global backend
twice (7 then 12 steps) on a copy of the tracked state and returns the
keyframe trajectory, or with a stream the trajectory of every frame. The
host-driven engine, stereo and the sharded BA are later slices of the port
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import copy
import warnings
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..models.droid_net import DroidNet, init_params
from ..ops import lie
from . import fused
from .backend import DroidBackend
from .config import DroidConfig
from .trajectory_filler import PoseTrajectoryFiller
from .video import VideoState, _depth_to_disp_sens


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
    """Per-frame tracking with the fused engine, global BA and trajectory
    fill at the end.

    ``params`` is a state dict for :class:`DroidNet` (from
    :func:`..models.weights.params_from_jax` or :func:`init_params`); it
    defaults to ``init_params(0)``.
    """

    def __init__(
        self,
        config: DroidConfig,
        params: Optional[Dict[str, torch.Tensor]] = None,
        device=None,
    ):
        if config.stereo:
            raise NotImplementedError("stereo tracking is a later slice of the port")
        self.config = config
        self.device = resolve_device(device)
        net = DroidNet()
        net.load_state_dict(init_params(0) if params is None else params)
        self.net = net.to(self.device).eval()
        self._state = fused.init_state(config, self.device)
        self._track_step = fused.build_track_step(self.net, config)
        cdt = getattr(torch, config.compute_dtype)
        self._update_op = (
            self.net.update if cdt == torch.float32 else copy.deepcopy(self.net.update).to(cdt)
        )
        self.video: Optional[VideoState] = None  # made by terminate
        # (edges, update-operator chunks per step) of terminate's two
        # global-BA passes
        self.backend_runs: List[Tuple[int, int]] = []

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None) -> None:
        """Track one frame: image [H, W, 3] (or [1, H, W, 3]) uint8 RGB,
        intrinsics [4] at full resolution, optional depth [H, W]."""
        img = torch.as_tensor(image, device=self.device)
        if img.dim() == 3:
            img = img[None]
        h, w = self.config.feat_size
        if depth is not None:
            sens = _depth_to_disp_sens(torch.as_tensor(depth, device=self.device), h, w)
        else:
            sens = torch.zeros((h, w), device=self.device)
        intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=self.device)
        self._track_step(self._state, float(tstamp), img, intr, sens)

    def sync(self) -> None:
        """Block until the queued tracking work has finished on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- read access to the tracking state ----

    @property
    def counter(self) -> int:
        """Number of keyframes."""
        return self._state.counter

    @property
    def tstamps(self) -> torch.Tensor:
        return self._state.tstamp[: self.counter]

    @property
    def poses(self) -> torch.Tensor:
        """World→camera keyframe poses [counter, 7] as (t, q_xyzw)."""
        return self._state.poses[: self.counter]

    @property
    def disps(self) -> torch.Tensor:
        """Keyframe inverse depths [counter, h, w] at 1/8 resolution."""
        return self._state.disps[: self.counter]

    @staticmethod
    def _edge_set(ii, jj, valid) -> Set[Tuple[int, int]]:
        return {(int(i), int(j)) for i, j, v in zip(ii.tolist(), jj.tolist(), valid.tolist()) if v}

    @property
    def edges(self) -> Set[Tuple[int, int]]:
        """Active factor-graph edges (i, j)."""
        st = self._state
        return self._edge_set(st.ii, st.jj, st.valid)

    @property
    def inactive_edges(self) -> Set[Tuple[int, int]]:
        """Edges retired to the inactive store."""
        st = self._state
        return self._edge_set(st.inac_ii, st.inac_jj, st.inac_valid)

    def _sync_fused_state(self) -> VideoState:
        """Copy the tracked state into a fresh :class:`VideoState` for the
        backend and the trajectory filler. The buffers are copies, not
        aliases: terminate may run more than once, and each run starts again
        from the tracked state."""
        st = self._state
        v = VideoState.__new__(VideoState)  # no default buffers: all are copied in
        v.config = self.config
        v.counter = st.counter
        if v.counter >= st.poses.shape[0]:
            warnings.warn(
                f"keyframe buffer saturated ({v.counter}/{st.poses.shape[0]}): later "
                "keyframes were dropped; rerun with a larger DroidConfig.buffer",
                RuntimeWarning,
            )
        for name in ("tstamp", "images", "poses", "disps", "disps_sens", "intrinsics",
                     "fmaps", "nets", "inps"):
            setattr(v, name, getattr(st, name).clone())
        v.disps_up = st.disps_up.clone() if self.config.upsample else None
        self.video = v
        return v

    @torch.no_grad()
    def terminate(self, stream=None) -> np.ndarray:
        """Global BA (7 then 12 steps) and, with ``stream`` (yielding
        (tstamp, image, intrinsics) for every frame), the trajectory fill.
        Returns camera-to-world poses [T, 7] as (t, q_xyzw): the keyframes'
        without a stream, every stream frame's with one."""
        v = self._sync_fused_state()
        backend = DroidBackend(self._update_op, v, self.config)
        self.backend_runs = [backend(7), backend(12)]
        if stream is not None:
            return PoseTrajectoryFiller(self.net, self._update_op, v, self.config)(stream)
        return lie.inv(v.poses[: v.counter]).cpu().numpy()
