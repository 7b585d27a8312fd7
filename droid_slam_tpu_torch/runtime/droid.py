"""Droid: the SLAM system facade of the port (per-frame tracking).

Counterpart of the JAX package's ``runtime/droid.py`` in its default fused
engine: ``track()`` runs the motion filter and the frontend for one input
frame on the tracking device. Global BA at terminate, the trajectory
filler, the host-driven engine and stereo are later slices of the port
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import torch

from ..models.droid_net import DroidNet, init_params
from . import fused
from .config import DroidConfig
from .video import _depth_to_disp_sens


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
    """Per-frame tracking with the fused engine.

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

    def terminate(self, stream=None):
        raise NotImplementedError(
            "Droid.terminate (global BA, trajectory fill) is ROADMAP.md queue 1 "
            "item 8 of the port, not yet ported"
        )
