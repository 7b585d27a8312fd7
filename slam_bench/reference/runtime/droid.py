"""Droid: the SLAM system facade of the port, as the reference runs it.

Counterpart of the port's ``runtime/droid.py`` with its fused engine only:
``track()`` runs the per-frame step of :mod:`.fused` for one input frame
(monocular, RGB-D or a stereo pair), all state in one device structure,
eagerly, reading each branch's predicate on the host (at most 3 reads per
frame). Departures from the port: nothing is captured (the port replays
the step as a CUDA graph from the first frame after initialisation on);
the host-driven engine (``fused=False``), ``terminate``, the sharded
global BA and the visualiser are not copied, since no cell of the
benchmark runs them.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import torch

from ..models.droid_net import DroidNet, init_params
from ..models.weights import load_weights
from . import fused as fused_step
from .config import DroidConfig
from .video import _depth_to_disp_sens


def resolve_device(device=None) -> torch.device:
    """The tracking device: CUDA unless the caller names another. Without a
    CUDA device and without an explicit device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


class Droid:
    """Per-frame tracking with the fused step.

    ``params`` is a state dict for :class:`DroidNet`; without it,
    ``weights`` names a weights file (:func:`..models.weights.load_weights`);
    with neither, random ``init_params(0)``. The update operator runs in
    ``config.compute_dtype``, the encoders, probe and geometry in f32.
    """

    def __init__(
        self,
        config: DroidConfig,
        params: Optional[Dict[str, torch.Tensor]] = None,
        weights: Optional[str] = None,
        device=None,
    ):
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            params = load_weights(weights) if weights is not None else init_params(0)
        net = DroidNet()
        net.load_state_dict(params)
        self.net = net.to(self.device).eval()
        # host copy of the state's is_init, read after each frame until init ran
        self._initialized = False
        self._state = fused_step.init_state(config, self.device)
        self._track_step = fused_step.build_track_step(self.net, config)

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
        h, w = self.config.feat_size
        if depth is not None:
            sens = _depth_to_disp_sens(torch.as_tensor(depth, device=self.device), h, w)
        else:
            sens = torch.zeros((h, w), device=self.device)
        st = self._state
        ts = torch.full((), float(tstamp), device=self.device)
        self._track_step(st, ts, img, intr, sens, initialized=self._initialized)
        if not self._initialized:
            self._initialized = bool(st.is_init)

    def sync(self) -> None:
        """Block until the queued tracking work has finished on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- read access to the tracking state ----

    def _buffers(self):
        return self._state

    @property
    def counter(self) -> int:
        """Number of keyframes (a host read of the fused state's count)."""
        return int(self._buffers().counter)

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
        st = self._state
        return self._edge_set(st.ii, st.jj, st.valid)

    @property
    def inactive_edges(self) -> Set[Tuple[int, int]]:
        """Edges retired to the inactive store."""
        st = self._state
        return self._edge_set(st.inac_ii, st.inac_jj, st.inac_valid)
