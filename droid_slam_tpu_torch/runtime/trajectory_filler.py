"""Pose trajectory filler: poses of the frames that are not keyframes
(PyTorch).

Counterpart of the JAX package's ``runtime/trajectory_filler.py``: per
batch of 16 frames, interpolate SE(3) poses in log space between the
bracketing keyframes, extract matching features, append the frames to the
video for the moment, attach each to its two bracketing keyframes, and run
6 motion-only operator iterations (trajectory_filler.py:50-72).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

from ..ops import lie
from .factor_graph import FactorGraph
from .video import _set_range


class PoseTrajectoryFiller:
    """``net`` is the :class:`..models.droid_net.DroidNet` (its f32 fnet
    encodes the frames); ``update_op`` its update operator in the compute
    dtype."""

    def __init__(self, net, update_op, video, config):
        self.net = net
        self.update_op = update_op
        self.video = video
        self.config = config

    def _fill(self, tstamps: List[float], images: List, intrinsics: List, ts: np.ndarray) -> torch.Tensor:
        v = self.video
        dev = v.poses.device
        N = v.counter
        M = len(tstamps)
        if N + M > v.poses.shape[0]:
            raise ValueError(f"fill batch {M} does not fit the buffer past {N} keyframes")

        tt = np.asarray(tstamps, np.float32)

        # bracketing keyframe indices
        t0 = np.asarray([np.sum(ts <= t) - 1 for t in tt], np.int64)
        t0 = np.clip(t0, 0, N - 1)
        t1 = np.where(t0 < N - 1, t0 + 1, t0)

        # linear SE(3) interpolation in log space
        Ps = v.poses[:N]
        i0 = torch.as_tensor(t0, device=dev)
        i1 = torch.as_tensor(t1, device=dev)
        dt = torch.as_tensor(ts[t1] - ts[t0] + 1e-3, device=dev)
        dP = lie.mul(Ps[i1], lie.inv(Ps[i0]))
        w = lie.log(dP) / dt[:, None] * torch.as_tensor(tt - ts[t0], device=dev)[:, None]
        Gs = lie.mul(lie.exp(w), Ps[i0])  # [M, 7]

        # matching features (f32 fnet) + temporary appends
        imgs = torch.as_tensor(np.stack([img[0] if img.ndim == 4 else img for img in images]),
                               device=dev)  # [M, H, W, 3], the monocular path
        fmaps = self.net.features(imgs)  # [M, h, w, 128]
        h, w_ = self.config.feat_size
        intr = torch.as_tensor(np.stack(intrinsics), dtype=torch.float32, device=dev) / 8.0
        _set_range(v.tstamp, N, torch.as_tensor(tt, device=dev))
        _set_range(v.poses, N, Gs)
        _set_range(v.disps, N, torch.ones((M, h, w_), device=dev))
        _set_range(v.intrinsics, N, intr)
        # the left image's slot only, as in the JAX package: the filler adds
        # no self edges, so a stereo video's right slot is never read
        _set_range(v.fmaps[:, 0], N, fmaps)
        v.counter = N + M

        graph = FactorGraph(
            v,
            self.update_op,
            max_factors=max(2 * M, 32),
            edge_pad=max(2 * M, 32),  # exactly 2M edges are added
            inactive_pad=8,
            window_pad=max(32, M),
        )
        graph.add_factors(t0, np.arange(N, N + M))
        graph.add_factors(t1, np.arange(N, N + M))
        for _ in range(6):
            graph.update(N, N + M, motion_only=True)

        out = v.poses[N : N + M].clone()
        v.counter = N  # pop the temporary frames
        return out

    @torch.no_grad()
    def __call__(self, image_stream: Iterable) -> np.ndarray:
        """image_stream yields (tstamp, image [H, W, 3] uint8, intrinsics
        [4]). Returns the camera-to-world poses [T, 7] of the stream's
        frames."""
        v = self.video
        pose_list = []
        tstamps, images, intrinsics = [], [], []
        ts = v.tstamp[: v.counter].cpu().numpy()
        # temporary frames append past the live keyframes
        batch = min(16, v.poses.shape[0] - v.counter)
        if batch < 1:
            raise ValueError(
                f"trajectory filler needs >= 1 free keyframe slot but the buffer is full "
                f"({v.counter}); increase DroidConfig.buffer"
            )
        for tstamp, image, intrinsic in image_stream:
            tstamps.append(tstamp)
            images.append(image)
            intrinsics.append(intrinsic)
            if len(tstamps) == batch:
                pose_list.append(self._fill(tstamps, images, intrinsics, ts))
                tstamps, images, intrinsics = [], [], []
        if tstamps:
            # the trailing batch is padded to the full batch by repeating its
            # last frame, as the JAX package does (there for compile reuse);
            # the padded rows are dropped
            n_tail = len(tstamps)
            while len(tstamps) < batch:
                tstamps.append(tstamps[-1])
                images.append(images[-1])
                intrinsics.append(intrinsics[-1])
            pose_list.append(self._fill(tstamps, images, intrinsics, ts)[:n_tail])

        return lie.inv(torch.cat(pose_list)).cpu().numpy()
