"""Keyframe buffer and its helpers (PyTorch).

Counterpart of the JAX package's ``runtime/video.py``: the RGB-D prior, the
masked frame distance behind proximity edge selection and the keyframe cull
test, the padded window read/write used for the per-keyframe damping, and
:class:`VideoState`, the keyframe buffers that the host-driven engine
appends to and that the global backend and the trajectory filler work on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import lie
from ..ops import projective as pops

Tensor = torch.Tensor


def _depth_to_disp_sens(depth: Tensor, ht: int, wd: int) -> Tensor:
    """Input depth [H, W] → inverse-depth prior at 1/8 res (3::8 sampling)."""
    d = depth[3::8, 3::8][:ht, :wd].float()
    return torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))


def _frame_distance(
    poses: Tensor, disps: Tensor, intrinsics0: Tensor, ii: Tensor, jj: Tensor, beta: float
) -> Tensor:
    """Mean induced-flow magnitude per frame pair, blending full-SE3 flow
    with translation-only flow by beta; 1000.0 where fewer than 75% of the
    pixels land in front of the camera (src/droid_kernels_cpu.cc:389-472).
    ii/jj [M] int64 in range → [M]."""
    ht, wd = disps.shape[-2:]
    grid = pops.coords_grid(ht, wd, device=disps.device)

    Gij = pops.relative_poses(poses, ii, jj)
    X0 = pops.iproj(disps[ii], intrinsics0.expand(ii.shape + (4,)))
    fx, fy, cx, cy = intrinsics0.unbind(-1)

    def flow_mag(X1):
        Z = X1[..., 2]
        # guard the division as the reference kernel does (it accumulates
        # only inside its Z > MIN_DEPTH branch): an unguarded Z == 0 gives
        # inf * 0 = NaN, which poisons every later min / compare
        Zs = torch.where(Z < 0.5 * pops.MIN_DEPTH_NATIVE, torch.ones_like(Z), Z)
        u = fx * X1[..., 0] / Zs + cx
        v = fy * X1[..., 1] / Zs + cy
        d = torch.sqrt((u - grid[..., 0]) ** 2 + (v - grid[..., 1]) ** 2)
        ok = (Z > pops.MIN_DEPTH_NATIVE).to(d.dtype)
        return d, ok

    d1, ok1 = flow_mag(lie.act(Gij[:, None, None, :], X0))
    X1t = torch.cat(
        [X0[..., :3] + X0[..., 3:4] * lie.translation(Gij)[:, None, None, :], X0[..., 3:]], dim=-1
    )
    d2, ok2 = flow_mag(X1t)

    accum = beta * (d1 * ok1).sum(dim=(1, 2)) + (1 - beta) * (d2 * ok2).sum(dim=(1, 2))
    valid = beta * ok1.sum(dim=(1, 2)) + (1 - beta) * ok2.sum(dim=(1, 2))
    frac = valid / (float(ht * wd) + 1e-8)
    return torch.where(frac < 0.75, torch.full_like(accum, 1000.0), accum / valid.clamp(min=1e-8))


def read_window(buf: Tensor, kf0: Tensor, K: int) -> Tensor:
    """buf[kf0 : kf0+K] with zero padding past the end (K static)."""
    pad = torch.cat([buf, buf.new_zeros((K,) + buf.shape[1:])])
    return pad[kf0.clamp(0, buf.shape[0]) + torch.arange(K, device=buf.device)]


def persist_window(buf: Tensor, new_win: Tensor, touched: Tensor, kf0: Tensor) -> Tensor:
    """Write new_win into buf[kf0 : kf0+K] at frames where ``touched``,
    keeping untouched frames; rows past the end of buf are dropped."""
    K = new_win.shape[0]
    pad = torch.cat([buf, buf.new_zeros((K,) + buf.shape[1:])])
    rows = kf0.clamp(0, buf.shape[0]) + torch.arange(K, device=buf.device)
    t = touched.reshape((K,) + (1,) * (buf.dim() - 1))
    pad[rows] = torch.where(t, new_win.to(buf.dtype), pad[rows])
    return pad[: buf.shape[0]]


def _set_range(buf: Tensor, start: int, values: Tensor) -> None:
    """buf[start : start + len(values)] = values in place, cast to buf's
    dtype; rows past the end of buf are dropped."""
    n = max(min(values.shape[0], buf.shape[0] - start), 0)
    buf[start : start + n] = values[:n].to(buf.dtype)


def _normalize(poses: Tensor, disps: Tensor, count: int):
    """Fix the monocular gauge: unit mean inverse depth over the first
    ``count`` frames (depth_video.py:132-139)."""
    s = disps[:count].sum() / (max(count, 1) * disps.shape[1] * disps.shape[2])
    poses = poses.clone()
    disps = disps.clone()
    disps[:count] = disps[:count] / s
    poses[:count, :3] = poses[:count, :3] * s
    return poses, disps


class VideoState:
    """The keyframe buffers of one device (depth_video.py:24-45 layout).

    Buffers are plain tensors that the engines, the backend and the
    trajectory filler update in place (a factor graph's captured steps
    replay against their storage): tstamp [B], images
    [B, H, W, 3] uint8, poses [B, 7] world→camera (t, q_xyzw), disps /
    disps_sens [B, h, w], intrinsics [B, 4] at 1/8 resolution, fmaps
    [B, rig, h, w, 128] (rig 2 in stereo: left, right), nets / inps
    [B, h, w, 128], disps_up [B, H, W]; all float buffers are f32.
    ``counter`` is the host-side keyframe count and ``dirty`` [B] the host
    flags that mark keyframes the visualiser has not drawn since they
    changed.
    """

    def __init__(self, config, device):
        B = config.buffer
        H, W = config.image_size
        h, w = config.feat_size
        self.config = config
        self.counter = 0
        self.dirty = np.zeros(B, bool)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.tstamp = zeros(B)
        self.images = zeros(B, H, W, 3, dtype=torch.uint8)
        self.poses = lie.identity((B,), device=device)
        self.disps = torch.ones((B, h, w), device=device)
        self.disps_sens = zeros(B, h, w)
        self.disps_up = zeros(B, H, W)
        self.intrinsics = zeros(B, 4)
        self.fmaps = zeros(B, 2 if config.stereo else 1, h, w, 128)
        self.nets = zeros(B, h, w, 128)
        self.inps = zeros(B, h, w, 128)

    # ------------------------------------------------------------------ state

    def append(self, tstamp: float, image: Tensor, pose: Optional[Tensor], disp: Optional[float],
               depth: Optional[Tensor], intrinsics: Tensor, fmap: Tensor, net: Tensor,
               inp: Tensor) -> int:
        """Write a new keyframe at the counter (depth_video.py:109-112):
        image [H, W, 3] or [rig, H, W, 3] (the left one is stored),
        intrinsics [4] at 1/8 resolution, fmap [rig, h, w, 128], net / inp
        [h, w, 128]; each value is cast to its buffer's dtype. Without
        ``pose`` / ``disp`` the slot keeps what the motion model wrote
        there. Returns the slot. Raises when the buffer is full."""
        ix = self.counter
        if ix >= self.poses.shape[0]:
            raise RuntimeError(f"keyframe buffer full ({ix}); increase DroidConfig.buffer")
        self.tstamp[ix] = float(tstamp)
        self.images[ix] = (image[0] if image.dim() == 4 else image).to(torch.uint8)
        if pose is not None:
            self.poses[ix] = pose
        if disp is not None:
            self.disps[ix] = disp
        if depth is not None:
            h, w = self.config.feat_size
            self.disps_sens[ix] = _depth_to_disp_sens(depth, h, w)
        self.intrinsics[ix] = intrinsics.to(self.intrinsics.dtype)
        self.fmaps[ix] = fmap.to(self.fmaps.dtype)
        self.nets[ix] = net.to(self.nets.dtype)
        self.inps[ix] = inp.to(self.inps.dtype)
        self.counter = ix + 1
        self.dirty[ix] = True
        return ix

    def set_pose(self, ix: int, pose: Tensor) -> None:
        """poses[ix] = pose; a slot past the buffer is dropped, as the JAX
        package's scatter drops it (the motion model seeds the slot after
        the last keyframe)."""
        if ix < self.poses.shape[0]:
            self.poses[ix] = pose

    def set_disp(self, ix: int, disp) -> None:
        """disps[ix] = disp (a map or a scalar); a slot past the buffer is
        dropped."""
        if ix < self.disps.shape[0]:
            self.disps[ix] = disp

    # -------------------------------------------------------------- geometry

    def reproject(self, ii, jj) -> Tuple[Tensor, Tensor]:
        """Map the pixels of keyframes ii into keyframes jj
        (depth_video.py:142-150): (coords [N, h, w, 2], valid [N, h, w, 1])."""
        dev = self.poses.device
        ii = torch.as_tensor(np.asarray(ii, np.int64).reshape(-1), device=dev)
        jj = torch.as_tensor(np.asarray(jj, np.int64).reshape(-1), device=dev)
        return pops.projective_transform(self.poses, self.disps, self.intrinsics, ii, jj)

    def distance(self, ii, jj, beta: float = 0.3, bidirectional: bool = True) -> np.ndarray:
        """Flow-magnitude distance between keyframe pairs
        (depth_video.py:152-188) as a host array. Pairs go to the device in
        chunks of 4096: the query materialises [pairs, h, w, 4]
        intermediates, and the backend's all-pairs query grows as t²."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        chunk = 4096
        dev = self.poses.device
        out = []
        for s in range(0, len(ii), chunk):
            i = torch.as_tensor(ii[s : s + chunk], device=dev)
            j = torch.as_tensor(jj[s : s + chunk], device=dev)
            d = _frame_distance(self.poses, self.disps, self.intrinsics[0], i, j, beta)
            if bidirectional:
                d = 0.5 * (d + _frame_distance(self.poses, self.disps, self.intrinsics[0], j, i, beta))
            out.append(d.cpu().numpy())
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def distance_matrix(self, t: int, beta: float = 0.3) -> np.ndarray:
        ii, jj = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
        return self.distance(ii.reshape(-1), jj.reshape(-1), beta=beta).reshape(t, t)

    def normalize(self) -> None:
        """Fix the monocular gauge, in the buffers' own storage."""
        poses, disps = _normalize(self.poses, self.disps, self.counter)
        self.poses.copy_(poses)
        self.disps.copy_(disps)
        self.dirty[: self.counter] = True
