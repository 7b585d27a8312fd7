"""Geometry of the map visualisation: back-projection, reprojection maps and
the multi-view depth-consistency count (PyTorch).

Counterpart of the JAX package's ``ops/vis_ops.py`` (the reference's
``iproj``, ``projmap`` and ``depth_filter``, droid_kernels_cpu.cc:304-666),
used by :mod:`..utils.visualization`. The JAX package computes them in XLA,
with no Pallas kernel; here they are plain PyTorch on any device.
"""

from __future__ import annotations

import torch

from . import lie
from . import projective as pops

Tensor = torch.Tensor

# neighbours of keyframe ix that the consistency count looks at
DEPTH_FILTER_OFFSETS = (-1, -2, -3, 3, 4, 5)


def iproj_points(poses: Tensor, disps: Tensor, intrinsics0: Tensor) -> Tensor:
    """Every pixel of every frame back-projected to world points
    (droid_kernels_cpu.cc:602-666): poses [F, 7] world→camera, disps
    [F, H, W], intrinsics0 [4] → [F, H, W, 3]."""
    F = poses.shape[0]
    X0 = pops.iproj(disps, intrinsics0.expand(F, 4))  # (X, Y, 1, d)
    X1 = lie.act(lie.inv(poses)[:, None, None, :], X0)
    return X1[..., :3] / X1[..., 3:4].clamp(min=1e-8)


def projmap(poses: Tensor, disps: Tensor, intrinsics0: Tensor, ii: Tensor, jj: Tensor):
    """Reprojection coordinates with the projected inverse depth, and the
    validity, per edge ii → jj (droid_kernels_cpu.cc:304-385): (coords
    [N, H, W, 3], valid [N, H, W, 1])."""
    F = poses.shape[0]
    return pops.projective_transform(
        poses, disps, intrinsics0.expand(F, 4), ii, jj, return_depth=True,
        min_depth=pops.MIN_DEPTH_NATIVE,
    )


def depth_filter(poses: Tensor, disps: Tensor, intrinsics0: Tensor, inds: Tensor,
                 thresh: Tensor) -> Tensor:
    """Multi-view inverse-depth consistency count (droid_kernels_cpu.cc:498-598).

    Each pixel of each frame ix in ``inds`` is reprojected into the
    keyframes ix−1, ix−2, ix−3, ix+3, ix+4, ix+5 among the F frames given; a
    neighbour agrees when any of the 4 pixels around the reprojection has
    |1/d_proj − 1/d_corner| < thresh[ix] (a neighbour outside the frames or
    a reprojection outside the map never agrees). poses [F, 7], disps
    [F, H, W], intrinsics0 [4], inds [n] int64, thresh [n] → counts
    [n, H, W] f32.
    """
    F, ht, wd = disps.shape
    fx, fy, cx, cy = intrinsics0.unbind(-1)
    n = inds.shape[0]
    k = len(DEPTH_FILTER_OFFSETS)
    off = torch.tensor(DEPTH_FILTER_OFFSETS, device=inds.device)
    ix = inds[:, None].expand(n, k).reshape(-1)
    jx = (inds[:, None] + off).reshape(-1)
    ok_pair = (jx >= 0) & (jx < F)
    jxc = jx.clamp(0, F - 1)

    Gij = pops.relative_poses(poses, ix, jxc)
    X0 = pops.iproj(disps[ix], intrinsics0.expand(n * k, 4))
    X1 = lie.act(Gij[:, None, None, :], X0)
    Z = X1[..., 2]
    uj = fx * X1[..., 0] / Z + cx
    vj = fy * X1[..., 1] / Z + cy
    dj = X1[..., 3] / Z

    # floor(u) in [0, wd − 1) is u in [0, wd − 1): NaN and ±inf land outside
    inb = (uj >= 0) & (vj >= 0) & (uj < wd - 1) & (vj < ht - 1)
    u0 = torch.floor(uj.nan_to_num(0.0).clamp(0, wd - 2)).long()
    v0 = torch.floor(vj.nan_to_num(0.0).clamp(0, ht - 2)).long()

    dmap = disps[jxc].reshape(n * k, ht * wd)
    inv_dj = 1.0 / dj.clamp(min=1e-8)
    t = thresh[:, None].expand(n, k).reshape(-1, 1, 1)
    agree = torch.zeros_like(inb)
    for dv in (0, 1):
        for du in (0, 1):
            idx = ((v0 + dv) * wd + (u0 + du)).reshape(n * k, -1)
            corner = torch.gather(dmap, 1, idx).reshape(n * k, ht, wd)
            agree = agree | ((inv_dj - 1.0 / corner.clamp(min=1e-8)).abs() < t)
    counts = (inb & ok_pair[:, None, None] & agree).float()
    return counts.reshape(n, k, ht, wd).sum(dim=1)
