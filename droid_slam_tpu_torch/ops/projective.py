"""Projective camera geometry with analytic Jacobians (PyTorch).

Counterpart of the JAX package's ``ops/projective.py``. Conventions:
  * poses are world→camera SE(3) as (..., 7) = [t, q_xyzw]
  * points are homogeneous (X, Y, Z, d) with d the inverse depth of the
    source pixel; the source z-component is always 1
  * intrinsics are [fx, fy, cx, cy] at the operating (1/8) resolution
  * pose Jacobians are [..., 2, 6] with columns (tx, ty, tz, wx, wy, wz)
  * stereo self edges (ii == jj) use the fixed rig baseline
    G_ij = [(−0.1, 0, 0), identity]
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import lie

Tensor = torch.Tensor

MIN_DEPTH = 0.2  # training-path threshold (geom/projective_ops.py:6)
MIN_DEPTH_NATIVE = 0.25  # SLAM-runtime threshold (src/droid_kernels.h:13)

STEREO_BASELINE = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def coords_grid(ht: int, wd: int, dtype=torch.float32, device=None) -> Tensor:
    """Pixel coordinate grid [ht, wd, 2] holding (x, y)."""
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=dtype, device=device),
        torch.arange(wd, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)


def iproj(disps: Tensor, intrinsics: Tensor) -> Tensor:
    """Pinhole inverse projection: disps [..., H, W], intrinsics [..., 4] →
    homogeneous points [..., H, W, 4] = (X, Y, 1, d)."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics[..., None, None, :].unbind(-1)
    grid = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    X = ((grid[..., 0] - cx) / fx).expand(disps.shape)
    Y = ((grid[..., 1] - cy) / fy).expand(disps.shape)
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def proj(
    Xs: Tensor,
    intrinsics: Tensor,
    jacobian: bool = False,
    return_depth: bool = False,
    min_depth: float = MIN_DEPTH,
) -> Tuple[Tensor, Optional[Tensor]]:
    """Pinhole projection of homogeneous points Xs [..., H, W, 4] →
    coords [..., H, W, 2 (or 3)] and optionally the 2×4 Jacobian."""
    fx, fy, cx, cy = intrinsics[..., None, None, :].unbind(-1)
    X, Y, Z, D = Xs.unbind(-1)

    Z = torch.where(Z < 0.5 * min_depth, torch.ones_like(Z), Z)
    d = 1.0 / Z

    x = fx * (X * d) + cx
    y = fy * (Y * d) + cy
    if return_depth:
        coords = torch.stack([x, y, D * d], dim=-1)
    else:
        coords = torch.stack([x, y], dim=-1)

    if not jacobian:
        return coords, None

    o = torch.zeros_like(d)
    fxd = (fx * d).expand_as(d)
    fyd = (fy * d).expand_as(d)
    Jp = torch.stack(
        [fxd, o, -fx * X * d * d, o, o, fyd, -fy * Y * d * d, o], dim=-1
    ).reshape(Xs.shape[:-1] + (2, 4))
    return coords, Jp


def actp(Gij: Tensor, X0: Tensor, jacobian: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """SE(3) action on homogeneous point maps with the optional 4×6 Jacobian
    w.r.t. a left-multiplied twist at the target frame."""
    X1 = lie.act(Gij[..., None, None, :], X0)
    if not jacobian:
        return X1, None

    X, Y, Z, d = X1.unbind(-1)
    o = torch.zeros_like(d)
    Ja = torch.stack(
        [
            d, o, o, o, Z, -Y,
            o, d, o, -Z, o, X,
            o, o, d, Y, -X, o,
            o, o, o, o, o, o,
        ],
        dim=-1,
    ).reshape(X1.shape[:-1] + (4, 6))
    return X1, Ja


class TransformJacobians(NamedTuple):
    Ji: Tensor  # [N, H, W, 2, 6] d(coords)/d(pose_i twist)
    Jj: Tensor  # [N, H, W, 2, 6] d(coords)/d(pose_j twist)
    Jz: Tensor  # [N, H, W, 2, 1] d(coords)/d(inverse depth)


def relative_poses(poses: Tensor, ii: Tensor, jj: Tensor) -> Tensor:
    """G_ij = G_j ∘ G_i⁻¹ per edge, with the stereo baseline on self edges."""
    Gij = lie.rel(poses[ii], poses[jj])
    base = Gij.new_tensor(STEREO_BASELINE)
    return torch.where((ii == jj)[:, None], base, Gij)


def projective_transform(
    poses: Tensor,
    depths: Tensor,
    intrinsics: Tensor,
    ii: Tensor,
    jj: Tensor,
    jacobian: bool = False,
    return_depth: bool = False,
    min_depth: float = MIN_DEPTH,
):
    """Map pixels of frames ii into frames jj (geom/projective_ops.py:96-126).

    poses [P, 7]; depths [P, H, W]; intrinsics [P, 4]; ii/jj [N] int64, all
    in range. Returns (coords [N, H, W, 2|3], valid [N, H, W, 1]) and, with
    ``jacobian``, a :class:`TransformJacobians` as third element.
    """
    X0 = iproj(depths[ii], intrinsics[ii])
    Gij = relative_poses(poses, ii, jj)

    X1, Ja = actp(Gij, X0, jacobian=jacobian)
    x1, Jp = proj(
        X1, intrinsics[jj], jacobian=jacobian, return_depth=return_depth,
        min_depth=min_depth,
    )

    valid = ((X1[..., 2] > min_depth) & (X0[..., 2] > min_depth)).to(x1.dtype)[..., None]

    if not jacobian:
        return x1, valid

    # Jacobian w.r.t. the target pose, then dual-adjoint transport to the
    # source pose: Ji = −Ad(G_ij)ᵀ Jj (projective_ops.py:117-124)
    Jj_full = torch.matmul(Jp, Ja)
    Ji_full = -lie.adjT(Gij[..., None, None, None, :], Jj_full)

    # depth Jacobian: d X1 / d d = G_ij ∘ (0, 0, 0, 1) = (t_ij, 1)
    Jz_pt = torch.cat([lie.translation(Gij), torch.ones_like(Gij[..., :1])], dim=-1)
    Jz = torch.matmul(Jp, Jz_pt[..., None, None, :, None])

    return x1, valid, TransformJacobians(Ji=Ji_full, Jj=Jj_full, Jz=Jz)


def induced_flow(poses: Tensor, disps: Tensor, intrinsics: Tensor, ii: Tensor, jj: Tensor):
    """Optical flow induced by camera motion (projective_ops.py:128-139):
    (coords of frames ii in frames jj minus the pixel grid [N, H, W, 2],
    valid [N, H, W, 1])."""
    ht, wd = disps.shape[-2:]
    coords0 = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1[..., :2] - coords0, valid


def projective_transform_batched(poses: Tensor, depths: Tensor, intrinsics: Tensor, ii: Tensor,
                                 jj: Tensor, min_depth: float = MIN_DEPTH):
    """:func:`projective_transform` over a leading batch dim with one edge
    list for the batch (the JAX package vmaps it): poses [B, F, 7], depths
    [B, F, H, W], intrinsics [B, F, 4], ii/jj [N] → (coords [B, N, H, W, 2],
    valid [B, N, H, W, 1])."""
    B, F = poses.shape[:2]
    ht, wd = depths.shape[-2:]
    N = ii.shape[0]
    frame0 = torch.arange(B, device=poses.device)[:, None] * F
    coords, valid = projective_transform(
        poses.reshape(B * F, 7), depths.reshape(B * F, ht, wd), intrinsics.reshape(B * F, 4),
        (frame0 + ii).reshape(-1), (frame0 + jj).reshape(-1), min_depth=min_depth,
    )
    return coords.reshape(B, N, ht, wd, -1), valid.reshape(B, N, ht, wd, 1)
