"""Keyframe buffer and its helpers (PyTorch).

Counterpart of the JAX package's ``runtime/video.py``: the RGB-D prior, the
masked frame distance behind proximity edge selection and the keyframe cull
test, and the padded window read/write used for the per-keyframe damping
(the port's ``VideoState``, which only the host-driven engine, the global
backend and the filler use, is not copied).
"""

from __future__ import annotations

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
