"""Covisibility distance matrices between the frames of a clip (PyTorch on
the host).

Counterpart of ``compute_distance_matrix_flow`` and
``compute_distance_matrix_flow2`` of the JAX package's
``data/rgbd_utils.py`` (reference data_readers/rgbd_utils.py:101-190): the
mean induced-flow magnitude between every ordered pair of frames, in chunks
of pairs. The TUM file readers of that module belong to the file protocols
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie
from ..ops import projective as pops

Tensor = torch.Tensor


def _flow_chunk(poses_w2c: Tensor, disps: Tensor, intrinsics: Tensor, ii: Tensor, jj: Tensor) -> Tensor:
    """Mean induced-flow magnitude per pair, both ways (rgbd_utils.py:105-142):
    clamped at 100 px, 1e9 where fewer than 70% of the pixels stay valid."""
    max_flow = 100.0

    def one_way(a, b):
        flow, val = pops.induced_flow(poses_w2c, disps, intrinsics, a, b)
        return torch.linalg.norm(flow, dim=-1).clamp(max=max_flow), val[..., 0]

    m1, v1 = one_way(ii, jj)
    m2, v2 = one_way(jj, ii)
    mag = torch.cat([m1.flatten(1), m2.flatten(1)], -1)
    val = torch.cat([v1.flatten(1), v2.flatten(1)], -1)
    mean_mag = (mag * val).sum(-1) / val.sum(-1).clamp(min=1e-6)
    return torch.where(val.mean(-1) < 0.7, torch.full_like(mean_mag, 1e9), mean_mag)


def _flow2_chunk(poses_w2c: Tensor, disps: Tensor, intrinsics: Tensor, ii: Tensor, jj: Tensor,
                 beta: float) -> Tensor:
    """Blended translation-only + beta·full flow magnitude per pair, both
    ways (rgbd_utils.py:145-190; the reverse direction reads (jj, ii), the
    symmetric intent of the reference's indexing)."""
    max_flow = 128.0
    ht, wd = disps.shape[-2:]
    grid = pops.coords_grid(ht, wd, device=disps.device)

    def tonly_flow(a, b):
        Gij = pops.relative_poses(poses_w2c, a, b)
        X0 = pops.iproj(disps[a], intrinsics[a])
        X1 = X0[..., :3] + X0[..., 3:4] * lie.translation(Gij)[:, None, None, :]
        intr_b = intrinsics[b]
        fx, fy, cx, cy = (intr_b[:, k, None, None] for k in range(4))
        Z = X1[..., 2]
        zi = 1.0 / torch.where(Z < 0.1, torch.ones_like(Z), Z)
        u = fx * X1[..., 0] * zi + cx
        v = fy * X1[..., 1] * zi + cy
        return torch.stack([u, v], -1) - grid, (Z > 0.2).to(disps.dtype)

    def one_way(a, b):
        fa, va = tonly_flow(a, b)
        fb, vb = pops.induced_flow(poses_w2c, disps, intrinsics, a, b)
        mag = torch.linalg.norm(fa + beta * fb, dim=-1).clamp(max=max_flow)
        return mag, va * vb[..., 0]

    m1, v1 = one_way(ii, jj)
    m2, v2 = one_way(jj, ii)
    mag = torch.cat([m1.flatten(1), m2.flatten(1)], -1)
    val = torch.cat([v1.flatten(1), v2.flatten(1)], -1)
    mean_mag = (mag * val).sum(-1) / val.sum(-1).clamp(min=1e-6)
    return torch.where(val.mean(-1) < 0.8, torch.full_like(mean_mag, 1e9), mean_mag)


def _all_pairs(n: int, chunk: int, chunk_fn) -> np.ndarray:
    """A per-pair distance over all n·n ordered frame pairs, ``chunk`` pairs
    per call; the 1e9 sentinel becomes inf."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ii = torch.as_tensor(ii.reshape(-1))
    jj = torch.as_tensor(jj.reshape(-1))
    out = [chunk_fn(ii[s : s + chunk], jj[s : s + chunk]) for s in range(0, n * n, chunk)]
    matrix = torch.cat(out).numpy().astype(np.float32).reshape(n, n)
    matrix[matrix >= 1e9] = np.inf
    return matrix


def _inputs(poses_c2w, disps, intrinsics):
    n = len(poses_c2w)
    poses_w2c = lie.inv(torch.as_tensor(np.asarray(poses_c2w, np.float32)))
    d = torch.as_tensor(np.asarray(disps, np.float32))
    k = torch.as_tensor(np.broadcast_to(np.asarray(intrinsics, np.float32), (n, 4)).copy())
    return n, poses_w2c, d, k


@torch.no_grad()
def compute_distance_matrix_flow(poses_c2w: np.ndarray, disps: np.ndarray, intrinsics: np.ndarray,
                                 chunk: int = 2048) -> np.ndarray:
    """All-pairs covisibility (flow) distance matrix [N, N] (rgbd_utils.py:101-142).
    poses_c2w [N, 7] camera-to-world (inverted on entry, as the reference
    does), disps [N, H, W], intrinsics [N, 4] at the disparities'
    resolution."""
    n, poses_w2c, d, k = _inputs(poses_c2w, disps, intrinsics)
    return _all_pairs(n, chunk, lambda a, b: _flow_chunk(poses_w2c, d, k, a, b))


@torch.no_grad()
def compute_distance_matrix_flow2(poses_c2w: np.ndarray, disps: np.ndarray, intrinsics: np.ndarray,
                                  beta: float = 0.4, chunk: int = 2048) -> np.ndarray:
    """All-pairs blended-flow distance (rgbd_utils.py:145-190), the input of
    the NMS graph builder ``build_frame_graph_v2``."""
    n, poses_w2c, d, k = _inputs(poses_c2w, disps, intrinsics)
    return _all_pairs(n, chunk, lambda a, b: _flow2_chunk(poses_w2c, d, k, a, b, beta))
