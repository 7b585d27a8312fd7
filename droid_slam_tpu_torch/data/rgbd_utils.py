"""RGB-D dataset utilities: the TUM-format readers and the covisibility
distance matrices between the frames of a clip (numpy and PyTorch on the
host).

Counterpart of the JAX package's ``data/rgbd_utils.py`` (reference
data_readers/rgbd_utils.py): ``parse_list``, ``associate_frames`` (each
image stamp matched to its nearest depth and pose stamps), ``loadtum``
and ``pose_matrix_to_quaternion`` read TUM-format sequences;
``compute_distance_matrix_flow`` and ``compute_distance_matrix_flow2``
give the mean induced-flow magnitude between every ordered pair of
frames, in chunks of pairs (rgbd_utils.py:101-190).
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from ..ops import lie
from ..ops import projective as pops

Tensor = torch.Tensor


def parse_list(filepath: str, skiprows: int = 0) -> np.ndarray:
    """The whitespace-separated columns of a TUM list file, as strings."""
    return np.loadtxt(filepath, delimiter=" ", dtype=np.str_, skiprows=skiprows)


def _nearest(ts: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Index into ``table`` of the nearest stamp for every entry of ``ts``
    (one [len(ts), len(table)] broadcast)."""
    return np.argmin(np.abs(ts[:, None] - table[None, :]), axis=1)


def associate_frames(tstamp_image, tstamp_depth, tstamp_pose=None, max_dt: float = 1.0):
    """Match every image stamp to its nearest depth (and pose) stamp and keep
    the frames whose matches all lie within ``max_dt`` seconds (reference
    rgbd_utils.py:16-33). Returns a list of (i, j[, k]) row indices into
    (image, depth[, pose])."""
    t = np.asarray(tstamp_image, np.float64)
    td = np.asarray(tstamp_depth, np.float64)
    j = _nearest(t, td)
    ok = np.abs(td[j] - t) < max_dt
    cols = [np.arange(len(t)), j]
    if tstamp_pose is not None:
        tp = np.asarray(tstamp_pose, np.float64)
        k = _nearest(t, tp)
        ok &= np.abs(tp[k] - t) < max_dt
        cols.append(k)
    return [tuple(int(c[i]) for c in cols) for i in np.flatnonzero(ok)]


def loadtum(datapath: str, frame_rate: int = -1):
    """Read a TUM-RGBD-format sequence (reference rgbd_utils.py:36-91):
    rgb.txt, depth.txt and groundtruth.txt (or pose.txt), associated by
    stamp, every fifth frame kept. Returns (image paths, depth paths, poses
    [t, q_xyzw], intrinsics, stamps), all None without a pose file."""
    pose_file = next((p for p in ("groundtruth.txt", "pose.txt") if osp.isfile(osp.join(datapath, p))), None)
    if pose_file is None:
        return None, None, None, None, None

    image_data = parse_list(osp.join(datapath, "rgb.txt"))
    depth_data = parse_list(osp.join(datapath, "depth.txt"))
    pose_data = parse_list(osp.join(datapath, pose_file), skiprows=1)

    pairs = associate_frames(image_data[:, 0].astype(np.float64), depth_data[:, 0].astype(np.float64),
                             pose_data[:, 0].astype(np.float64))
    i, j, k = np.asarray(pairs[::5], np.int64).reshape(-1, 3).T

    calib_path = osp.join(datapath, "calibration.txt")
    intrinsic = np.loadtxt(calib_path, delimiter=" ").astype(np.float64) if osp.isfile(calib_path) else None

    images = [osp.join(datapath, p) for p in image_data[i, 1]]
    depths = [osp.join(datapath, p) for p in depth_data[j, 1]]
    poses = list(pose_data[k, 1:].astype(np.float64))
    tstamps = list(image_data[i, 0].astype(np.float64))
    intrinsics = [] if intrinsic is None else [intrinsic] * len(images)
    return images, depths, poses, intrinsics, tstamps


def pose_matrix_to_quaternion(pose: np.ndarray) -> np.ndarray:
    """A 4×4 (or 3×4) pose matrix → [t, q_xyzw]."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(pose[:3, :3]).as_quat()
    return np.concatenate([pose[:3, 3], q], axis=0)


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
