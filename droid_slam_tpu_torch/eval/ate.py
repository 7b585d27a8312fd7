"""Trajectory evaluation: Umeyama alignment and absolute trajectory error
(numpy).

The port's own copy of the JAX package's ``eval/ate.py`` scorer, which
stands in for the ``evo`` tool of the reference's evaluation scripts: APE
on translation after SE(3) or Sim(3) Umeyama alignment, with optional scale
correction (monocular protocols align and scale; RGB-D and stereo are
metric and align without scale), and the ground-truth readers of the four
file protocols: TUM text, TartanAir's ``pose_left.txt`` and EuRoC's
``data.csv``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class Trajectory:
    """Timestamped positions+quaternions, TUM convention (t, xyz, q_xyzw)."""

    tstamps: np.ndarray  # [T]
    positions: np.ndarray  # [T, 3]
    quats: np.ndarray  # [T, 4] xyzw

    @staticmethod
    def from_poses(tstamps, poses_c2w: np.ndarray) -> "Trajectory":
        """poses_c2w: [T, 7] camera-to-world (t, q_xyzw)."""
        return Trajectory(
            np.asarray(tstamps, np.float64),
            np.asarray(poses_c2w[:, :3], np.float64),
            np.asarray(poses_c2w[:, 3:7], np.float64),
        )

    @staticmethod
    def load_tum(path: str) -> "Trajectory":
        """A TUM trajectory file: t, xyz, q_xyzw per line, ``#`` comments."""
        data = np.loadtxt(path, comments="#", dtype=np.float64)
        return Trajectory(data[:, 0], data[:, 1:4], data[:, 4:8])

    @staticmethod
    def load_tartanair(path: str) -> "Trajectory":
        """TartanAir's ``pose_left.txt``: 7 columns (NED xyz, quaternion),
        no stamps. The columns are permuted NED → camera axes and each row
        is stamped with its index (reference validate_tartanair.py:93-94)."""
        raw = np.loadtxt(path, delimiter=" ", dtype=np.float64)[:, [1, 2, 0, 4, 5, 3, 6]]
        return Trajectory(np.arange(len(raw), dtype=np.float64), raw[:, :3], raw[:, 3:])

    @staticmethod
    def load_euroc_csv(path: str) -> "Trajectory":
        """A EuRoC sequence's ``mav0/state_groundtruth_estimate0/data.csv``
        (timestamp in ns, p_xyz, q_wxyz, ...): stamps in seconds,
        quaternions reordered to xyzw."""
        data = np.loadtxt(path, comments="#", delimiter=",", dtype=np.float64)
        return Trajectory(data[:, 0] / 1e9, data[:, 1:4], data[:, [5, 6, 7, 4]])

    @staticmethod
    def load(path: str) -> "Trajectory":
        """EuRoC's ``.csv`` by its extension, else TUM text."""
        if path.endswith(".csv"):
            return Trajectory.load_euroc_csv(path)
        return Trajectory.load_tum(path)

    def save_tum(self, path: str):
        data = np.concatenate([self.tstamps[:, None], self.positions, self.quats], axis=1)
        np.savetxt(path, data, fmt="%.9f")


def associate(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy timestamp association in globally ascending dt order (the TUM
    benchmark convention): each t_a is matched to an unused neighbour in
    t_b at most max_dt away, closest pairs first. Returns index arrays
    (into t_a, into t_b) sorted by the t_a index."""
    order_b = np.argsort(t_b)
    tb_sorted = t_b[order_b]
    # candidates: each ta's two bracketing tb neighbours
    pos = np.searchsorted(tb_sorted, t_a)
    cand = []
    for k, ta in enumerate(t_a):
        for c in (pos[k] - 1, pos[k]):
            if 0 <= c < len(tb_sorted):
                dt = abs(tb_sorted[c] - ta)
                if dt <= max_dt:
                    cand.append((dt, k, order_b[c]))
    cand.sort(key=lambda x: x[0])
    used_a = np.zeros(len(t_a), bool)
    used_b = np.zeros(len(t_b), bool)
    ia, ib = [], []
    for _, k, j in cand:
        if not used_a[k] and not used_b[j]:
            used_a[k] = True
            used_b[j] = True
            ia.append(k)
            ib.append(j)
    order = np.argsort(ia)
    return np.asarray(ia, np.int64)[order], np.asarray(ib, np.int64)[order]


def align_umeyama(model: np.ndarray, data: np.ndarray, correct_scale: bool = False
                  ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform aligning ``model`` onto ``data``
    (Umeyama 1991). Both [N, 3]. Returns (s, R, t) with
    data ≈ s · R @ model + t."""
    mu_m = model.mean(axis=0)
    mu_d = data.mean(axis=0)
    mc = model - mu_m
    dc = data - mu_d

    cov = dc.T @ mc / len(model)
    U, S, Vt = np.linalg.svd(cov)
    W = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        W[2, 2] = -1
    R = U @ W @ Vt
    if correct_scale:
        var_m = (mc**2).sum() / len(model)
        s = float(np.trace(np.diag(S) @ W) / var_m)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    return s, R, t


def ate_rmse(gt: Trajectory, est: Trajectory, correct_scale: bool = False, max_dt: float = 0.02) -> dict:
    """Absolute trajectory error after alignment: RMSE, mean, median and
    max of the position errors, the number of associated pairs and the
    fitted scale."""
    ia, ib = associate(gt.tstamps, est.tstamps, max_dt=max_dt)
    if len(ia) < 3:
        raise ValueError(f"only {len(ia)} associated poses")
    P = est.positions[ib]
    G = gt.positions[ia]
    s, R, t = align_umeyama(P, G, correct_scale=correct_scale)
    P_aligned = s * P @ R.T + t
    err = np.linalg.norm(P_aligned - G, axis=1)
    return {
        "ate_rmse": float(np.sqrt(np.mean(err**2))),
        "ate_mean": float(err.mean()),
        "ate_median": float(np.median(err)),
        "ate_max": float(err.max()),
        "n_pairs": int(len(ia)),
        "scale": s,
    }
