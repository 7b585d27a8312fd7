"""Frozen copy of the port's synthetic renderer (``render_sequence`` of
``droid_slam_tpu_torch/data/synthetic.py``), so
that no later change to the program can move the benchmark's traffic.

Piecewise-planar worlds with smooth random Fourier textures, rendered by
exact ray-plane intersection through known camera trajectories: every
pixel's colour and depth agree with the ground-truth poses. One seed gives
the same images, poses and intrinsics bit for bit. Poses are
camera-to-world (t, q_xyzw). The copy leaves out what no cell renders
(the trainer's dataset class, the training curriculum's ``varied`` worlds
and motions, the stereo rig, the loop sequence); the rest is the port's
code as it stood when the benchmark was written, with the same draws from
the seed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial.transform import Rotation


class _Plane:
    """Textured plane n·p = c with an in-plane texture basis (u, v)."""

    def __init__(self, rng, n, c):
        self.n = np.asarray(n, np.float64)
        self.n /= np.linalg.norm(self.n)
        self.c = float(c)
        # orthonormal in-plane basis for texture coordinates
        a = np.array([1.0, 0.0, 0.0])
        if abs(self.n @ a) > 0.9:
            a = np.array([0.0, 1.0, 0.0])
        self.u = np.cross(self.n, a)
        self.u /= np.linalg.norm(self.u)
        self.v = np.cross(self.n, self.u)
        # smooth random Fourier texture per channel
        self.freq_a = rng.uniform(0.7, 4.0, (3, 8))
        self.freq_b = rng.uniform(0.7, 4.0, (3, 8))
        self.phase = rng.uniform(0, 2 * np.pi, (3, 8))
        self.amp = rng.uniform(0.5, 1.0, (3, 8))

    def intersect(self, o, d):
        """Ray o + t·d. Returns t (np.inf where the ray misses)."""
        denom = d @ self.n
        t = (self.c - o @ self.n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        return np.where((t > 0.05) & (np.abs(denom) > 1e-6), t, np.inf)

    def color(self, p):
        x = p @ self.u
        y = p @ self.v
        chans = []
        for ch in range(3):
            v = sum(
                self.amp[ch, k]
                * np.sin(self.freq_a[ch, k] * x + self.freq_b[ch, k] * y + self.phase[ch, k])
                for k in range(self.amp.shape[1])
            )
            chans.append(v)
        t = np.stack(chans, axis=-1)
        # normalize by a FIXED per-plane range (±3σ of the sine mixture,
        # σ² = Σ aₖ²/2, clipped), not by the min/ptp of the pixels visible in
        # this call: a per-call normalization would give the same world point
        # a different color in different frames, breaking the exact
        # photometric consistency this module promises
        bound = 3.0 * np.sqrt(0.5 * (self.amp**2).sum(axis=1))  # per channel
        t = (t + bound) / (2.0 * bound)
        return (255 * np.clip(t, 0.0, 1.0)).astype(np.uint8)


def _make_world(rng) -> list:
    """Tilted floor + back wall (+ optional side wall) in front of the origin."""
    planes = []
    # back wall: roughly z = Z0, slightly tilted
    n = np.array([rng.normal(0, 0.15), rng.normal(0, 0.15), 1.0])
    planes.append(_Plane(rng, n, rng.uniform(2.2, 3.5)))
    # floor: y = Y0 plane tilted, below the camera, visible in lower image
    n = np.array([rng.normal(0, 0.1), 1.0, rng.normal(0, 0.2)])
    planes.append(_Plane(rng, n, rng.uniform(0.8, 1.4)))
    if rng.random() < 0.5:
        n = np.array([1.0, rng.normal(0, 0.1), rng.normal(0, 0.3)])
        planes.append(_Plane(rng, n, rng.uniform(1.5, 2.5)))
    return planes


def _smooth_trajectory(rng, n_frames: int, t_sigma: float, r_sigma: float):
    """Smooth random-walk camera-to-world trajectory near the origin."""
    steps_t = t_sigma * rng.standard_normal((n_frames, 3))
    steps_t[:, 2] *= 0.5  # keep depth range stable
    centers = np.cumsum(steps_t, axis=0)
    centers -= centers[0]
    # never drift through the scene geometry (back wall at z >= 2.2)
    centers[:, 2] = np.clip(centers[:, 2], -0.8, 1.0)
    steps_r = r_sigma * rng.standard_normal((n_frames, 3))
    rotvecs = np.cumsum(steps_r, axis=0)
    rotvecs -= rotvecs[0]
    Rs = Rotation.from_rotvec(rotvecs).as_matrix()
    return centers, Rs


def _raycast(planes, o, d_world, H, W):
    """Raycast one camera: returns (rgb uint8 [H,W,3], depth f32 [H,W])."""
    t_best = np.full((H, W), np.inf)
    idx = np.full((H, W), -1, np.int32)
    for pi, pl in enumerate(planes):
        t = pl.intersect(o, d_world)
        better = t < t_best
        t_best = np.where(better, t, t_best)
        idx = np.where(better, pi, idx)
    # rays that miss everything: clamp to far depth with plane-0 color
    t_best = np.where(np.isfinite(t_best), t_best, 50.0)
    idx = np.where(idx < 0, 0, idx)

    p_world = o + t_best[..., None] * d_world
    img = np.zeros((H, W, 3), np.uint8)
    for pi, pl in enumerate(planes):
        m = idx == pi
        if m.any():
            img[m] = pl.color(p_world[m])
    return img, t_best.astype(np.float32)  # camera z (d_cam z-component = 1)


def render_sequence(
    rng: np.random.Generator,
    n_frames: int = 7,
    image_size=(96, 128),
    t_sigma: float = 0.04,
    r_sigma: float = 0.01,
    focal: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    """Render one sequence. Returns dict with images: [F, H, W, 3] uint8;
    poses: [F, 7] CAMERA-TO-WORLD (t, q_xyzw); depths: [F, H, W] f32;
    intrinsics: [F, 4] f32."""
    H, W = image_size
    f = focal if focal is not None else 0.9 * W
    cx, cy = W / 2, H / 2
    intr = np.array([f, f, cx, cy], np.float32)

    planes = _make_world(rng)
    centers, Rs = _smooth_trajectory(rng, n_frames, t_sigma, r_sigma)

    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    d_cam = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], axis=-1)

    images = np.zeros((n_frames, H, W, 3), np.uint8)
    depths = np.zeros((n_frames, H, W), np.float32)
    poses = np.zeros((n_frames, 7), np.float32)
    for k in range(n_frames):
        o = centers[k]
        R = Rs[k]  # camera-to-world rotation
        d_world = d_cam @ R.T  # [H, W, 3]
        images[k], depths[k] = _raycast(planes, o, d_world, H, W)
        q = Rotation.from_matrix(R).as_quat()  # xyzw, camera-to-world
        poses[k] = np.concatenate([o, q]).astype(np.float32)

    return {
        "images": images,
        "poses": poses,
        "depths": depths,
        "intrinsics": np.tile(intr, (n_frames, 1)),
    }


def _render_frames(planes, centers, Rs, d_cam):
    """Raycast the cameras at ``centers`` [n, 3] with rotations ``Rs``
    [n, 3, 3] (columns: camera axes) through the per-pixel rays ``d_cam``
    [H, W, 3]: (images, depths, camera-to-world poses (t, q_xyzw))."""
    n = len(centers)
    H, W = d_cam.shape[:2]
    images = np.zeros((n, H, W, 3), np.uint8)
    depths = np.zeros((n, H, W), np.float32)
    poses = np.zeros((n, 7), np.float32)
    for k in range(n):
        d_world = d_cam @ Rs[k].T
        images[k], depths[k] = _raycast(planes, centers[k], d_world, H, W)
        q = Rotation.from_matrix(Rs[k]).as_quat()
        poses[k] = np.concatenate([centers[k], q]).astype(np.float32)
    return images, depths, poses
