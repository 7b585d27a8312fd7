"""A closed loop through a courtyard: a frozen copy of the port's
``render_loop_sequence`` (``droid_slam_tpu_torch/data/synthetic.py``), with
the same draws from the seed, so that no later change to the program can
move the benchmark's traffic.

The world is a closed courtyard, a floor, a ceiling and four walls about a
unit from the orbit, each with a ``rich`` texture (4 to 12 Fourier
components of wider frequency, a contrast scale). The camera orbits inside
at radius ``radius``, faces outward at the near wall, and sweeps
``1 + revisit`` turns, so that the last frames see the first views again;
its centre bobs gently and carries smoothed jitter (σ 0.015), its yaw a
random walk of 0.004 rad per frame. Frames are rendered by
``render._render_frames`` on threads. Returns uint8 images [F, H, W, 3],
camera-to-world poses [F, 7] and full-resolution intrinsics [F, 4].
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from slam_bench import render


class _RichPlane(render._Plane):
    """``render._Plane``'s draws, then the rich texture's, which replace
    them (``_Plane(rich=True)`` of the port)."""

    def __init__(self, rng, n, c):
        super().__init__(rng, n, c)
        k = int(rng.integers(4, 13))
        self.freq_a = rng.uniform(0.3, 8.0, (3, k))
        self.freq_b = rng.uniform(0.3, 8.0, (3, k))
        self.phase = rng.uniform(0, 2 * np.pi, (3, k))
        self.amp = rng.uniform(0.3, 1.0, (3, k)) * rng.uniform(0.35, 1.0)


def _courtyard(rng, radius: float) -> list:
    half = radius + rng.uniform(0.8, 1.2)
    return [
        _RichPlane(rng, (0.0, 1.0, 0.0), rng.uniform(0.7, 1.0)),  # floor
        _RichPlane(rng, (0.0, 1.0, 0.0), -rng.uniform(1.0, 1.4)),  # ceiling
        _RichPlane(rng, (1.0, 0.0, 0.0), half),
        _RichPlane(rng, (-1.0, 0.0, 0.0), half),
        _RichPlane(rng, (0.0, 0.0, 1.0), half),
        _RichPlane(rng, (0.0, 0.0, -1.0), half),
    ]


def _orbit(rng, frames: int, radius: float, revisit: float):
    """Camera centres [F, 3] and camera-to-world rotations [F, 3, 3]
    (columns: the camera's axes; world +y is image-down)."""
    theta = (1.0 + revisit) * 2.0 * np.pi * np.arange(frames) / frames
    centers = np.stack([radius * np.sin(theta), 0.12 * np.sin(3.1 * theta), -radius * np.cos(theta)], axis=-1)
    jit = 0.015 * rng.standard_normal((frames, 3))
    for _ in range(4):
        jit = 0.5 * jit + 0.25 * (np.roll(jit, 1, 0) + np.roll(jit, -1, 0))
    centers += jit
    outward = np.stack([np.sin(theta), np.zeros_like(theta), -np.cos(theta)], -1)
    yaw = np.cumsum(0.004 * rng.standard_normal(frames))
    Rs = np.zeros((frames, 3, 3))
    for k in range(frames):
        z = outward[k] / np.linalg.norm(outward[k])
        c, s = np.cos(yaw[k]), np.sin(yaw[k])
        z = np.array([c * z[0] + s * z[2], z[1], -s * z[0] + c * z[2]])
        y = np.array([0.0, 1.0, 0.0])
        x = np.cross(y, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rs[k] = np.stack([x, y, z], axis=-1)
    return centers, Rs


def generate(seed: int, image_size, frames: int, radius: float, revisit: float, workers: int = 8):
    rng = np.random.default_rng(seed)
    H, W = image_size
    f = 0.9 * W
    cx, cy = W / 2, H / 2
    planes = _courtyard(rng, radius)
    centers, Rs = _orbit(rng, frames, radius, revisit)
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    d_cam = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], axis=-1)
    blocks = [b for b in np.array_split(np.arange(frames), workers) if len(b)]
    with ThreadPoolExecutor(len(blocks)) as pool:
        parts = list(pool.map(render._render_frames, [planes] * len(blocks), [centers[b] for b in blocks],
                              [Rs[b] for b in blocks], [d_cam] * len(blocks)))
    images, _, poses = (np.concatenate(a) for a in zip(*parts))
    intr = np.tile(np.array([f, f, cx, cy], np.float32), (frames, 1))
    return {"images": images, "poses": poses, "intrinsics": intr}
