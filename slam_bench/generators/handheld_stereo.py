"""A hand-held stereo rig's sequence: ``handheld``'s world and random-walk
trajectory, drawn from the seed in the same order (so a seed's left images
are ``handheld``'s), each frame rendered by the left camera and by a right
camera ``BASELINE`` along the left camera's +x axis with the same rotation.
That is the rig of the port's ``data/synthetic.py`` (``render_sequence``
with ``stereo``), and the left-to-right transform the program pins for its
stereo self edges (``ops/projective.py::STEREO_BASELINE``). Both cameras
are rendered by ``render._render_frames`` on threads. Returns uint8 images
[F, 2, H, W, 3] (left, right), the left camera's camera-to-world poses
[F, 7] and full-resolution intrinsics [F, 4]."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from slam_bench import render

BASELINE = 0.1  # world units from the left camera's centre to the right's


def generate(seed: int, image_size, frames: int, t_sigma: float, r_sigma: float, workers: int = 8):
    rng = np.random.default_rng(seed)
    H, W = image_size
    f = 0.9 * W
    cx, cy = W / 2, H / 2
    planes = render._make_world(rng)
    centers, Rs = render._smooth_trajectory(rng, frames, t_sigma, r_sigma)
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    d_cam = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], axis=-1)
    blocks = [b for b in np.array_split(np.arange(frames), workers) if len(b)]
    rights = centers + BASELINE * Rs[:, :, 0]
    jobs = [(centers[b], Rs[b]) for b in blocks] + [(rights[b], Rs[b]) for b in blocks]
    with ThreadPoolExecutor(len(jobs)) as pool:
        parts = list(pool.map(lambda job: render._render_frames(planes, *job, d_cam), jobs))
    left, right = parts[:len(blocks)], parts[len(blocks):]
    images = np.stack([np.concatenate([p[0] for p in left]), np.concatenate([p[0] for p in right])], axis=1)
    poses = np.concatenate([p[2] for p in left])
    intr = np.tile(np.array([f, f, cx, cy], np.float32), (frames, 1))
    return {"images": images, "poses": poses, "intrinsics": intr}
