"""A hand-held camera's sequence: ``render_sequence``'s random-walk
trajectory through a tilted floor and back wall, rendered from the seed on
threads (the frames are independent once the world and the trajectory are
drawn). Returns uint8 images [F, H, W, 3], camera-to-world poses [F, 7] and
full-resolution intrinsics [F, 4]."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from slam_bench import render


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
    with ThreadPoolExecutor(len(blocks)) as pool:
        parts = list(pool.map(render._render_frames, [planes] * len(blocks), [centers[b] for b in blocks],
                              [Rs[b] for b in blocks], [d_cam] * len(blocks)))
    images, _, poses = (np.concatenate(a) for a in zip(*parts))
    intr = np.tile(np.array([f, f, cx, cy], np.float32), (frames, 1))
    return {"images": images, "poses": poses, "intrinsics": intr}
