"""Procedural synthetic RGB-D and stereo sequences with exact ground truth
(numpy and scipy).

The port's own copy of the JAX package's ``data/synthetic.py`` renderers:
piecewise-planar worlds (tilted floor + back wall) with smooth random
Fourier textures, rendered by exact ray-plane intersection through known
camera trajectories, so every pixel's colour and depth agree with the
ground-truth poses. For one seed the images, depths, poses and intrinsics
are bit for bit the JAX package's (tests/test_torch_trained.py holds that),
so the two packages are scored on the same sequences. The trainer draws
its clips from :class:`SyntheticDataset`, whose clips for one seed are the
JAX package's bit for bit too.

Poses are camera-to-world (t, q_xyzw); depths are z at full resolution.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial.transform import Rotation


class _Plane:
    """Textured plane n·p = c with an in-plane texture basis (u, v).

    ``rich=True`` (training curriculum only — never the pinned eval
    protocol) widens the texture distribution: variable component count,
    a wider spatial-frequency range (low-frequency planes are nearly
    textureless — the hard case for flow), and a global contrast scale.
    """

    def __init__(self, rng, n, c, rich: bool = False):
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
        if rich:
            k = int(rng.integers(4, 13))
            self.freq_a = rng.uniform(0.3, 8.0, (3, k))
            self.freq_b = rng.uniform(0.3, 8.0, (3, k))
            self.phase = rng.uniform(0, 2 * np.pi, (3, k))
            # low-contrast planes (amp scale down to 0.35) force the matcher
            # to lean on geometry, not texture saliency
            self.amp = rng.uniform(0.3, 1.0, (3, k)) * rng.uniform(0.35, 1.0)

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


def _make_world(rng, varied: bool = False) -> list:
    """Tilted floor + back wall (+ optional side wall) in front of the origin.

    ``varied=True`` (training curriculum): wider depth range, optional
    ceiling/second side wall, 0-2 free-floating tilted planes, rich
    textures — the in-environment stand-in for TartanAir's scene breadth
    (reference train.py:147-171). The default is the PINNED eval
    world: identical rng consumption, so seed:N eval scenes never change.
    """
    if varied:
        planes = []
        # back wall: wider depth range and tilt than the eval world
        n = np.array([rng.normal(0, 0.3), rng.normal(0, 0.3), 1.0])
        planes.append(_Plane(rng, n, rng.uniform(2.0, 4.5), rich=True))
        if rng.random() < 0.9:  # floor (below camera, +y is image-down)
            n = np.array([rng.normal(0, 0.2), 1.0, rng.normal(0, 0.3)])
            planes.append(_Plane(rng, n, rng.uniform(0.7, 1.6), rich=True))
        if rng.random() < 0.3:  # ceiling
            n = np.array([rng.normal(0, 0.2), 1.0, rng.normal(0, 0.3)])
            planes.append(_Plane(rng, n, -rng.uniform(0.8, 1.6), rich=True))
        for s in (1.0, -1.0):  # side walls, either side independently
            if rng.random() < 0.5:
                n = np.array([s, rng.normal(0, 0.15), rng.normal(0, 0.3)])
                planes.append(_Plane(rng, n, rng.uniform(1.6, 2.8), rich=True))
        # free-floating tilted planes: depth discontinuities mid-view. The
        # lower c bound reaches into the near field (~0.8): the eval
        # protocol's 48-frame random walks accumulate drift into extreme
        # close-ups (seed 11 spends frames 12-24 at median depth 0.34 —
        # measured r4), a regime 7-frame training clips never reach unless
        # the WORLD brings surfaces to the camera
        for _ in range(int(rng.integers(0, 3))):
            n = rng.normal(size=3)
            n[2] = abs(n[2]) + 0.7  # face roughly toward the camera
            planes.append(_Plane(rng, n, rng.uniform(0.8, 3.0), rich=True))
        return planes
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


def _smooth_trajectory(rng, n_frames: int, t_sigma: float, r_sigma: float,
                       varied: bool = False):
    """Smooth random-walk camera-to-world trajectory near the origin.

    ``varied=True`` adds motion MODES on top of the random walk —
    forward-dominant dolly, rotation-heavy pans, and orbit arcs — the
    trajectory regimes a generalizing tracker must survive (rotation-heavy
    segments are where weak flow priors break; VERDICT r3 item 7)."""
    mode = "walk"
    if varied:
        mode = ("walk", "forward", "rotation", "orbit")[int(rng.integers(4))]
        if mode == "rotation":
            t_sigma, r_sigma = 0.4 * t_sigma, 3.0 * r_sigma
    steps_t = t_sigma * rng.standard_normal((n_frames, 3))
    steps_t[:, 2] *= 0.5  # keep depth range stable
    if mode == "forward":
        steps_t[:, 2] += 0.6 * t_sigma  # dolly into the scene
    centers = np.cumsum(steps_t, axis=0)
    centers -= centers[0]
    # never drift through the scene geometry (back wall at z >= 2.2 in the
    # eval world, >= 2.0 varied; side walls at |x| >= 1.6 varied)
    centers[:, 2] = np.clip(centers[:, 2], -0.8, 1.0)
    if varied:
        centers[:, 0] = np.clip(centers[:, 0], -1.2, 1.2)
        centers[:, 1] = np.clip(centers[:, 1], -0.6, 0.6)
        # random start offset: short training clips sample the MIDDLE of a
        # long wander, including positions hard against (or past) a side
        # wall — the close-up/crossing regime the eval's accumulated random
        # walks produce (seed-11 diagnosis, r4)
        centers += np.array([
            rng.uniform(-1.3, 1.3), rng.uniform(-0.3, 0.3),
            rng.uniform(-0.5, 0.5),
        ])
    steps_r = r_sigma * rng.standard_normal((n_frames, 3))
    rotvecs = np.cumsum(steps_r, axis=0)
    rotvecs -= rotvecs[0]
    if mode == "orbit":
        # constant yaw sweep with a matching lateral arc: the camera slides
        # sideways while turning to keep the scene in view
        yaw_rate = rng.choice([-1.0, 1.0]) * rng.uniform(0.01, 0.035)
        yaw = yaw_rate * np.arange(n_frames)
        rotvecs[:, 1] += yaw
        radius = rng.uniform(1.5, 2.5)
        centers[:, 0] += radius * np.sin(yaw)
        centers[:, 2] += radius * (1.0 - np.cos(yaw))
        centers[:, 0] = np.clip(centers[:, 0], -1.2, 1.2)
        centers[:, 2] = np.clip(centers[:, 2], -0.8, 1.2)
    Rs = Rotation.from_rotvec(rotvecs).as_matrix()
    return centers, Rs


# Stereo rig: the runtime's stereo self-edges pin the left→right transform
# to t = (−0.1, 0, 0), identity rotation (ops/projective.py:135, citing
# reference droid_slam/geom/projective_ops.py:106). That transform
# maps LEFT-camera coordinates to RIGHT-camera coordinates, so the right
# camera center sits at +0.1 along the left camera's x axis.
STEREO_BASELINE = 0.1


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
    varied: bool = False,
    stereo: bool = False,
) -> Dict[str, np.ndarray]:
    """Render one sequence. Returns dict with

    images: [F, H, W, 3] uint8; poses: [F, 7] CAMERA-TO-WORLD (t, q_xyzw);
    depths: [F, H, W] f32; intrinsics: [F, 4] f32; with ``stereo`` also
    images_right: [F, H, W, 3] uint8 from a camera offset by
    STEREO_BASELINE along the left camera's +x axis (same rotation) —
    exactly the rig the runtime's stereo self-edges assume, so the true
    reconstruction scale is 1.0 and stereo ATE can be gated unscaled.

    The rng consumption is IDENTICAL for mono and stereo renders of the
    same seed (the right camera adds no draws): pinned eval scenes match.
    """
    H, W = image_size
    f = focal if focal is not None else 0.9 * W
    cx, cy = W / 2, H / 2
    intr = np.array([f, f, cx, cy], np.float32)

    planes = _make_world(rng, varied=varied)
    centers, Rs = _smooth_trajectory(rng, n_frames, t_sigma, r_sigma,
                                     varied=varied)

    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    d_cam = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], axis=-1)

    images = np.zeros((n_frames, H, W, 3), np.uint8)
    images_right = (
        np.zeros((n_frames, H, W, 3), np.uint8) if stereo else None
    )
    depths = np.zeros((n_frames, H, W), np.float32)
    poses = np.zeros((n_frames, 7), np.float32)
    for k in range(n_frames):
        o = centers[k]
        R = Rs[k]  # camera-to-world rotation
        d_world = d_cam @ R.T  # [H, W, 3]

        images[k], depths[k] = _raycast(planes, o, d_world, H, W)
        if stereo:
            # right camera: same rotation, center offset along camera +x
            # (world direction = first COLUMN of the c2w rotation)
            o_r = o + STEREO_BASELINE * R[:, 0]
            images_right[k], _ = _raycast(planes, o_r, d_world, H, W)

        q = Rotation.from_matrix(R).as_quat()  # xyzw, camera-to-world
        poses[k] = np.concatenate([o, q]).astype(np.float32)

    out = {
        "images": images,
        "poses": poses,
        "depths": depths,
        "intrinsics": np.tile(intr, (n_frames, 1)),
    }
    if stereo:
        out["images_right"] = images_right
    return out


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


def render_loop_sequence(
    rng: np.random.Generator,
    n_frames: int = 240,
    image_size=(384, 512),
    radius: float = 2.5,
    revisit: float = 0.12,
    focal: Optional[float] = None,
    workers: int = 1,
) -> Dict[str, np.ndarray]:
    """Reference-scale evaluation sequence: a long orbit through a textured
    courtyard that RETURNS to its start (``revisit`` extra fraction of the
    circle re-observes the first views) — the buffer≳100-keyframe,
    global-BA-with-loop-revisit regime the reference validates on
    (reference evaluation_scripts/test_eth3d.py:62 buffer 1024),
    which the 48-frame random-walk protocol never reaches.

    World: closed courtyard (floor + 4 walls + ceiling, rich textures) the
    camera orbits inside, yawing along the path tangent with small noise;
    exact GT like render_sequence. Deterministic per rng seed.

    ``workers`` > 1 raycasts contiguous blocks of frames on that many
    threads (the frames are independent once the world and the trajectory
    are drawn, and numpy's array operations run outside the GIL); the
    result is the same bit for bit.
    """
    H, W = image_size
    f = focal if focal is not None else 0.9 * W
    cx, cy = W / 2, H / 2
    intr = np.array([f, f, cx, cy], np.float32)

    # closed courtyard: normals chosen so every inward ray hits a surface.
    # Walls sit CLOSE to the orbit (~1 unit): near-field parallax is what
    # drives optical flow past the keyframe threshold at every resolution
    # (far walls gave 1-2 px at the 1/8 grid — below the 2.4 px gate — so
    # keyframing starved and inter-keyframe motion ballooned)
    half = radius + rng.uniform(0.8, 1.2)
    planes = [
        _Plane(rng, (0.0, 1.0, 0.0), rng.uniform(0.7, 1.0), rich=True),   # floor
        _Plane(rng, (0.0, 1.0, 0.0), -rng.uniform(1.0, 1.4), rich=True),  # ceiling
        _Plane(rng, (1.0, 0.0, 0.0), half, rich=True),    # wall x=+half
        _Plane(rng, (-1.0, 0.0, 0.0), half, rich=True),   # wall x=-half
        _Plane(rng, (0.0, 0.0, 1.0), half, rich=True),    # wall z=+half
        _Plane(rng, (0.0, 0.0, -1.0), half, rich=True),   # wall z=-half
    ]

    # orbit with revisit: total sweep (1+revisit)*2π. The camera faces
    # OUTWARD (radially, at the near wall ~1 unit away) while circling —
    # lateral translation against near-field content drives strong optical
    # flow at every resolution (a tangent-facing orbit stares down a 4-6
    # unit corridor: 1-2 px at the 1/8 grid, below the 2.4 px keyframe
    # gate, and keyframing starves — measured on the first cut)
    theta = (1.0 + revisit) * 2.0 * np.pi * np.arange(n_frames) / n_frames
    centers = np.stack([
        radius * np.sin(theta),
        0.12 * np.sin(3.1 * theta),  # gentle bobbing
        -radius * np.cos(theta),
    ], axis=-1)
    # smooth per-frame jitter so motion is not perfectly scripted
    jit = 0.015 * rng.standard_normal((n_frames, 3))
    for _ in range(4):  # cheap smoothing
        jit = 0.5 * jit + 0.25 * (np.roll(jit, 1, 0) + np.roll(jit, -1, 0))
    centers += jit

    outward = np.stack([np.sin(theta), np.zeros_like(theta), -np.cos(theta)], -1)
    yaw_noise = np.cumsum(0.004 * rng.standard_normal(n_frames))
    Rs = np.zeros((n_frames, 3, 3))
    for k in range(n_frames):
        z = outward[k] / np.linalg.norm(outward[k])
        c, s = np.cos(yaw_noise[k]), np.sin(yaw_noise[k])
        z = np.array([c * z[0] + s * z[2], z[1], -s * z[0] + c * z[2]])
        y = np.array([0.0, 1.0, 0.0])  # world +y is image-down (floor below)
        x = np.cross(y, z); x /= np.linalg.norm(x)
        y = np.cross(z, x)
        Rs[k] = np.stack([x, y, z], axis=-1)  # columns = camera axes

    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    d_cam = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], axis=-1)

    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        blocks = [b for b in np.array_split(np.arange(n_frames), workers) if len(b)]
        with ThreadPoolExecutor(len(blocks)) as pool:
            parts = list(pool.map(_render_frames, [planes] * len(blocks), [centers[b] for b in blocks],
                                  [Rs[b] for b in blocks], [d_cam] * len(blocks)))
        images, depths, poses = (np.concatenate(a) for a in zip(*parts))
    else:
        images, depths, poses = _render_frames(planes, centers, Rs, d_cam)

    return {
        "images": images,
        "poses": poses,
        "depths": depths,
        "intrinsics": np.tile(intr, (n_frames, 1)),
    }


class SyntheticDataset:
    """Trainer-facing stream of rendered clips (TartanAir.clips drop-in).

    ``pool`` pre-renders that many sequences and samples batches from them,
    re-rendering one pool slot per batch: host ray-casting would otherwise
    set the pace of the steps, while the pool keeps the device busy and
    still refreshes the data distribution continuously. pool=0 renders
    every batch fresh.
    """

    def __init__(
        self, n_frames: int = 7, image_size=(96, 128), seed: int = 0,
        pool: int = 256, varied_frac: float = 0.7,
    ):
        self.n_frames = n_frames
        self.image_size = image_size
        self.rng = np.random.default_rng(seed)
        self.pool_size = pool
        self._pool = None
        # fraction of clips rendered with the VARIED curriculum (rich
        # textures, extra planes, motion modes); the rest keep the basic
        # eval-style worlds so the distribution the accuracy protocol
        # samples stays in-support
        self.varied_frac = varied_frac

    def _render(self):
        # per-sequence motion scale, log-uniform: inter-frame flow at the
        # 1/8 feature grid spans ~0.3-4 px — the regime the reference's
        # TartanAir covisibility sampling targets (fmin/fmax on 1/8-res
        # flow, base.py:106-119) and the keyframe threshold was tuned for.
        # (First training run used a fixed tiny scale -> the trained filter
        # never saw super-threshold flow and keyframing never triggered.)
        t_sigma = float(np.exp(self.rng.uniform(np.log(0.08), np.log(0.5))))
        r_sigma = float(np.exp(self.rng.uniform(np.log(0.008), np.log(0.05))))
        return render_sequence(
            self.rng, self.n_frames, self.image_size,
            t_sigma=t_sigma, r_sigma=r_sigma,
            varied=bool(self.rng.random() < self.varied_frac),
        )

    def clips(self, batch: int):
        if self.pool_size:
            if self._pool is None:
                self._pool = [self._render() for _ in range(self.pool_size)]
        while True:
            if self.pool_size:
                idx = self.rng.choice(self.pool_size, size=batch, replace=False)
                seqs = [self._pool[i] for i in idx]
                # continuous refresh: one new scene per batch
                self._pool[int(self.rng.integers(self.pool_size))] = self._render()
            else:
                seqs = [self._render() for _ in range(batch)]
            yield {
                "images": np.stack([s["images"] for s in seqs]),
                "poses": np.stack([s["poses"] for s in seqs]),
                "disps": np.stack([1.0 / s["depths"] for s in seqs]),
                "intrinsics": np.stack([s["intrinsics"] for s in seqs]),
            }
