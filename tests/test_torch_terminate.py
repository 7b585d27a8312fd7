"""Port parity for the slice as a whole: ``Droid.terminate``.

The configuration, weights and frames of tests/test_regression.py (copied,
not imported): 10 smooth synthetic 64×64 frames tracked by the JAX fused
``Droid`` and by the port's ``Droid`` on the CPU with the same weights, then
``terminate()`` (global BA, 7 + 12 steps) and ``terminate(stream)`` (the
same again, then the trajectory filler over 10 frames with timestamps
between the keyframes). Once monocular, where the backend fixes the gauge
with ``normalize()``, and once with a seeded RGB-D depth prior (80% of the
pixels) and full-resolution disparity upsampling, where it does not and the
BA adds the prior's α term.

``terminate()`` must match the JAX package within 1e-3 (the bound of
tests/test_regression.py) and, monocular, the committed
tests/trajectory_regression.npz within 1e-3; ``terminate(stream)`` must
match the JAX package within 5e-3. The port's convolutions take PyTorch's
native path (oneDNN off), as in tests/test_torch_track.py.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.models.droid_net import init_params as jinit_params
from droid_slam_tpu.runtime import Droid as JDroid
from droid_slam_tpu.runtime import DroidConfig as JDroidConfig
from droid_slam_tpu_torch.models.weights import params_from_jax
from droid_slam_tpu_torch.runtime import Droid, DroidConfig

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "trajectory_regression.npz")

# tests/test_regression.py::CHILD
CONFIG = dict(
    image_size=(64, 64),
    buffer=24,
    warmup=4,
    max_factors=16,
    inactive_pad=16,
    window_pad=16,
    schur_pair_floor=512,
    filter_thresh=-1.0,
    keyframe_thresh=0.0,
    frontend_window=8,
    frontend_thresh=1e9,
    backend_thresh=1e9,
    frontend_iters1=2,
    frontend_iters2=1,
    compute_dtype="float32",
)
INTR = np.array([64.0, 64.0, 32.0, 32.0], np.float32)


def _inputs(rgbd: bool):
    rng = np.random.default_rng(5432)
    base = rng.integers(0, 255, (10, 10, 3)).astype(np.float32)
    big = np.kron(base, np.ones((8, 8, 1)))[:64, :64]
    frames = [np.roll(big, shift=2 * t, axis=1).astype(np.uint8) for t in range(10)]
    drng = np.random.default_rng(99)
    depths = [
        ((1.0 + 2.0 * drng.random((64, 64))) * (drng.random((64, 64)) > 0.2)).astype(np.float32)
        if rgbd else None
        for _ in range(10)
    ]
    # the frames between the keyframes: half a step further along
    stream = [(t + 0.5, np.roll(big, shift=2 * t + 1, axis=1).astype(np.uint8), INTR)
              for t in range(10)]
    return frames, depths, stream


@functools.lru_cache(maxsize=None)
def _run(variant: str):
    rgbd = variant == "rgbd_upsample"
    config = dict(CONFIG, upsample=rgbd)
    frames, depths, stream = _inputs(rgbd)
    params = jinit_params(jax.random.PRNGKey(7), image_size=(64, 64))

    jd = JDroid(JDroidConfig(**config), params=params)
    for t in range(10):
        d = None if depths[t] is None else jnp.asarray(depths[t])
        jd.track(t, jnp.asarray(frames[t]), depth=d, intrinsics=jnp.asarray(INTR))
    want = dict(traj=np.asarray(jd.terminate()))
    want["fill"] = np.asarray(jd.terminate(iter(stream)))
    want["disps_up"] = np.asarray(jd.video.disps_up[:10]) if rgbd else None

    pd = Droid(DroidConfig(**config), params=params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
               device="cpu")
    with torch.backends.mkldnn.flags(enabled=False):
        for t in range(10):
            pd.track(t, frames[t], depth=depths[t], intrinsics=INTR)
        tracked = pd.poses.clone()
        got = dict(traj=pd.terminate())
        got["fill"] = pd.terminate(iter(stream))
    got["disps_up"] = pd.video.disps_up[:10].numpy() if rgbd else None
    got["tracked_unchanged"] = torch.equal(pd.poses, tracked)
    return want, got


VARIANTS = ["mono", "rgbd_upsample"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_terminate_matches_jax(variant):
    want, got = _run(variant)
    assert got["traj"].shape == want["traj"].shape == (10, 7)
    assert np.isfinite(got["traj"]).all()
    assert np.abs(got["traj"] - want["traj"]).max() < 1e-3
    # terminate works on a copy: the tracked state is untouched
    assert got["tracked_unchanged"]


def test_terminate_matches_regression_fixture():
    want = np.load(FIXTURE)["traj"]
    _, got = _run("mono")
    assert got["traj"].shape == want.shape
    assert np.abs(got["traj"] - want).max() < 1e-3


@pytest.mark.parametrize("variant", VARIANTS)
def test_terminate_stream_matches_jax(variant):
    want, got = _run(variant)
    assert got["fill"].shape == want["fill"].shape == (10, 7)
    assert np.abs(got["fill"] - want["fill"]).max() < 5e-3
    # the filled frames lie between the keyframes, not on them
    assert np.abs(got["fill"] - got["traj"]).max() > 1e-4


def test_terminate_maintains_upsampled_disparities():
    want, got = _run("rgbd_upsample")
    assert got["disps_up"].shape == (10, 64, 64)
    assert np.abs(want["disps_up"]).max() > 0
    assert np.abs(got["disps_up"] - want["disps_up"]).max() < 1e-2
