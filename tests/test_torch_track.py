"""Port parity for the slice as a whole: per-frame fused tracking.

Ten seeded 64×64 frames (generated as in tests/test_engine_equivalence.py)
go through the JAX fused ``Droid`` (random weights from PRNGKey(0)) and
through the port's ``Droid`` on the CPU with the same weights, once
monocular and once with a seeded RGB-D depth prior (80% of the pixels) and
full-resolution disparity upsampling on. Both must make the same
keyframes, the same active and inactive edge sets, and agree on poses
within 5e-3 and disparities (also the upsampled ones) within 1e-2 (the
bounds of tests/test_engine_equivalence.py).

The replay is knife-edge sensitive: with random weights some pixels sit on
the per-pixel depth-validity thresholds of the projection and the BA, where
a one-ulp difference flips a mask. oneDNN's convolution reduction order
depends on the thread count and flips one such pixel at 2 and 8 threads, so
the port's convolutions here take PyTorch's native path, whose agreement
with XLA holds at every thread count tried (1, 2, 4, 8).
"""

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

# tests/test_engine_equivalence.py::make_config
CONFIG = dict(
    image_size=(64, 64),
    buffer=32,
    warmup=4,
    max_factors=24,
    inactive_pad=16,
    window_pad=16,
    schur_pair_floor=512,
    filter_thresh=-1.0,  # random weights: keyframe every frame
    keyframe_thresh=0.0,  # never cull
    frontend_window=8,
    frontend_thresh=1e9,
    backend_thresh=1e9,
    compute_dtype="float32",
)


def _frames(rgbd: bool):
    rng = np.random.default_rng(1234)
    drng = np.random.default_rng(99)
    frames = []
    for t in range(10):
        img = rng.integers(0, 255, (64, 64, 3), np.uint8)
        depth = None
        if rgbd:
            depth = (1.0 + 2.0 * drng.random((64, 64))) * (drng.random((64, 64)) > 0.2)
            depth = depth.astype(np.float32)
        frames.append((t, img, depth, np.array([64.0, 64.0, 32.0, 32.0], np.float32)))
    return frames


def _edge_set(ii, jj, valid):
    return {(int(i), int(j)) for i, j, v in zip(np.asarray(ii), np.asarray(jj), np.asarray(valid)) if v}


@pytest.fixture(scope="module", params=["mono", "rgbd_upsample"])
def results(request):
    params = jinit_params(jax.random.PRNGKey(0))
    rgbd = request.param == "rgbd_upsample"
    config = dict(CONFIG, upsample=rgbd)
    frames = _frames(rgbd)

    jd = JDroid(JDroidConfig(**config), params=params)
    for t, img, depth, intr in frames:
        jdepth = None if depth is None else jnp.asarray(depth)
        jd.track(t, jnp.asarray(img), depth=jdepth, intrinsics=jnp.asarray(intr))
    st = jd._fused_state
    n = int(st.counter)
    want = {
        "counter": n,
        "tstamps": np.asarray(st.tstamp[:n]),
        "poses": np.asarray(st.poses[:n]),
        "disps": np.asarray(st.disps[:n]),
        "disps_up": np.asarray(st.disps_up[:n]) if rgbd else None,
        "edges": _edge_set(st.ii, st.jj, st.valid),
        "inactive": _edge_set(st.inac_ii, st.inac_jj, st.inac_valid),
    }

    pd = Droid(
        DroidConfig(**config),
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
        device="cpu",
    )
    with torch.backends.mkldnn.flags(enabled=False):
        for t, img, depth, intr in frames:
            pd.track(t, img, depth=depth, intrinsics=intr)
    got = {
        "counter": pd.counter,
        "tstamps": pd.tstamps.numpy(),
        "poses": pd.poses.numpy(),
        "disps": pd.disps.numpy(),
        "disps_up": pd._state.disps_up[: pd.counter].numpy() if rgbd else None,
        "edges": pd.edges,
        "inactive": pd.inactive_edges,
    }
    return want, got


def test_same_keyframes(results):
    want, got = results
    assert got["counter"] == want["counter"] == 10
    np.testing.assert_array_equal(got["tstamps"], want["tstamps"])


def test_same_edge_sets(results):
    want, got = results
    assert got["edges"] == want["edges"], (
        f"port-only {sorted(got['edges'] - want['edges'])}, "
        f"jax-only {sorted(want['edges'] - got['edges'])}"
    )
    assert got["inactive"] == want["inactive"]
    assert len(want["inactive"]) > 0  # the inactive ring was exercised


def test_pose_and_disp_agreement(results):
    want, got = results
    dp = np.abs(got["poses"] - want["poses"]).max()
    dd = np.abs(got["disps"] - want["disps"]).max()
    assert dp < 5e-3, dp
    assert dd < 1e-2, dd
    if want["disps_up"] is not None:
        assert got["disps_up"].shape == want["disps_up"].shape == (10, 64, 64)
        assert np.abs(want["disps_up"]).max() > 0  # the upsampling ran
        assert np.abs(got["disps_up"] - want["disps_up"]).max() < 1e-2
