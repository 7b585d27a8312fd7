"""Port parity for stereo: tracking, ``terminate()`` and
``terminate(stream)`` with a rig of two images per frame.

The replay of tests/test_engine_equivalence.py::test_stereo_edge_sets_agree
(its configuration with ``stereo=True`` and buffer 16, 6 seeded random
64×64 stereo pairs, random weights from PRNGKey(0)) goes through the JAX
fused ``Droid`` and through the port's ``Droid`` on the CPU with the same
weights. Both must make the same keyframes and active and inactive edges
(stereo self edges among them), and agree on poses within 5e-3 and
disparities within 1e-2 (the bounds of tests/test_engine_equivalence.py).
Then ``terminate()`` (global BA over self edges too, no gauge fix) and
``terminate(stream)`` (the trajectory filler over the left images of 6
frames between the keyframes) must match the JAX package within 5e-3. The
port's convolutions take PyTorch's native path (oneDNN off), as in
tests/test_torch_track.py.
"""

import functools

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

# tests/test_engine_equivalence.py::make_config, then stereo=True, buffer=16
CONFIG = dict(
    image_size=(64, 64),
    buffer=16,
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
    stereo=True,
)
INTR = np.array([64.0, 64.0, 32.0, 32.0], np.float32)
N_FRAMES = 6


def _edge_set(ii, jj, valid):
    return {(int(i), int(j)) for i, j, v in zip(np.asarray(ii), np.asarray(jj), np.asarray(valid)) if v}


@functools.lru_cache(maxsize=None)
def _run():
    rng = np.random.default_rng(4321)
    pairs = [rng.integers(0, 255, (2, 64, 64, 3), np.uint8) for _ in range(N_FRAMES)]
    # the frames between the keyframes: the left images, half a step on
    stream = [(t + 0.5, pairs[t][0], INTR) for t in range(N_FRAMES)]
    params = jinit_params(jax.random.PRNGKey(0))

    jd = JDroid(JDroidConfig(**CONFIG), params=params)
    for t, pair in enumerate(pairs):
        jd.track(t, jnp.asarray(pair), intrinsics=jnp.asarray(INTR))
    st = jd._fused_state
    n = int(st.counter)
    want = dict(
        counter=n,
        tstamps=np.asarray(st.tstamp[:n]),
        poses=np.asarray(st.poses[:n]),
        disps=np.asarray(st.disps[:n]),
        edges=_edge_set(st.ii, st.jj, st.valid),
        inactive=_edge_set(st.inac_ii, st.inac_jj, st.inac_valid),
        traj=np.asarray(jd.terminate()),
        fill=np.asarray(jd.terminate(iter(stream))),
    )

    pd = Droid(DroidConfig(**CONFIG), params=params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
               device="cpu")
    with torch.backends.mkldnn.flags(enabled=False):
        for t, pair in enumerate(pairs):
            pd.track(t, pair, intrinsics=INTR)
        got = dict(
            counter=pd.counter,
            tstamps=pd.tstamps.numpy(),
            poses=pd.poses.numpy().copy(),
            disps=pd.disps.numpy().copy(),
            edges=pd.edges,
            inactive=pd.inactive_edges,
            traj=pd.terminate(),
            fill=pd.terminate(iter(stream)),
            rig=tuple(pd._state.fmaps.shape[:2]),
        )
    return want, got


def test_stereo_same_keyframes_and_edges():
    want, got = _run()
    assert got["rig"] == (16, 2)
    assert got["counter"] == want["counter"] == N_FRAMES
    np.testing.assert_array_equal(got["tstamps"], want["tstamps"])
    assert got["edges"] == want["edges"], (
        f"port-only {sorted(got['edges'] - want['edges'])}, "
        f"jax-only {sorted(want['edges'] - got['edges'])}"
    )
    assert got["inactive"] == want["inactive"]
    # the stereo self edges are in the graph
    assert any(i == j for i, j in want["edges"] | want["inactive"])


def test_stereo_pose_and_disp_agreement():
    want, got = _run()
    assert np.abs(got["poses"] - want["poses"]).max() < 5e-3
    assert np.abs(got["disps"] - want["disps"]).max() < 1e-2


@pytest.mark.parametrize("what", ["traj", "fill"])
def test_stereo_terminate_matches_jax(what):
    want, got = _run()
    assert got[what].shape == want[what].shape == (N_FRAMES, 7)
    assert np.isfinite(got[what]).all()
    assert np.abs(got[what] - want[what]).max() < 5e-3


def test_stereo_track_rejects_a_single_image():
    d = Droid(DroidConfig(**CONFIG), device="cpu")
    with pytest.raises(ValueError, match="2 image"):
        d.track(0, np.zeros((64, 64, 3), np.uint8), intrinsics=INTR)



def test_stereo_proximity_candidates_match_jax():
    """The candidate list with stereo self edges, in the JAX package's
    order, on tests/test_torch_graph.py's seeded state."""
    from droid_slam_tpu.runtime import fused as jfused
    from droid_slam_tpu_torch.runtime import fused as tfused
    from test_torch_graph import COUNTER, _jax_state, _port_state

    jst = _jax_state(2)
    pst = _port_state(jst)
    kw = dict(rad=2, nms=1, thresh=50.0, beta=0.3, max_factors=40)
    want = jfused._proximity_candidates(jst, jnp.int32(COUNTER - 5), jnp.int32(1), 5, 8, stereo=True, **kw)
    got = tfused._proximity_candidates(pst, COUNTER - 5, 1, 5, 8, stereo=True, **kw)
    wi, wj, wok = (np.asarray(a) for a in want)
    gi, gj, gok = (a.numpy() for a in got)
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_array_equal(gi[wok], wi[wok])
    np.testing.assert_array_equal(gj[wok], wj[wok])
    n_base = 5 * (1 + 3 * 2)
    assert (gi[:n_base:7] == gj[:n_base:7]).all()  # each row starts with its self edge
    assert not (gi[n_base:] == gj[n_base:])[gok[n_base:]].any()  # no greedy self edges
    assert wok[n_base:].any()  # some greedy picks were made
