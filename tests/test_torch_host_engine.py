"""Port parity for the host-driven engine, ``Droid(fused=False)``.

* Replays through the JAX package's host engine and the port's on the CPU,
  with the same random weights (``init_params(PRNGKey(0))``): the 10 seeded
  64×64 frames of tests/test_engine_equivalence.py (monocular, and again
  with a seeded RGB-D depth prior on 80% of the pixels), and its 6 stereo
  pairs. Both must make the same keyframes and the same active and inactive
  edges, and agree on poses within 5e-3 and disparities within 1e-2 (the
  bounds of tests/test_engine_equivalence.py). Measured on the monocular
  replay: poses 1.2e-5, disparities 2.0e-4. The monocular replay also goes
  through the port's fused engine, which must agree with its host engine
  the same way.
* The engine's modules against their JAX counterparts on seeded inputs: the
  motion probe's scalar (relative 1e-5; the port looks up through
  ``corr_lookup``, the JAX package builds the all-pairs volume),
  ``VideoState.append`` / ``set_pose`` / ``set_disp`` (bitwise) and
  ``reproject``, ``FactorGraph.rm_keyframe`` (bookkeeping and every shifted
  buffer, the damping among them, bitwise), ``add_neighborhood_factors`` and
  ``filter_edges``.
* Marked slow: the trained-fixture cull replay of
  tests/test_engine_equivalence.py:149-195 through both host engines.

The port's convolutions take PyTorch's native path (oneDNN off), as in
tests/test_torch_track.py.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.models.droid_net import init_params as jinit_params
from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.runtime import Droid as JDroid
from droid_slam_tpu.runtime import DroidConfig as JDroidConfig
from droid_slam_tpu.runtime import factor_graph as jfg
from droid_slam_tpu.runtime import motion_filter as jmf
from droid_slam_tpu.runtime import video as jvideo
from droid_slam_tpu_torch.data.synthetic import render_sequence
from droid_slam_tpu_torch.models.droid_net import DroidNet
from droid_slam_tpu_torch.models.weights import params_from_jax
from droid_slam_tpu_torch.runtime import Droid, DroidConfig
from droid_slam_tpu_torch.runtime import factor_graph as tfg
from droid_slam_tpu_torch.runtime import motion_filter as tmf
from droid_slam_tpu_torch.runtime import video as tvideo

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "equivalence_fixture.msgpack")

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
INTR = np.array([64.0, 64.0, 32.0, 32.0], np.float32)


@functools.lru_cache(maxsize=None)
def _params():
    params = jinit_params(jax.random.PRNGKey(0))
    return params, params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _frames(variant: str):
    """(t, image, depth or None) items: the 10 frames of
    tests/test_engine_equivalence.py, with a depth prior for "rgbd"; its 6
    stereo pairs for "stereo"."""
    rng = np.random.default_rng(1234)
    if variant == "stereo":
        return [(t, rng.integers(0, 255, (2, 64, 64, 3), np.uint8), None) for t in range(6)]
    drng = np.random.default_rng(99)
    frames = []
    for t in range(10):
        img = rng.integers(0, 255, (64, 64, 3), np.uint8)
        depth = None
        if variant == "rgbd":
            depth = ((1.0 + 2.0 * drng.random((64, 64))) * (drng.random((64, 64)) > 0.2)).astype(np.float32)
        frames.append((t, img, depth))
    return frames


def _edge_set(ii, jj, valid):
    return {(int(i), int(j)) for i, j, v in zip(np.asarray(ii), np.asarray(jj), np.asarray(valid)) if v}


def _config(variant: str) -> dict:
    if variant == "stereo":
        return dict(CONFIG, stereo=True, buffer=16)
    return CONFIG


@functools.lru_cache(maxsize=None)
def _replay(variant: str):
    """{engine: summary} for the JAX host engine ("jax"), the port's host
    engine ("host") and, monocular, the port's fused engine ("fused")."""
    jparams, tparams = _params()
    config = _config(variant)
    frames = _frames(variant)

    jd = JDroid(JDroidConfig(**config), params=jparams, fused=False)
    for t, img, depth in frames:
        jd.track(t, jnp.asarray(img), depth=None if depth is None else jnp.asarray(depth),
                 intrinsics=jnp.asarray(INTR))
    g, v = jd.frontend.graph, jd.video
    n = v.counter
    runs = {"jax": dict(counter=n, tstamps=np.asarray(v.tstamp[:n]), poses=np.asarray(v.poses[:n]),
                        disps=np.asarray(v.disps[:n]), edges=_edge_set(g.ii, g.jj, g.valid),
                        inactive=_edge_set(g.ii_inac, g.jj_inac, g.valid_inac))}

    for engine in ("host", "fused") if variant == "mono" else ("host",):
        pd = Droid(DroidConfig(**config), params=tparams, device="cpu", fused=engine == "fused")
        with torch.backends.mkldnn.flags(enabled=False):
            for t, img, depth in frames:
                pd.track(t, img, depth=depth, intrinsics=INTR)
        runs[engine] = dict(counter=pd.counter, tstamps=pd.tstamps.numpy(), poses=pd.poses.numpy(),
                            disps=pd.disps.numpy(), edges=pd.edges, inactive=pd.inactive_edges)
    return runs


def _assert_same_tracking(want, got):
    assert got["counter"] == want["counter"]
    np.testing.assert_array_equal(got["tstamps"], want["tstamps"])
    assert got["edges"] == want["edges"], (
        f"only in the port {sorted(got['edges'] - want['edges'])}, "
        f"only in the reference {sorted(want['edges'] - got['edges'])}"
    )
    assert got["inactive"] == want["inactive"]
    dp = np.abs(got["poses"] - want["poses"]).max()
    dd = np.abs(got["disps"] - want["disps"]).max()
    assert dp < 5e-3, dp
    assert dd < 1e-2, dd


@pytest.mark.parametrize("variant", ["mono", "rgbd", "stereo"])
def test_host_engine_matches_jax_host_engine(variant):
    runs = _replay(variant)
    want = runs["jax"]
    assert want["counter"] == len(_frames(variant))  # every frame keyframed
    assert len(want["inactive"]) > 0 or variant == "stereo"  # the inactive ring was used
    if variant == "stereo":
        assert any(i == j for i, j in want["edges"])  # self edges
    _assert_same_tracking(want, runs["host"])


def test_port_host_engine_matches_port_fused_engine():
    runs = _replay("mono")
    _assert_same_tracking(runs["fused"], runs["host"])


def test_rgbd_prior_seeds_the_host_engine():
    # tests/test_runtime.py::test_rgbd_depth_prior_seeds_disparity's check,
    # on the port: the prior's inverse depth (1/1 to 1/3) pulls the
    # disparities off their initial 1.0
    got = _replay("rgbd")["host"]
    assert np.isfinite(got["disps"]).all()
    assert 1.0 / 3.0 < np.median(got["disps"]) < 0.95


def test_host_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Droid(DroidConfig(**CONFIG), fused=False)


# -----------------------------------------------------------------------------
# the engine's modules against the JAX package's
# -----------------------------------------------------------------------------


def test_motion_probe_matches_jax():
    jparams, tparams = _params()
    r = np.random.default_rng(3)
    h, w = 8, 12
    f32 = np.float32
    fprev, fnew = (r.standard_normal((2, h, w, 128)) * 2.0).astype(f32)
    net = np.tanh(r.standard_normal((h, w, 128))).astype(f32)
    inp = np.maximum(r.standard_normal((h, w, 128)), 0).astype(f32)
    want = float(jmf._motion_probe(jparams, *(jnp.asarray(a) for a in (fprev, net, inp, fnew))))
    model = DroidNet()
    model.load_state_dict(tparams)
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        got = tmf._motion_probe(model.update, *(torch.from_numpy(a) for a in (fprev, net, inp, fnew)))
    assert got.dim() == 0 and want > 0
    assert abs(float(got) - want) <= 1e-5 * want, (float(got), want)


VIDEO_CONFIG = dict(image_size=(32, 48), buffer=10, max_factors=16, inactive_pad=8, window_pad=16,
                    compute_dtype="float32")
VIDEO_BUFFERS = ("tstamp", "images", "poses", "disps", "disps_sens", "disps_up", "intrinsics",
                 "fmaps", "nets", "inps")


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to values that bf16 holds exactly."""
    return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()


def test_video_append_matches_jax():
    cfg = dict(VIDEO_CONFIG, buffer=4)
    jv = jvideo.VideoState(JDroidConfig(**cfg))
    tv = tvideo.VideoState(DroidConfig(**cfg), "cpu")
    r = np.random.default_rng(4)
    for k in range(3):
        img = r.integers(0, 255, (32, 48, 3), np.uint8)
        depth = (1.0 + r.random((32, 48))).astype(np.float32) * (r.random((32, 48)) > 0.3) if k != 1 else None
        intr = (r.random(4) * 8).astype(np.float32)
        # the features arrive in bf16: the buffers cast them to f32
        fmap = _bf16_exact(r.standard_normal((1, 4, 6, 128)))
        net, inp = r.standard_normal((2, 4, 6, 128)).astype(np.float32)
        pose = np.array([0.1 * k, 0, 0, 0, 0, 0, 1], np.float32) if k == 0 else None
        disp = 1.0 if k == 0 else None
        jv.append(float(k) + 0.5, jnp.asarray(img), None if pose is None else jnp.asarray(pose), disp,
                  None if depth is None else jnp.asarray(depth), jnp.asarray(intr),
                  jnp.asarray(fmap, jnp.bfloat16), jnp.asarray(net), jnp.asarray(inp))
        tv.append(float(k) + 0.5, torch.from_numpy(img), None if pose is None else torch.from_numpy(pose),
                  disp, None if depth is None else torch.from_numpy(depth), torch.from_numpy(intr),
                  torch.from_numpy(fmap).bfloat16(), torch.from_numpy(net), torch.from_numpy(inp))
    pose = np.array([0.3, -0.1, 0.2, 0, 0, 0.0998, 0.995], np.float32)
    disp = r.random((4, 6)).astype(np.float32)
    for ix in (2, 4):  # slot 4 is past the buffer: dropped by both
        jv.set_pose(ix, jnp.asarray(pose))
        jv.set_disp(ix, jnp.asarray(disp))
        tv.set_pose(ix, torch.from_numpy(pose))
        tv.set_disp(ix, torch.from_numpy(disp))
    assert tv.counter == jv.counter == 3
    np.testing.assert_array_equal(tv.dirty, jv.dirty)
    for name in VIDEO_BUFFERS:
        want = np.asarray(getattr(jv, name))
        got = getattr(tv, name).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name

    want_c, want_v = jv.reproject([0, 1, 2], [1, 2, 0])
    got_c, got_v = tv.reproject([0, 1, 2], [1, 2, 0])
    assert np.abs(got_c.numpy() - np.asarray(want_c)).max() < 1e-5
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _seeded_videos(seed: int, stereo: bool = False, counter: int = 8):
    """A JAX and a port VideoState holding the same seeded buffers."""
    cfg = dict(VIDEO_CONFIG, stereo=stereo)
    jv = jvideo.VideoState(JDroidConfig(**cfg))
    tv = tvideo.VideoState(DroidConfig(**cfg), "cpu")
    r = np.random.default_rng(seed)
    B, (h, w) = jv.poses.shape[0], jv.disps.shape[1:]
    xi = np.concatenate([0.05 * r.standard_normal((B, 3)), 0.01 * r.standard_normal((B, 3))], -1)
    values = dict(
        tstamp=np.arange(B, dtype=np.float32),
        poses=np.asarray(jlie.exp(jnp.asarray(xi, jnp.float32))),
        disps=(0.5 + r.random((B, h, w))).astype(np.float32),
        intrinsics=np.tile([[w * 0.9, w * 0.9, w / 2, h / 2]], (B, 1)).astype(np.float32),
    )
    for name in VIDEO_BUFFERS:
        if name not in values:
            shape = np.asarray(getattr(jv, name)).shape
            values[name] = (r.integers(0, 255, shape).astype(np.uint8) if name == "images"
                            else r.standard_normal(shape).astype(np.float32))
    for name, value in values.items():
        setattr(jv, name, jnp.asarray(value))
        setattr(tv, name, torch.from_numpy(value.copy()))
    jv.counter = tv.counter = counter
    return jv, tv


def _seeded_graphs(seed: int):
    """JAX and port factor graphs over the same seeded video: 12 edges, 4 of
    them retired to the inactive ring, two bad edges and seeded damping."""
    jv, tv = _seeded_videos(seed)
    kw = dict(max_factors=16, inactive_pad=8, window_pad=16, edge_pad=16)
    jg = jfg.FactorGraph(jv, None, schur_pair_floor=512, **kw)
    tg = tfg.FactorGraph(tv, None, **kw)
    r = np.random.default_rng(seed + 1)
    ii = np.array([0, 1, 2, 3, 4, 5, 6, 7, 2, 3, 5, 7], np.int32)
    jj = np.array([1, 2, 3, 4, 5, 6, 7, 6, 0, 1, 2, 4], np.int32)
    damping = (1e-3 * r.random(np.asarray(jg.damping).shape)).astype(np.float32)
    for g, dev in ((jg, jnp.asarray), (tg, lambda a: torch.from_numpy(a.copy()))):
        g.add_factors(ii, jj)
        g.rm_factors(np.isin(np.arange(16), [1, 4, 8, 10]), store=True)
        g.bad_edges = {(1, 5), (2, 6), (7, 2)}
        g.damping = dev(damping)
    return jg, tg


def _assert_same_bookkeeping(jg, tg):
    for name in ("ii", "jj", "age", "valid", "ii_inac", "jj_inac", "valid_inac"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name), err_msg=name)
    assert tg.inac_next == jg.inac_next
    assert tg.bad_edges == jg.bad_edges
    for state in ("edges", "inactive"):
        for name in ("ii", "jj", "valid"):
            want = np.asarray(getattr(getattr(jg, state), name))
            np.testing.assert_array_equal(getattr(getattr(tg, state), name).numpy(), want, err_msg=name)
        for name in ("target", "weight"):
            want = np.asarray(getattr(getattr(jg, state), name))
            got = getattr(getattr(tg, state), name).numpy()
            assert np.abs(got - want).max() < 1e-5, (state, name)


@pytest.mark.parametrize("ix", [2, 7])
def test_rm_keyframe_matches_jax(ix):
    jg, tg = _seeded_graphs(5)
    _assert_same_bookkeeping(jg, tg)
    jg.rm_keyframe(ix)
    tg.rm_keyframe(ix)
    _assert_same_bookkeeping(jg, tg)
    assert len(tg.bad_edges) < 3  # the bad edges touching ix were dropped
    for name in VIDEO_BUFFERS:
        want = np.asarray(getattr(jg.video, name))
        assert np.array_equal(getattr(tg.video, name).numpy(), want), name
    assert np.array_equal(tg.damping.numpy(), np.asarray(jg.damping))  # shifted too


@pytest.mark.parametrize("stereo", [False, True])
def test_add_neighborhood_factors_matches_jax(stereo):
    jv, tv = _seeded_videos(6, stereo=stereo)
    kw = dict(max_factors=16, inactive_pad=8, window_pad=16, edge_pad=40)
    jg = jfg.FactorGraph(jv, None, schur_pair_floor=512, **kw)
    tg = tfg.FactorGraph(tv, None, **kw)
    jg.add_neighborhood_factors(1, 8, r=3)
    tg.add_neighborhood_factors(1, 8, r=3)
    _assert_same_bookkeeping(jg, tg)
    gaps = {abs(i - j) for i, j in tg.edge_set}
    assert gaps == ({2, 3} if stereo else {1, 2, 3})


def test_filter_edges_matches_jax():
    jv, tv = _seeded_videos(7)
    kw = dict(max_factors=16, inactive_pad=8, window_pad=16, edge_pad=16)
    jg = jfg.FactorGraph(jv, None, schur_pair_floor=512, **kw)
    tg = tfg.FactorGraph(tv, None, **kw)
    ii = np.asarray([0, 1, 0, 1], np.int32)
    jj = np.asarray([1, 3, 5, 7], np.int32)  # 1, 2, 5 and 6 apart
    w = np.zeros((16, 4, 6, 2), np.float32)
    w[3] = 0.9  # one confident long edge: (1, 7) stays
    jg.add_factors(ii, jj)
    tg.add_factors(ii, jj)
    jg.edges = jg.edges._replace(weight=jnp.asarray(w))
    tg.edges.weight = torch.from_numpy(w)
    jg.filter_edges()
    tg.filter_edges()
    _assert_same_bookkeeping(jg, tg)
    assert _edge_set(tg.ii, tg.jj, tg.valid) == {(0, 1), (1, 3), (1, 7)}
    assert tg.bad_edges == {(0, 5)}


# -----------------------------------------------------------------------------
# trained weights: the cull branch
# -----------------------------------------------------------------------------


@pytest.mark.slow
def test_trained_cull_replay_matches_jax_host_engine():
    """tests/test_engine_equivalence.py:149-195 through both host engines:
    every frame appended, the fixture's weights and a real keyframe
    threshold, so the culls are the decisions; the same keyframes after
    every frame, at least one cull, poses within 5e-3."""
    n_frames = 26
    seq = render_sequence(np.random.default_rng(7), n_frames=n_frames, image_size=(96, 128),
                          t_sigma=0.25, r_sigma=0.02)
    config = dict(image_size=(96, 128), buffer=32, warmup=8, max_factors=48, inactive_pad=64, window_pad=32,
                  schur_pair_floor=1024, filter_thresh=-1.0, keyframe_thresh=2.0, frontend_window=16,
                  frontend_thresh=16.0, compute_dtype="float32")
    jd = JDroid(JDroidConfig(**config), weights=FIXTURE, fused=False)
    pd = Droid(DroidConfig(**config), weights=FIXTURE, device="cpu", fused=False)
    for t in range(n_frames):
        jd.track(t, jnp.asarray(seq["images"][t]), intrinsics=jnp.asarray(seq["intrinsics"][t]))
        with torch.backends.mkldnn.flags(enabled=False):
            pd.track(t, seq["images"][t], intrinsics=seq["intrinsics"][t])
        want = np.asarray(jd.video.tstamp[: jd.video.counter])
        assert pd.tstamps.tolist() == want.tolist(), t
    assert pd.counter < n_frames  # some keyframe was culled
    assert np.abs(pd.poses.numpy() - np.asarray(jd.video.poses[: jd.video.counter])).max() < 5e-3
