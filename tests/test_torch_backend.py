"""Port parity for the global backend: the Schur pair schedule, the
block-sparse Gauss-Newton BA and one ``DroidBackend`` run against the JAX
package, on seeded inputs.

The pair schedule must match exactly. The BA must match at 1e-4 L∞ in f32
(full, motion-only, with an RGB-D prior). With the Schur blocks stored in
bfloat16 both packages round E, E·Q and dx to bf16 at the same places, but
their f32 sums run in other orders, so an input to a bf16 rounding can
differ by an ulp and its rounding by 2⁻⁸ relative; the bound is 1e-3
(observed: at most 2e-6 on four seeds). The backend
run (proximity edges over a tracked RGB-D replay, then 2 global-BA steps)
must pick the same edge set and agree on poses within 5e-3 and disparities
within 1e-2 (the bounds of tests/test_engine_equivalence.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.models.droid_net import init_params as jinit_params
from droid_slam_tpu.ops import ba as jba
from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.ops import projective as jpops
from droid_slam_tpu.runtime import Droid as JDroid
from droid_slam_tpu.runtime import DroidConfig as JDroidConfig
from droid_slam_tpu.runtime import backend as jbackend
from droid_slam_tpu.runtime import factor_graph as jfg
from droid_slam_tpu_torch.models.droid_net import DroidNet
from droid_slam_tpu_torch.models.weights import params_from_jax
from droid_slam_tpu_torch.ops import ba as tba
from droid_slam_tpu_torch.runtime import DroidConfig
from droid_slam_tpu_torch.runtime import backend as tbackend
from droid_slam_tpu_torch.runtime import factor_graph as tfg
from droid_slam_tpu_torch.runtime.video import VideoState

torch.set_num_threads(2)

# -----------------------------------------------------------------------------
# pair schedule
# -----------------------------------------------------------------------------


def _edges(seed, F=12, N=40):
    r = np.random.default_rng(seed)
    ii = r.integers(0, F, N).astype(np.int32)
    jj = r.integers(0, F, N).astype(np.int32)
    valid = r.random(N) < 0.8
    return ii, jj, valid


def test_pair_schedule_matches_jax():
    r = np.random.default_rng(31)
    blk_k = r.integers(0, 9, 60)
    blk_ok = r.random(60) < 0.7
    for a, b in zip(jba.pair_schedule(blk_k, blk_ok), tba.pair_schedule(blk_k, blk_ok)):
        np.testing.assert_array_equal(a, b)
    empty = tba.pair_schedule(blk_k, np.zeros(60, bool))
    assert all(x.size == 0 for x in empty)


@pytest.mark.parametrize("t0,t1,window", [(1, 12, 16), (3, 9, 8), (0, 5, 32)])
def test_schur_pairs_match_jax(t0, t1, window):
    ii, jj, valid = _edges(32)
    want = jba.SchurPairs.build(ii, jj, valid, t0, t1, window, pad_floor=16)
    got = tba.SchurPairs.build(ii, jj, valid, t0, t1, window)
    n = int(np.asarray(want.pair_valid).sum())
    assert n > 0 and not np.asarray(want.pair_valid)[n:].any()
    np.testing.assert_array_equal(np.asarray(want.pair_a)[:n], got.pair_a.numpy())
    np.testing.assert_array_equal(np.asarray(want.pair_b)[:n], got.pair_b.numpy())


# -----------------------------------------------------------------------------
# block-sparse BA
# -----------------------------------------------------------------------------

F, h, w = 8, 6, 8
T0, T1, WINDOW = 1, 7, 8


def _problem(seed, with_sens):
    r = np.random.default_rng(seed)
    f32 = np.float32
    xi = np.concatenate([0.05 * r.standard_normal((F, 3)), 0.02 * r.standard_normal((F, 3))], -1)
    poses = np.array(jlie.exp(jnp.asarray(xi, jnp.float32)))
    disps = (0.5 + r.random((F, h, w))).astype(f32)
    intr = np.array([w * 0.9, w * 0.9, w / 2, h / 2], f32)
    # frame 7 is outside the pose window but is the source of an edge, so
    # its depths move; the last edge is invalid
    ii = np.array([1, 2, 2, 3, 3, 4, 5, 6, 4, 6, 0, 7, 5], np.int32)
    jj = np.array([2, 1, 3, 2, 4, 3, 4, 5, 6, 4, 1, 6, 0], np.int32)
    valid = np.ones(len(ii), bool)
    valid[-1] = False
    coords, _ = jpops.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps), jnp.broadcast_to(jnp.asarray(intr), (F, 4)),
        jnp.asarray(ii), jnp.asarray(jj),
    )
    target = (np.asarray(coords) + 0.5 * r.standard_normal(coords.shape)).astype(f32)
    weight = r.random(target.shape).astype(f32)
    eta = (1e-3 + 1e-2 * r.random((F, h, w))).astype(f32)
    sens = np.zeros((F, h, w), f32)
    if with_sens:
        sens[2:5] = (0.5 + r.random((3, h, w))).astype(f32)
        sens[3, :2] = 0.0  # partly missing depth
    return dict(poses=poses, disps=disps, intr=intr, sens=sens, target=target, weight=weight,
                eta=eta, ii=ii, jj=jj, valid=valid)


def _solve_both(pb, motion_only=False, schur="float32"):
    jpairs = jba.SchurPairs.build(pb["ii"], pb["jj"], pb["valid"], T0, T1, WINDOW, pad_floor=16)
    jprob = jba.BAProblem(
        target=jnp.asarray(pb["target"]), weight=jnp.asarray(pb["weight"]), eta=jnp.asarray(pb["eta"]),
        ii=jnp.asarray(pb["ii"]), jj=jnp.asarray(pb["jj"]), edge_valid=jnp.asarray(pb["valid"]),
        t0=jnp.int32(T0), t1=jnp.int32(T1), pairs=jpairs,
    )
    want = jba.ba_solve(
        jnp.asarray(pb["poses"]), jnp.asarray(pb["disps"]), jnp.asarray(pb["intr"]),
        jnp.asarray(pb["sens"]), jprob, WINDOW, iterations=2, motion_only=motion_only,
        schur_dtype=schur,
    )
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in pb.items()}
    tprob = tba.BAProblem(
        target=t["target"], weight=t["weight"], eta=t["eta"], ii=t["ii"].long(), jj=t["jj"].long(),
        edge_valid=t["valid"], t0=T0, t1=T1,
        pairs=tba.SchurPairs.build(pb["ii"], pb["jj"], pb["valid"], T0, T1, WINDOW),
    )
    got = tba.ba_solve(
        t["poses"], t["disps"], t["intr"], t["sens"], tprob, WINDOW, iterations=2,
        motion_only=motion_only, schur_dtype=getattr(torch, schur),
    )
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("case", ["full", "motion_only", "rgbd_prior"])
def test_ba_solve_matches_jax(case):
    pb = _problem(33, with_sens=case == "rgbd_prior")
    (wp, wd), (gp, gd) = _solve_both(pb, motion_only=case == "motion_only")
    # the solve moves things: a no-op port would fail
    assert np.abs(wp - pb["poses"]).max() > 1e-3
    assert np.abs(wp - gp).max() < 1e-4
    assert np.abs(wd - gd).max() < 1e-4
    if case == "motion_only":
        np.testing.assert_array_equal(gd, pb["disps"])
        assert np.abs(gp[T1:] - pb["poses"][T1:]).max() == 0.0
    else:
        assert np.abs(wd[7] - pb["disps"][7]).max() > 1e-4  # a source frame past t1
        assert gd.min() >= 0.001


def test_ba_solve_bf16_schur_matches_jax():
    pb = _problem(34, with_sens=False)
    (wp, wd), (gp, gd) = _solve_both(pb, schur="bfloat16")
    assert np.abs(wp - gp).max() < 1e-3
    assert np.abs(wd - gd).max() < 1e-3
    (fp, _), _ = _solve_both(pb)
    assert np.abs(fp - wp).max() > 0  # bf16 storage really changed the JAX result


# -----------------------------------------------------------------------------
# graph edits and one operator iteration
# -----------------------------------------------------------------------------

EDIT_CONFIG = dict(image_size=(48, 64), buffer=10, compute_dtype="float32")


def _video_pair(seed):
    """A JAX VideoState and a port VideoState with the same seeded contents."""
    from droid_slam_tpu.runtime.video import VideoState as JVideoState

    r = np.random.default_rng(seed)
    jcfg, tcfg = JDroidConfig(**EDIT_CONFIG), DroidConfig(**EDIT_CONFIG)
    B = jcfg.buffer
    fh, fw = jcfg.feat_size
    xi = np.concatenate([0.05 * r.standard_normal((B, 3)), 0.02 * r.standard_normal((B, 3))], -1)
    state = dict(
        poses=np.array(jlie.exp(jnp.asarray(xi, jnp.float32))),
        disps=(0.5 + r.random((B, fh, fw))).astype(np.float32),
        intrinsics=np.tile(np.array([[fw * 0.9, fw * 0.9, fw / 2, fh / 2]], np.float32), (B, 1)),
        fmaps=r.standard_normal((B, 1, fh, fw, 128)).astype(np.float32),
        nets=np.tanh(r.standard_normal((B, fh, fw, 128))).astype(np.float32),
        inps=np.maximum(r.standard_normal((B, fh, fw, 128)), 0).astype(np.float32),
    )
    jv, tv = JVideoState(jcfg), VideoState(tcfg, "cpu")
    jv.counter = tv.counter = B
    for k, v in state.items():
        setattr(jv, k, jnp.asarray(v))
        setattr(tv, k, torch.from_numpy(v.copy()))
    return jv, tv


def test_graph_edits_and_update_match_jax():
    """add_factors with and without LRU eviction into the inactive ring,
    rm_factors, then one operator iteration over active + inactive edges."""
    params = jinit_params(jax.random.PRNGKey(3), image_size=(48, 64))
    net = DroidNet()
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    jv, tv = _video_pair(35)
    kw = dict(max_factors=6, edge_pad=10, inactive_pad=4, window_pad=8)
    jg = jfg.FactorGraph(jv, {"params": params["params"]["update"]}, schur_pair_floor=16, **kw)
    tg = tfg.FactorGraph(tv, net.update, **kw)
    ages = []
    for g in (jg, tg):
        g.add_factors([1, 2, 3, 2, 1], [2, 3, 4, 1, 2])  # a duplicate in the batch
        g.age[g.valid] = np.arange(int(g.valid.sum()))[::-1]  # slot 0 oldest
        g.add_factors([4, 5, 6, 3], [5, 6, 5, 2], remove=True)  # evicts the 2 oldest
        g.add_factors([7, 6, 5, 4, 3], [6, 7, 7, 7, 7], remove=True)  # evicts 5 into a ring of 4
        g.rm_factors(np.arange(10) % 3 == 0, store=True)
        ages.append(g.age.copy())
    for name in ("ii", "jj", "valid", "ii_inac", "jj_inac", "valid_inac"):
        np.testing.assert_array_equal(getattr(jg, name), getattr(tg, name), err_msg=name)
    np.testing.assert_array_equal(*ages)
    assert tg.valid_inac.all() and tg.num_active > 3
    for name in ("ii", "jj", "valid", "target", "weight"):
        want = np.asarray(getattr(jg.inactive, name), np.float32)
        got = getattr(tg.inactive, name).numpy().astype(np.float32)
        assert np.abs(want - got).max() < 1e-4, name
    for name in ("net", "target", "weight"):
        want = np.asarray(getattr(jg.edges, name))[jg.valid]
        got = getattr(tg.edges, name).numpy()[tg.valid]
        assert np.abs(want - got).max() < 1e-4, name

    jg.update(3, 8, use_inactive=True)
    with torch.no_grad():
        tg.update(3, 8, use_inactive=True)
    assert np.abs(np.asarray(jv.poses) - tv.poses.numpy()).max() < 1e-4
    assert np.abs(np.asarray(jv.disps) - tv.disps.numpy()).max() < 1e-4
    assert np.abs(np.asarray(jg.damping) - tg.damping.numpy()).max() < 1e-4
    np.testing.assert_array_equal(jg.age, tg.age)


# -----------------------------------------------------------------------------
# one global-BA run over a tracked replay
# -----------------------------------------------------------------------------

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
BUFFERS = ("tstamp", "images", "poses", "disps", "disps_sens", "intrinsics", "fmaps", "nets", "inps")


def _proximity_edges(graph, cfg):
    """The backend's proximity edge set (backend.py) on a fresh graph."""
    graph.add_proximity_factors(rad=cfg.backend_radius, nms=cfg.backend_nms,
                                thresh=cfg.backend_thresh, beta=cfg.beta)
    return graph.edge_set


@functools.lru_cache(maxsize=None)
def _backend_runs():
    params = jinit_params(jax.random.PRNGKey(7), image_size=(64, 64))
    rng = np.random.default_rng(5432)
    drng = np.random.default_rng(99)
    base = rng.integers(0, 255, (10, 10, 3)).astype(np.float32)
    big = np.kron(base, np.ones((8, 8, 1)))[:64, :64]
    intr = jnp.asarray([64.0, 64.0, 32.0, 32.0], jnp.float32)
    jd = JDroid(JDroidConfig(**CONFIG), params=params)
    for t in range(10):
        frame = np.roll(big, shift=2 * t, axis=1).astype(np.uint8)
        depth = ((1.0 + 2.0 * drng.random((64, 64))) * (drng.random((64, 64)) > 0.2)).astype(np.float32)
        jd.track(t, jnp.asarray(frame), depth=jnp.asarray(depth), intrinsics=intr)
    jd._sync_fused_state()
    jv = jd.video
    state = {k: np.array(getattr(jv, k)) for k in BUFFERS}
    t = jv.counter

    cfg = DroidConfig(**CONFIG)
    net = DroidNet()
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tv = VideoState(cfg, "cpu")
    tv.counter = t
    for k, v in state.items():
        setattr(tv, k, torch.from_numpy(v.copy()))

    size = tbackend._chunk_ceil(16 * t, cfg.backend_chunk)
    assert size == jbackend._chunk_ceil(16 * t, cfg.backend_chunk)
    want_edges = _proximity_edges(jfg.FactorGraph(
        jv, jd.backend.params, max_factors=size, edge_pad=size + 32,
        inactive_pad=cfg.inactive_pad, window_pad=cfg.window_pad), cfg)
    got_edges = _proximity_edges(tfg.FactorGraph(
        tv, net.update, max_factors=size, edge_pad=size + 32,
        inactive_pad=cfg.inactive_pad, window_pad=cfg.window_pad), cfg)

    jd.backend(2)
    with torch.backends.mkldnn.flags(enabled=False), torch.no_grad():
        n_edges, n_chunks = tbackend.DroidBackend(net.update, tv, cfg)(2)
    return dict(
        t=t, state=state, want_edges=want_edges, got_edges=got_edges,
        n_edges=n_edges, n_chunks=n_chunks,
        want_poses=np.asarray(jv.poses[:t]), want_disps=np.asarray(jv.disps[:t]),
        got_poses=tv.poses[:t].numpy(), got_disps=tv.disps[:t].numpy(),
    )


def test_backend_same_proximity_edges():
    r = _backend_runs()
    assert r["t"] == 10
    assert len(r["want_edges"]) > 20
    assert r["got_edges"] == r["want_edges"]
    assert r["n_edges"] == len(r["got_edges"])
    assert r["n_chunks"] == 1


def test_backend_matches_jax():
    r = _backend_runs()
    t = r["t"]
    assert np.abs(r["want_poses"] - r["state"]["poses"][:t]).max() > 1e-4  # global BA moved the poses
    assert np.abs(r["got_poses"] - r["want_poses"]).max() < 5e-3
    assert np.abs(r["got_disps"] - r["want_disps"]).max() < 1e-2
