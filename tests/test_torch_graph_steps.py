"""The factor graph's device steps: what lets each be one CUDA graph.

``FactorGraph.update`` and ``update_lowmem`` are a host preparation and a
device step (the JAX package's ``update`` and its jitted ``_update_step``).
On the card each step whose key has been seen is one replay of a captured
graph, which reads the storage it was captured with; here, on the CPU,
every step runs eagerly, and these tests hold what the capture relies on:

* (a) the device steps read nothing from the host: every way of reading a
  tensor on the host raises inside them (``HostReadGuard`` of
  tests/test_torch_fused_control.py), over the host-engine replay of
  tests/test_torch_host_engine.py (``update`` with and without the
  inactive edges), the trajectory filler's motion-only ``update`` and
  terminate's ``update_lowmem``, mono and stereo;
* (b) no edit or step rebinds a buffer: the storage of the video, edge,
  inactive and damping tensors stays the same across ``update``,
  ``update_lowmem``, ``rm_keyframe``, ``add_factors``, ``rm_factors``,
  ``VideoState.normalize`` and the filler's writes;
* (c) the Schur pair list padded to a power of two (``pair_valid``) gives
  ``ba_iteration`` bit for bit what the unpadded list gives, 0-dim tensor
  ``t0``/``t1`` bit for bit what ints give, and the JAX package's
  ``ba_iteration`` on the same padded list agrees within 1e-4;
* (d) the pair list is built again only after an edit that bumps the
  topology version;
* a replay whose buffers moved raises, and the launches a replay runs are
  counted apart from those the wrappers queue.

The captured steps themselves run on the card (``chip_smoke.py`` phases 6b
and 8, bit for bit against ``capture=False``).
"""

import collections
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.ops import ba as jba
from droid_slam_tpu_torch.models.droid_net import DroidNet, init_params
from droid_slam_tpu_torch.ops import ba as tba
from droid_slam_tpu_torch.ops import lie
from droid_slam_tpu_torch.runtime import Droid, DroidConfig
from droid_slam_tpu_torch.runtime import factor_graph as tfg
from droid_slam_tpu_torch.runtime.trajectory_filler import PoseTrajectoryFiller
from droid_slam_tpu_torch.runtime.video import VideoState
from test_torch_backend import T0, T1, WINDOW, _problem
from test_torch_fused_control import HostReadGuard
from test_torch_host_engine import CONFIG as HOST_CONFIG
from test_torch_host_engine import INTR as HOST_INTR
from test_torch_host_engine import _config as host_config
from test_torch_host_engine import _frames as host_frames
from test_torch_host_engine import _params as host_params

torch.set_num_threads(2)

# -----------------------------------------------------------------------------
# (a) no host read inside the device steps
# -----------------------------------------------------------------------------


def _guard_steps(monkeypatch):
    """Make every device step run under HostReadGuard; returns a counter of
    the steps that ran, by kind (update, motion-only update, lowmem) and
    whether the inactive edges took part."""
    guard = HostReadGuard(monkeypatch)
    ran = collections.Counter()
    real = tfg.FactorGraph._run

    def guarded(self, key, step, pairs):
        kind = key[0] if key[0] == "lowmem" else ("motion_only" if key[3] else f"update inactive={key[2]}")
        ran[kind] += 1

        def checked():
            guard.active = True
            try:
                step()
            finally:
                guard.active = False

        real(self, key, checked, pairs)

    monkeypatch.setattr(tfg.FactorGraph, "_run", guarded)
    return ran


@pytest.mark.parametrize("variant", ["mono", "stereo"])
def test_device_steps_read_nothing_from_the_host(monkeypatch, variant):
    _, tparams = host_params()
    frames = host_frames(variant)
    droid = Droid(DroidConfig(**host_config(variant)), params=tparams, device="cpu", fused=False)
    assert not droid.capture and not droid.frontend.graph.capture  # the CPU is always eager
    ran = _guard_steps(monkeypatch)
    with torch.backends.mkldnn.flags(enabled=False):
        for t, img, depth in frames:
            droid.track(t, img, depth=depth, intrinsics=HOST_INTR)
        g = droid.frontend.graph
        g.update(use_inactive=False)
        stream = [(t, img, HOST_INTR) for t, img, _ in frames]
        traj = droid.terminate(iter(stream))
    assert np.isfinite(traj).all() and traj.shape == (len(frames), 7)
    # the frontend's iterations (16 at the init, 6 per later keyframe), the
    # one without the inactive edges, terminate's 7 + 12 global-BA steps and
    # the filler's 6 motion-only iterations
    assert ran["update inactive=True"] == 16 + 6 * (len(frames) - droid.config.warmup)
    assert ran["update inactive=False"] == 1
    assert ran["lowmem"] == 19
    assert ran["motion_only"] == 6


# -----------------------------------------------------------------------------
# (b) no buffer rebound
# -----------------------------------------------------------------------------

SMALL = dict(image_size=(32, 48), buffer=10, max_factors=16, inactive_pad=8, window_pad=16,
             compute_dtype="float32", upsample=True)
EDGES = (np.array([0, 1, 2, 3, 4, 5, 6, 7, 2, 3, 5, 7], np.int32),
         np.array([1, 2, 3, 4, 5, 6, 7, 6, 0, 1, 2, 4], np.int32))


def _net():
    net = DroidNet()
    net.load_state_dict(init_params(0))
    return net.eval()


def _small_graph(seed: int = 3, net=None, stereo: bool = False):
    """A seeded video of 8 keyframes (of 10 slots) and its factor graph with
    12 edges, 4 of them retired to the inactive ring."""
    cfg = DroidConfig(**SMALL, stereo=stereo)
    v = VideoState(cfg, "cpu")
    r = np.random.default_rng(seed)
    B, (h, w) = cfg.buffer, cfg.feat_size
    xi = np.concatenate([0.05 * r.standard_normal((B, 3)), 0.01 * r.standard_normal((B, 3))], -1)
    v.poses.copy_(lie.exp(torch.from_numpy(xi.astype(np.float32))))
    v.disps.copy_(torch.from_numpy((0.5 + r.random((B, h, w))).astype(np.float32)))
    v.intrinsics.copy_(torch.tensor([w * 0.9, w * 0.9, w / 2, h / 2]).expand(B, 4))
    v.tstamp.copy_(torch.arange(B, dtype=torch.float32))
    for name in ("fmaps", "nets", "inps"):
        buf = getattr(v, name)
        buf.copy_(torch.from_numpy(r.standard_normal(buf.shape).astype(np.float32)))
    v.counter = 8
    net = net if net is not None else _net()
    g = tfg.FactorGraph(v, net.update, max_factors=16, inactive_pad=8, window_pad=16, edge_pad=24,
                        upsample=True, schur_pair_floor=64)
    g.add_factors(*EDGES)
    g.rm_factors(np.isin(np.arange(24), [1, 4, 8, 10]), store=True)
    return g, net


def _fill(g, net):
    """The trajectory filler on the graph's video: two frames between its
    keyframes."""
    v = g.video
    H, W = v.config.image_size
    r = np.random.default_rng(9)
    intr = np.array([W * 0.9, W * 0.9, W / 2, H / 2], np.float32)
    stream = [(k + 0.5, r.integers(0, 255, (H, W, 3), np.uint8), intr) for k in range(2)]
    return PoseTrajectoryFiller(net, net.update, v, v.config)(iter(stream))


EDITS = {
    "update": lambda g, net: g.update(use_inactive=False),
    "update_inactive": lambda g, net: g.update(use_inactive=True),
    "motion_only": lambda g, net: g.update(2, 8, motion_only=True),
    "update_lowmem": lambda g, net: g.update_lowmem(steps=2),
    "rm_keyframe": lambda g, net: g.rm_keyframe(3),
    "add_factors": lambda g, net: g.add_factors([0, 6, 7, 1], [7, 0, 3, 6], remove=True),
    "rm_factors": lambda g, net: g.rm_factors(np.isin(np.arange(24), [0, 2, 3]), store=True),
    "normalize": lambda g, net: g.video.normalize(),
    "fill": _fill,
}


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_no_buffer_is_rebound(edit):
    g, net = _small_graph()
    before = g.storage()
    assert {"video.poses", "video.disps_up", "edges.net", "inactive.target", "damping", "t0"} <= set(before)
    with torch.no_grad():
        EDITS[edit](g, net)
    assert g.storage() == before
    # and the edit did something
    assert torch.isfinite(g.video.poses).all() and torch.isfinite(g.video.disps).all()


def test_steps_write_in_place():
    """update and update_lowmem change the edges, the damping, the poses and
    the full-resolution disparities through the buffers held before."""
    g, net = _small_graph()
    held = {name: t for name, t in (("net", g.edges.net), ("damping", g.damping), ("poses", g.video.poses),
                                    ("disps_up", g.video.disps_up))}
    start = {name: t.clone() for name, t in held.items()}
    with torch.no_grad():
        g.update(use_inactive=True)
        g.update_lowmem(steps=1)
    for name, t in held.items():
        assert not torch.equal(t, start[name]), name


# -----------------------------------------------------------------------------
# (c) padded pairs and tensor windows
# -----------------------------------------------------------------------------


def _torch_problem(pb, pairs, t0, t1):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in pb.items()}
    return t, tba.BAProblem(target=t["target"], weight=t["weight"], eta=t["eta"], ii=t["ii"].long(),
                            jj=t["jj"].long(), edge_valid=t["valid"], t0=t0, t1=t1, pairs=pairs)


def _iterate(pb, pairs, t0=T0, t1=T1, motion_only=False, schur=torch.float32):
    t, prob = _torch_problem(pb, pairs, t0, t1)
    return tba.ba_iteration(t["poses"], t["disps"], t["intr"], t["sens"], prob, WINDOW,
                            motion_only=motion_only, schur_dtype=schur)


def _pairs(pb, pad_floor=None, t0=T0, t1=T1):
    return tba.SchurPairs.build(pb["ii"], pb["jj"], pb["valid"], t0, t1, WINDOW, pad_floor=pad_floor)


def test_pair_padding():
    pb = _problem(33, with_sens=False)
    plain, padded = _pairs(pb), _pairs(pb, pad_floor=64)
    n = plain.pair_a.shape[0]
    assert 0 < n < 64 and padded.pair_a.shape[0] == 64 == tba.pair_bucket(n, 64)
    assert torch.equal(padded.pair_a[:n], plain.pair_a) and torch.equal(padded.pair_b[:n], plain.pair_b)
    assert padded.pair_valid[:n].all() and not padded.pair_valid[n:].any() and plain.pair_valid.all()
    assert (padded.pair_a[n:] == 0).all() and (padded.pair_b[n:] == 0).all()
    assert [tba.pair_bucket(k, 16) for k in (0, 1, 16, 17, 4096, 4097)] == [16, 16, 16, 32, 4096, 8192]


@pytest.mark.parametrize("case", ["full", "motion_only", "rgbd_prior", "bf16_schur"])
def test_padded_pairs_and_tensor_window_are_bitwise(case):
    pb = _problem(33 if case != "bf16_schur" else 34, with_sens=case == "rgbd_prior")
    kw = dict(motion_only=case == "motion_only", schur=torch.bfloat16 if case == "bf16_schur" else torch.float32)
    want = _iterate(pb, _pairs(pb), **kw)
    got_padded = _iterate(pb, _pairs(pb, pad_floor=64), **kw)
    got_tensor = _iterate(pb, _pairs(pb, pad_floor=64), t0=torch.tensor(T0), t1=torch.tensor(T1), **kw)
    for got in (got_padded, got_tensor):
        for a, b in zip(want, got):
            assert torch.equal(a, b)
    assert not torch.equal(want[0], torch.from_numpy(pb["poses"]))  # the iteration moved the poses


@pytest.mark.parametrize("t0, t1", [(0, 6), (3, 8), (6, 8)])
def test_tensor_window_at_the_buffer_edges(t0, t1):
    """Windows that start at 0 or run into the buffer's end: the clamped
    gather of the window's rows gives what the slice gave."""
    pb = _problem(35, with_sens=False)
    want = _iterate(pb, _pairs(pb, t0=t0, t1=t1), t0=t0, t1=t1)
    got = _iterate(pb, _pairs(pb, pad_floor=64, t0=t0, t1=t1), t0=torch.tensor(t0), t1=torch.tensor(t1))
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_padded_pairs_match_jax_ba_iteration():
    pb = _problem(33, with_sens=True)
    pairs = _pairs(pb, pad_floor=64)
    jpairs = jba.SchurPairs(*(jnp.asarray(x.numpy().astype(np.int32) if x.dtype != torch.bool else x.numpy())
                              for x in pairs))
    jprob = jba.BAProblem(
        target=jnp.asarray(pb["target"]), weight=jnp.asarray(pb["weight"]), eta=jnp.asarray(pb["eta"]),
        ii=jnp.asarray(pb["ii"]), jj=jnp.asarray(pb["jj"]), edge_valid=jnp.asarray(pb["valid"]),
        t0=jnp.int32(T0), t1=jnp.int32(T1), pairs=jpairs,
    )
    wp, wd = jba.ba_iteration(jnp.asarray(pb["poses"]), jnp.asarray(pb["disps"]), jnp.asarray(pb["intr"]),
                              jnp.asarray(pb["sens"]), jprob, WINDOW)
    gp, gd = _iterate(pb, pairs, t0=torch.tensor(T0), t1=torch.tensor(T1))
    assert np.abs(gp.numpy() - np.asarray(wp)).max() < 1e-4
    assert np.abs(gd.numpy() - np.asarray(wd)).max() < 1e-4


# -----------------------------------------------------------------------------
# (d) the pair list's cache
# -----------------------------------------------------------------------------


def test_pair_list_is_rebuilt_only_after_an_edit(monkeypatch):
    g, net = _small_graph()
    builds = []
    real = tba.SchurPairs.build

    def counting(*args, **kwargs):
        builds.append(g._topology_version)
        return real(*args, **kwargs)

    monkeypatch.setattr(tba.SchurPairs, "build", staticmethod(counting))

    def n_after(fn):
        with torch.no_grad():
            fn()
        return len(builds)

    assert n_after(lambda: g.update()) == 1
    assert n_after(lambda: g.update()) == 1  # unchanged graph: cached
    assert n_after(lambda: g.update(use_inactive=True)) == 2  # another list
    assert n_after(lambda: g.update(use_inactive=True)) == 2
    version = g._topology_version
    g.add_factors(*EDGES)  # every edge already there: no edit
    assert g._topology_version == version
    assert n_after(lambda: g.update(use_inactive=True)) == 2
    for edit in (lambda: g.add_factors([0], [5]), lambda: g.rm_factors(np.isin(np.arange(24), [0]), store=True),
                 lambda: g.rm_keyframe(6)):
        n = len(builds)
        edit()
        assert g._topology_version > version
        version = g._topology_version
        assert n_after(lambda: g.update(use_inactive=True)) == n + 1
        assert n_after(lambda: g.update(use_inactive=True)) == n + 1
    n = len(builds)
    assert n_after(lambda: g.update_lowmem(steps=2)) == n + 1  # one list per pass
    assert n_after(lambda: g.update_lowmem(steps=1)) == n + 1  # the same graph: cached


# -----------------------------------------------------------------------------
# replays: moved buffers, launch counts
# -----------------------------------------------------------------------------


class _FakeCapture:
    """Stands in for a captured graph: counts replays."""

    launches = {"corr_level": 8}
    replays = 0

    def replay(self):
        self.replays += 1


def test_replay_raises_when_a_buffer_moved():
    g, net = _small_graph()
    key = ("update", 64, False, False, 2, True, 1e-7)
    fake = _FakeCapture()
    g._graphs[key] = (fake, g.storage())
    g.capture = True  # as on the card: a seen key replays
    ran = []
    g._run(key, lambda: ran.append(1), None)
    assert fake.replays == 1 and not ran and g.stats.replays == 1
    assert g.stats.replayed_launches == {"corr_level": 8}
    g.damping = g.damping.clone()  # a rebinding, as the port no longer does
    with pytest.raises(RuntimeError, match="damping"):
        g._run(key, lambda: ran.append(1), None)
    assert fake.replays == 1 and not ran


def test_capture_stats_count_device_launches():
    st = tfg.CaptureStats(graphs=1, replays=6, captured_launches={"corr_slab": 4},
                          replayed_launches={"corr_slab": 24})
    # an eager step and a capture queued 4 each; the card ran the eager
    # step's and 6 replays'
    assert st.device_launches({"corr_slab": 8, "corr_level": 3}) == {"corr_slab": 28, "corr_level": 3}
    other = copy.deepcopy(st)
    st.merge(other)
    assert (st.graphs, st.replays, st.captured_launches, st.replayed_launches) == (
        2, 12, {"corr_slab": 8}, {"corr_slab": 48})
    assert other.replayed_launches == {"corr_slab": 24}


def test_capture_is_off_on_the_cpu():
    g, _ = _small_graph()
    assert not tfg.FactorGraph(g.video, g.update_op, capture=True).capture
    d = Droid(DroidConfig(**HOST_CONFIG), params=host_params()[1], device="cpu", fused=False, capture=True)
    assert not d.capture and not d.frontend.graph.capture
