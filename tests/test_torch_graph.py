"""Port parity for the factor-graph edits of the fused tracking step:
keyframe removal (the cull branch, which the slice replay never takes),
LRU-evicting edge insertion and greedy proximity selection, on one seeded
state run through the JAX functions and the port's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.runtime import fused as jfused
from droid_slam_tpu.runtime.config import DroidConfig as JDroidConfig
from droid_slam_tpu_torch.runtime import fused as tfused

torch.set_num_threads(2)

CONFIG = dict(image_size=(32, 48), buffer=12, warmup=4, max_factors=16,
              inactive_pad=12, window_pad=16, compute_dtype="float32")
COUNTER = 9


def _jax_state(seed):
    """A JAX fused state with COUNTER keyframes, random geometry and
    features, 12 active edges (some invalid) and 6 inactive ones."""
    r = np.random.default_rng(seed)
    cfg = JDroidConfig(**CONFIG)
    st = jfused.init_state(cfg)
    B = cfg.buffer
    h, w = cfg.feat_size
    f32 = np.float32
    xi = np.concatenate([0.05 * r.standard_normal((B, 3)), 0.01 * r.standard_normal((B, 3))], -1)
    Nmax, K = st.ii.shape[0], st.inac_ii.shape[0]
    ii = r.integers(0, COUNTER, Nmax)
    jj = np.clip(ii + r.choice([-3, -2, -1, 1, 2, 3], Nmax), 0, COUNTER - 1)
    valid = np.arange(Nmax) < 12
    valid[[2, 7]] = False
    inac_ii = r.integers(0, COUNTER, K)
    inac_jj = np.clip(inac_ii + r.choice([-2, -1, 1, 2], K), 0, COUNTER - 1)
    return st._replace(
        tstamp=jnp.asarray(np.arange(B, dtype=f32)),
        images=jnp.asarray(r.integers(0, 255, st.images.shape).astype(np.uint8)),
        poses=jlie.exp(jnp.asarray(xi, jnp.float32)),
        disps=jnp.asarray((0.5 + r.random((B, h, w))).astype(f32)),
        disps_sens=jnp.asarray((r.random((B, h, w)) * (r.random((B, h, w)) > 0.5)).astype(f32)),
        intrinsics=jnp.asarray(np.tile([[w * 0.9, w * 0.9, w / 2, h / 2]], (B, 1)).astype(f32)),
        fmaps=jnp.asarray(r.standard_normal(st.fmaps.shape).astype(f32)),
        nets=jnp.asarray(r.standard_normal(st.nets.shape).astype(f32)),
        inps=jnp.asarray(r.standard_normal(st.inps.shape).astype(f32)),
        counter=jnp.int32(COUNTER),
        ii=jnp.asarray(ii, jnp.int32),
        jj=jnp.asarray(jj, jnp.int32),
        age=jnp.asarray(r.integers(0, 30, Nmax), jnp.int32),
        valid=jnp.asarray(valid),
        enet=jnp.asarray(r.standard_normal(st.enet.shape).astype(f32)),
        target=jnp.asarray(r.standard_normal(st.target.shape).astype(f32)),
        weight=jnp.asarray(r.random(st.weight.shape).astype(f32)),
        inac_ii=jnp.asarray(inac_ii, jnp.int32),
        inac_jj=jnp.asarray(inac_jj, jnp.int32),
        inac_valid=jnp.asarray(np.arange(K) < 6),
        inac_target=jnp.asarray(r.standard_normal(st.inac_target.shape).astype(f32)),
        inac_weight=jnp.asarray(r.random(st.inac_weight.shape).astype(f32)),
        inac_next=jnp.int32(6),
        damping=jnp.asarray((1e-3 * r.random(st.damping.shape)).astype(f32)),
    )


def _port_state(jst):
    """The same state as the port's SLAMState (int64 indices)."""
    fields = {}
    for name in tfused.SLAMState.__dataclass_fields__:
        if name in ("counter", "t1", "is_init"):
            continue
        v = np.array(getattr(jst, name))
        fields[name] = torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
    return tfused.SLAMState(**fields, counter=torch.tensor(int(jst.counter)), t1=torch.tensor(int(jst.t1)),
                            is_init=torch.tensor(bool(jst.is_init)))


def _assert_same_state(jst, pst):
    for name in tfused.SLAMState.__dataclass_fields__:
        if name in ("counter", "t1", "is_init"):
            continue
        want = np.asarray(getattr(jst, name))
        got = getattr(pst, name).numpy()
        assert got.shape == want.shape, name
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert np.abs(got.astype(np.float64) - want).max() < 1e-4, name


@pytest.mark.parametrize("ix", [2, COUNTER - 1])
def test_rm_keyframe_matches_jax(ix):
    jst = _jax_state(0)
    pst = _port_state(jst)
    jst = jfused._rm_keyframe(jst, jnp.int32(ix))
    tfused._rm_keyframe(pst, ix)
    _assert_same_state(jst, pst)


@pytest.mark.parametrize("evict", [False, True])
def test_add_edges_matches_jax(evict):
    jst = _jax_state(1)
    pst = _port_state(jst)
    # duplicates of an active edge, of an inactive edge, within the batch,
    # and masked candidates with a negative index
    ci = np.array([int(jst.ii[0]), int(jst.inac_ii[1]), 5, 5, 8, 3, 7, 1], np.int32)
    cj = np.array([int(jst.jj[0]), int(jst.inac_jj[1]), 4, 4, -1, 0, 6, 2], np.int32)
    ok = np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)
    jst = jfused._add_edges(jst, jnp.asarray(ci), jnp.asarray(cj), jnp.asarray(ok),
                            evict=jnp.bool_(evict), budget=12 if evict else None)
    tfused._add_edges(pst, torch.from_numpy(ci).long(), torch.from_numpy(cj).long(),
                      torch.from_numpy(ok), evict=evict, budget=12 if evict else None)
    _assert_same_state(jst, pst)
    n_valid = int(np.asarray(jst.valid).sum())
    assert (n_valid == 12) if evict else (n_valid > 10)  # eviction held the budget


def test_proximity_candidates_match_jax():
    jst = _jax_state(2)
    pst = _port_state(jst)
    # the 30 base edges stay under the budget, so greedy picks happen
    kw = dict(rad=2, nms=1, thresh=50.0, beta=0.3, max_factors=40)
    want = jfused._proximity_candidates(jst, jnp.int32(COUNTER - 5), jnp.int32(1), 5, 8,
                                        stereo=False, **kw)
    got = tfused._proximity_candidates(pst, COUNTER - 5, 1, 5, 8, **kw)
    wi, wj, wok = (np.asarray(a) for a in want)
    gi, gj, gok = (a.numpy() for a in got)
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_array_equal(gi[wok], wi[wok])
    np.testing.assert_array_equal(gj[wok], wj[wok])
    n_base = 5 * 3 * 2
    assert wok[n_base:].any()  # some greedy picks were made
