"""Port parity: dense-window Gauss-Newton BA against the JAX package on one
seeded window, with and without an RGB-D prior, in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.ops import ba as jba
from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.ops import projective as jpops
from droid_slam_tpu_torch.ops import ba as tba

torch.set_num_threads(2)

F, h, w = 8, 6, 8
PW, KA = 8, 10


def _window(seed, with_sens):
    r = np.random.default_rng(seed)
    f32 = np.float32
    xi = np.concatenate([0.05 * r.standard_normal((F, 3)), 0.02 * r.standard_normal((F, 3))], -1)
    poses = np.array(jlie.exp(jnp.asarray(xi, jnp.float32)))
    disps = (0.5 + r.random((F, h, w))).astype(f32)
    intr = np.array([w * 0.9, w * 0.9, w / 2, h / 2], f32)
    ii = np.array([1, 2, 2, 3, 3, 4, 5, 6, 4, 6, 0, 7], np.int32)
    jj = np.array([2, 1, 3, 2, 4, 3, 4, 5, 6, 4, 1, 6], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0], bool)
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
    return dict(
        poses=poses, disps=disps, intrinsics=intr, disps_sens=sens, target=target,
        weight=weight, eta=eta, ii=ii, jj=jj, edge_valid=valid,
    )


@pytest.mark.parametrize("with_sens", [False, True])
def test_ba_iteration_dense_window_matches_jax(with_sens):
    win = _window(11, with_sens)
    t0, t1, kf0 = 1, 7, 0
    want_p, want_d = jba.ba_iteration_dense_window(
        **{k: jnp.asarray(v) for k, v in win.items()},
        t0=jnp.int32(t0), t1=jnp.int32(t1), kf0=jnp.int32(kf0), window=PW, kwin=KA,
    )
    targs = {k: torch.from_numpy(v) for k, v in win.items()}
    targs["ii"], targs["jj"] = targs["ii"].long(), targs["jj"].long()
    got_p, got_d = tba.ba_iteration_dense_window(
        **targs, t0=torch.tensor(t0), t1=torch.tensor(t1), kf0=torch.tensor(kf0),
        window=PW, kwin=KA,
    )
    # the step moves things: a no-op port would fail
    assert np.abs(np.asarray(want_p) - win["poses"]).max() > 1e-3
    assert np.abs(np.asarray(want_p) - got_p.numpy()).max() < 1e-4
    assert np.abs(np.asarray(want_d) - got_d.numpy()).max() < 1e-4


@pytest.mark.parametrize("with_sens", [False, True])
def test_ba_iteration_dense_window_motion_only_matches_jax(with_sens):
    """``motion_only``: the damped pose system alone (no refinement
    step), the disparities untouched, the poses outside [t0, t1) too."""
    win = _window(12, with_sens)
    t0, t1, kf0 = 2, 6, 0
    want_p, want_d = jba.ba_iteration_dense_window(
        **{k: jnp.asarray(v) for k, v in win.items()},
        t0=jnp.int32(t0), t1=jnp.int32(t1), kf0=jnp.int32(kf0), window=PW, kwin=KA, motion_only=True,
    )
    targs = {k: torch.from_numpy(v) for k, v in win.items()}
    targs["ii"], targs["jj"] = targs["ii"].long(), targs["jj"].long()
    got_p, got_d = tba.ba_iteration_dense_window(
        **targs, t0=torch.tensor(t0), t1=torch.tensor(t1), kf0=torch.tensor(kf0),
        window=PW, kwin=KA, motion_only=True,
    )
    assert np.abs(np.asarray(want_p) - win["poses"]).max() > 1e-3
    assert np.abs(np.asarray(want_p) - got_p.numpy()).max() < 1e-4
    np.testing.assert_array_equal(got_d.numpy(), win["disps"])
    np.testing.assert_array_equal(np.asarray(want_d), win["disps"])
    outside = np.r_[0:t0, t1:len(win["poses"])]
    np.testing.assert_array_equal(got_p.numpy()[outside], win["poses"][outside])


def test_cholesky_solve_failure_gives_zeros():
    H = torch.tensor([[1.0, 2.0], [2.0, 1.0]])  # indefinite
    b = torch.ones(2, 1)
    assert torch.equal(tba.cholesky_solve(H, b), torch.zeros(2, 1))
    Hp = torch.tensor([[4.0, 1.0], [1.0, 3.0]])
    assert torch.allclose(Hp @ tba.cholesky_solve(Hp, b), b, atol=1e-6)
