"""The training losses (``train/losses.py``) against the JAX package's:
values, metrics and gradients of the geodesic, residual and flow losses on
seeded inputs, and finite gradients where an estimate equals the ground
truth bit for bit (``_safe_norm``'s floor)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.train import losses as JL
from droid_slam_tpu_torch.ops import lie
from droid_slam_tpu_torch.train import losses as TL

torch.set_num_threads(2)

S, B, F = 3, 2, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _poses(seed, shape, scale):
    r = np.random.default_rng(seed)
    tw = (scale * r.standard_normal(shape + (6,))).astype(np.float32)
    return lie.retr(lie.identity(shape), _t(tw)).numpy()


def _graph():
    ii = np.array([0, 1, 1, 2, 3, 0])
    jj = np.array([1, 0, 2, 3, 2, 0])
    valid = np.array([True, True, True, True, True, False])
    return ii, jj, valid


def _grad_pair(jfn, tfn, x):
    """(value, metrics, gradient) of a loss in both packages at x."""
    (jv, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    tv, tm = tfn(xt)
    tv.backward()
    return (float(jv), {k: float(v) for k, v in jm.items()}, np.asarray(jg),
            float(tv), {k: float(v) for k, v in tm.items()}, xt.grad.numpy())


@pytest.mark.parametrize("do_scale", [False, True])
def test_geodesic_loss_matches_jax(do_scale):
    Ps = _poses(0, (B, F), 0.3)
    Gs = np.stack([_poses(s + 1, (B, F), 0.3) for s in range(S)])
    ii, jj, valid = _graph()

    def jfn(G):
        return JL.geodesic_loss(jnp.asarray(Ps), G, jnp.asarray(ii), jnp.asarray(jj),
                                do_scale=do_scale, edge_valid=jnp.asarray(valid))

    def tfn(G):
        return TL.geodesic_loss(_t(Ps), G, _t(ii), _t(jj), do_scale=do_scale, edge_valid=_t(valid))

    jv, jm, jg, tv, tm, tg = _grad_pair(jfn, tfn, Gs)
    # f32 in two libraries: 1e-5 relative
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 1e-5 * max(abs(jm[k]), 1e-6), k
    assert _rel(tg, jg) < 1e-4


def test_residual_loss_matches_jax():
    r = np.random.default_rng(3)
    res = r.standard_normal((S, B * 6, 5, 6, 2)).astype(np.float32)
    valid = np.tile(_graph()[2], B)
    for ev in (None, valid):
        jfn = lambda x: JL.residual_loss(x, edge_valid=None if ev is None else jnp.asarray(ev))  # noqa: E731
        tfn = lambda x: TL.residual_loss(x, edge_valid=None if ev is None else _t(ev))  # noqa: E731
        jv, jm, jg, tv, tm, tg = _grad_pair(jfn, tfn, res)
        assert abs(tv - jv) <= 1e-6 * abs(jv)
        assert abs(tm["residual"] - jm["residual"]) <= 1e-6 * abs(jv)
        assert _rel(tg, jg) < 1e-6


def _flow_inputs(seed, H=16, W=24):
    r = np.random.default_rng(seed)
    Ps = _poses(seed, (B, F), 0.05)
    disps = (0.5 + r.random((B, F, H, W))).astype(np.float32)
    disps[0, 1, :2] = 0.0  # invalid ground truth
    intr = np.tile(np.array([W, W, W / 2, H / 2], np.float32), (B, F, 1))
    poses_steps = np.stack([_poses(seed + 10 + s, (B, F), 0.05) for s in range(S)])
    disps_steps = (0.5 + r.random((S, B, F, H, W))).astype(np.float32)
    return Ps, disps, intr, poses_steps, disps_steps


def test_flow_loss_matches_jax():
    Ps, disps, intr, poses_steps, disps_steps = _flow_inputs(4)

    def jfn(x):
        return JL.flow_loss(jnp.asarray(Ps), jnp.asarray(disps), jnp.asarray(poses_steps), x, jnp.asarray(intr))

    def tfn(x):
        return TL.flow_loss(_t(Ps), _t(disps), _t(poses_steps), x, _t(intr))

    jv, jm, jg, tv, tm, tg = _grad_pair(jfn, tfn, disps_steps)
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 1e-5 * max(abs(jm[k]), 1e-6), k
    assert _rel(tg, jg) < 1e-4

    # and the gradient with respect to the poses
    (_, _), jgp = jax.jit(jax.value_and_grad(lambda p: JL.flow_loss(
        jnp.asarray(Ps), jnp.asarray(disps), p, jnp.asarray(disps_steps), jnp.asarray(intr)), has_aux=True))(
        jnp.asarray(poses_steps))
    p = _t(poses_steps).requires_grad_()
    TL.flow_loss(_t(Ps), _t(disps), p, _t(disps_steps), _t(intr))[0].backward()
    assert _rel(p.grad, jgp) < 1e-4


def test_estimate_equal_to_ground_truth_has_finite_gradients():
    """An estimate equal to the ground truth bit for bit: the geodesic
    error's log is at the identity and the flow error is exactly 0, where
    an unfloored norm has a NaN gradient."""
    Ps, disps, intr, _, _ = _flow_inputs(5)
    ii, jj, valid = _graph()
    G = _t(np.stack([Ps] * S)).requires_grad_()
    D = _t(np.stack([disps] * S)).requires_grad_()
    geo, _ = TL.geodesic_loss(_t(Ps), G, _t(ii), _t(jj), edge_valid=_t(valid))
    flo, m = TL.flow_loss(_t(Ps), _t(disps), G, D, _t(intr))
    (geo + flo).backward()
    assert torch.isfinite(G.grad).all() and torch.isfinite(D.grad).all()
    assert float(m["f_error"]) <= 1.01e-6  # the norm's floor: sqrt(1e-12)
    jg = jax.jit(jax.grad(lambda g, d: JL.geodesic_loss(jnp.asarray(Ps), g, jnp.asarray(ii), jnp.asarray(jj),
                                                edge_valid=jnp.asarray(valid))[0]
                  + JL.flow_loss(jnp.asarray(Ps), jnp.asarray(disps), g, d, jnp.asarray(intr))[0],
                  argnums=(0, 1)))(jnp.asarray(np.stack([Ps] * S)), jnp.asarray(np.stack([disps] * S)))
    # the error vectors there are each library's rounding noise, which the
    # floored norm's gradient x/‖x‖ follows: both finite, not equal
    assert np.isfinite(np.asarray(jg[0])).all() and np.isfinite(np.asarray(jg[1])).all()
