"""The differentiable pieces of the training path against the JAX package:
``cholesky_solve``'s analytic backward (a failed factorisation included),
the batched ``bundle_adjust`` (outputs and gradients against ``jax.vjp``
of the vmapped JAX function, with ``fixedp`` and ``motion_only``),
``projective_transform``'s gradients where its masks cut in,
``induced_flow``, the update operator's ``grad_clip`` and Sim(3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.models import update as jupdate
from droid_slam_tpu.ops import ba as jba
from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.ops import projective as jpops
from droid_slam_tpu_torch.models import update as tupdate
from droid_slam_tpu_torch.ops import ba, lie
from droid_slam_tpu_torch.ops import projective as pops

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _spd(r, b, n):
    a = r.standard_normal((b, n, n)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def test_cholesky_solve_vjp_matches_jax():
    r = np.random.default_rng(0)
    H = _spd(r, 3, 6)
    b = r.standard_normal((3, 6, 2)).astype(np.float32)
    g = r.standard_normal((3, 6, 2)).astype(np.float32)
    x_j, vjp = jax.vjp(jba.cholesky_solve, jnp.asarray(H), jnp.asarray(b))
    dH_j, db_j = vjp(jnp.asarray(g))
    Ht, bt = _t(H).requires_grad_(), _t(b).requires_grad_()
    x = ba.cholesky_solve(Ht, bt)
    x.backward(_t(g))
    # f32 Cholesky in two libraries: relative to the largest entry
    assert _rel(x.detach(), x_j) < 1e-5
    assert _rel(Ht.grad, dH_j) < 1e-5
    assert _rel(bt.grad, db_j) < 1e-5


def test_cholesky_solve_failure_gives_zero_solution_and_gradients():
    r = np.random.default_rng(1)
    H = _spd(r, 2, 5)
    H[1] = -H[1]  # not positive definite: the factorisation fails
    b = r.standard_normal((2, 5, 1)).astype(np.float32)
    g = r.standard_normal((2, 5, 1)).astype(np.float32)
    x_j, vjp = jax.vjp(jba.cholesky_solve, jnp.asarray(H), jnp.asarray(b))
    dH_j, db_j = vjp(jnp.asarray(g))
    Ht, bt = _t(H).requires_grad_(), _t(b).requires_grad_()
    x = ba.cholesky_solve(Ht, bt)
    x.backward(_t(g))
    for got, want in ((x.detach(), x_j), (Ht.grad, dH_j), (bt.grad, db_j)):
        assert torch.isfinite(got).all()
        assert (got[1] == 0).all() and (np.asarray(want)[1] == 0).all()
        assert _rel(got[0], np.asarray(want)[0]) < 1e-5


def _ba_problem(seed, B=2, F=4, h=6, w=8):
    """A seeded batch of BA problems: poses near identity, disparities
    0.5-1, targets the reprojections plus σ=0.5 noise, an edge list with a
    self edge and edges to the fixed frames."""
    r = np.random.default_rng(seed)
    tw = (0.05 * r.standard_normal((B, F, 6))).astype(np.float32)
    poses = lie.retr(lie.identity((B, F)), _t(tw)).numpy()
    disps = (0.5 + 0.5 * r.random((B, F, h, w))).astype(np.float32)
    intr = np.tile(np.array([w, w, w / 2, h / 2], np.float32), (B, F, 1))
    ii = np.array([0, 1, 1, 2, 3, 2, 0, 3])
    jj = np.array([1, 0, 2, 3, 1, 2, 3, 0])
    coords, _ = pops.projective_transform_batched(_t(poses), _t(disps), _t(intr), _t(ii), _t(jj))
    N = len(ii)
    target = (coords.numpy() + 0.5 * r.standard_normal((B, N, h, w, 2))).astype(np.float32)
    weight = r.random((B, N, h, w, 2)).astype(np.float32)
    eta = (0.01 + 0.01 * r.random((B, F, h, w))).astype(np.float32)
    return target, weight, eta, poses, disps, intr, ii, jj


@pytest.mark.parametrize("fixedp,motion_only", [(1, False), (2, False), (2, True)])
def test_bundle_adjust_matches_jax_vjp(fixedp, motion_only):
    target, weight, eta, poses, disps, intr, ii, jj = _ba_problem(2)
    r = np.random.default_rng(3)
    g_poses = r.standard_normal(poses.shape).astype(np.float32)
    g_disps = r.standard_normal(disps.shape).astype(np.float32)

    def jfn(t, wt, e, p, d):
        def one(t, wt, e, p, d, k):
            return jba.bundle_adjust(t, wt, e, p, d, k, jnp.asarray(ii), jnp.asarray(jj),
                                     fixedp=fixedp, motion_only=motion_only)

        return jax.vmap(one)(t, wt, e, p, d, jnp.asarray(intr))

    inputs = (target, weight, eta, poses, disps)
    @jax.jit
    def jvjp(*args):
        out, vjp = jax.vjp(jfn, *args)
        return out, vjp((jnp.asarray(g_poses), jnp.asarray(g_disps)))

    out_j, grads_j = jvjp(*(jnp.asarray(a) for a in inputs))

    ts = [_t(a).requires_grad_() for a in inputs]
    out = ba.bundle_adjust(*ts, _t(intr), _t(ii), _t(jj), fixedp=fixedp, motion_only=motion_only)
    (out[0] * _t(g_poses)).sum().add((out[1] * _t(g_disps)).sum()).backward()

    # f32 Gauss-Newton in two libraries (the Schur complement's Cholesky
    # amplifies rounding): each tensor relative to its largest entry
    assert _rel(out[0].detach(), out_j[0]) < 1e-4
    assert _rel(out[1].detach(), out_j[1]) < 1e-4
    for name, t, gj in zip(("target", "weight", "eta", "poses", "disps"), ts, grads_j):
        if motion_only and name == "eta":
            assert t.grad is None or not t.grad.any()
            continue
        assert torch.isfinite(t.grad).all(), name
        assert _rel(t.grad, gj) < 1e-4, name


def test_projective_transform_gradients_finite_where_masks_cut_in():
    """Points behind the camera (the MIN_DEPTH clamp of proj) and invalid
    pixels (the validity mask) give finite gradients for poses and
    disparities, equal to JAX's."""
    r = np.random.default_rng(4)
    F, h, w = 3, 5, 6
    tw = np.zeros((F, 6), np.float32)
    tw[1, 2] = -1.5  # frame 1 far behind frame 0: Z < MIN_DEPTH for its points
    tw[2] = 0.1 * r.standard_normal(6)
    poses = lie.retr(lie.identity((F,)), _t(tw)).numpy()
    disps = (r.random((F, h, w)) * 2).astype(np.float32)
    disps[0, 0, :3] = 0.0
    intr = np.tile(np.array([w, w, w / 2, h / 2], np.float32), (F, 1))
    ii, jj = np.array([0, 0, 2, 1]), np.array([1, 2, 0, 1])
    g = r.standard_normal((len(ii), h, w, 2)).astype(np.float32)

    def jfn(p, d):
        c, v = jpops.projective_transform(p, d, jnp.asarray(intr), jnp.asarray(ii), jnp.asarray(jj))
        return jnp.sum(c * v * g)

    jgp, jgd = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jnp.asarray(poses), jnp.asarray(disps))
    p, d = _t(poses).requires_grad_(), _t(disps).requires_grad_()
    c, v = pops.projective_transform(p, d, _t(intr), _t(ii), _t(jj))
    assert (v == 0).any() and (v == 1).any()
    (c * v * _t(g)).sum().backward()
    assert torch.isfinite(p.grad).all() and torch.isfinite(d.grad).all()
    assert _rel(p.grad, jgp) < 1e-5
    assert _rel(d.grad, jgd) < 1e-5


def test_induced_flow_matches_jax():
    target, weight, eta, poses, disps, intr, ii, jj = _ba_problem(5, B=1)
    fj, vj = jpops.induced_flow(jnp.asarray(poses[0]), jnp.asarray(disps[0]), jnp.asarray(intr[0]),
                                jnp.asarray(ii), jnp.asarray(jj))
    ft, vt = pops.induced_flow(_t(poses[0]), _t(disps[0]), _t(intr[0]), _t(ii), _t(jj))
    assert np.abs(ft.numpy() - np.asarray(fj)).max() < 1e-4
    assert np.array_equal(vt.numpy(), np.asarray(vj))


def test_grad_clip_matches_jax():
    r = np.random.default_rng(6)
    x = r.standard_normal((4, 5)).astype(np.float32)
    g = (0.02 * r.standard_normal((4, 5))).astype(np.float32)
    g[0, 0] = np.nan
    _, vjp = jax.vjp(jupdate.grad_clip, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = _t(x).requires_grad_()
    y = tupdate.grad_clip(xt)
    assert torch.equal(y, _t(x))
    y.backward(_t(g))
    assert np.array_equal(xt.grad.numpy(), want)
    assert (want == 0).any() and (want != 0).any()


def test_sim3_matches_jax():
    r = np.random.default_rng(7)
    xi = (0.4 * r.standard_normal((6, 7))).astype(np.float32)
    xi[0, 3:6] = 0.0  # theta = 0
    xi[1, 6] = 0.0  # sigma = 0
    xi[2, 3:] = 0.0  # both
    x = r.standard_normal((6, 3)).astype(np.float32)
    gj = jlie.sim3_exp(jnp.asarray(xi))
    gt = lie.sim3_exp(_t(xi))
    assert np.abs(gt.numpy() - np.asarray(gj)).max() < 1e-5
    hj = jlie.sim3_exp(jnp.asarray(xi[::-1].copy()))
    ht = lie.sim3_exp(_t(xi[::-1].copy()))
    pairs = [
        (lie.sim3_mul(gt, ht), jlie.sim3_mul(gj, hj)),
        (lie.sim3_inv(gt), jlie.sim3_inv(gj)),
        (lie.sim3_act(gt, _t(x)), jlie.sim3_act(gj, jnp.asarray(x))),
        (lie.sim3_retr(ht, _t(xi)), jlie.sim3_retr(hj, jnp.asarray(xi))),
    ]
    for got, want in pairs:
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    assert torch.equal(lie.sim3_identity((2,)), _t(np.asarray(jlie.sim3_identity((2,)))))
    assert torch.allclose(lie.sim3_mul(gt, lie.sim3_inv(gt)), lie.sim3_identity((6,)), atol=1e-5)
