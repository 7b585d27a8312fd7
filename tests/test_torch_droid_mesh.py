"""``Droid.warm_terminate`` and ``Droid(ba_mesh=)`` on the CPU.

``warm_terminate`` runs the global BA and one trajectory-filler batch on a
throwaway state: the live tracking state (either engine) must be bitwise
what it was, and a ``terminate(stream)`` after it must equal one without
it bit for bit. With ``ba_mesh``, a 1-rank gloo group, ``terminate`` runs
the sharded BA and must agree with the single-device terminate, after a
``warm_terminate`` that carries the group:

* in f32 within the BA's 1e-4 (an RGB-D replay, and a monocular one at a
  cut of ``chip_smoke.py``'s bench configuration: 96x128, every frame a
  keyframe, random weights);
* in bf16 (the bench configuration's compute type) the single-device
  backend stores the Schur blocks E in bf16 and the sharded one in f32.
  That moves a random-weight monocular terminate by a share of the
  trajectory that depends on the scene (~1e-3 of the largest |pose| here),
  so the bound is relative: the largest pose and
  disparity differences within SHARDED_VS_SINGLE_TOL of the largest |pose|
  and |disparity| of the single-device run (~1e-3 and ~2e-3 here, ~1e-3
  and ~4e-3 on the card at the bench configuration). It catches a broken
  solve, not rounding; what pins the sharded path in bf16 is that the
  single-device backend with E stored in f32 gives the sharded result
  within 1e-4. ``chip_smoke.py`` phase 10a holds the card's sharded
  terminate to these bounds and makes the same f32 check.

A group whose backend cannot carry the tensors' device raises."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from droid_slam_tpu_torch.models.droid_net import init_params
from droid_slam_tpu_torch.ops import ba as ba_ops
from droid_slam_tpu_torch.parallel.groups import check_device
from droid_slam_tpu_torch.runtime import Droid, DroidConfig

torch.set_num_threads(2)

CONFIG = dict(
    image_size=(64, 64),
    buffer=12,
    warmup=4,
    max_factors=16,
    inactive_pad=16,
    window_pad=16,
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


def _frames(n=7, seed=21):
    r = np.random.default_rng(seed)
    return [(r.integers(0, 255, (64, 64, 3), np.uint8),
             ((1.0 + 2.0 * r.random((64, 64))) * (r.random((64, 64)) > 0.2)).astype(np.float32))
            for _ in range(n)]


def _tracked(fused: bool, ba_mesh=None) -> Droid:
    d = Droid(DroidConfig(**CONFIG), params=init_params(3), device="cpu", fused=fused, ba_mesh=ba_mesh)
    with torch.backends.mkldnn.flags(enabled=False):
        for t, (img, depth) in enumerate(_frames()):
            d.track(t, img, depth=depth, intrinsics=INTR)
    return d


def _stream():
    return iter([(t + 0.5, img, INTR) for t, (img, _) in enumerate(_frames())])


def _snapshot(d: Droid):
    """Copies of every tensor and array of the live tracking state."""
    if d.fused:
        items = [(f.name, getattr(d._state, f.name)) for f in dataclasses.fields(d._state)]
    else:
        items = list(vars(d.video).items()) + [("graph." + k, v) for k, v in vars(d.frontend.graph).items()]
    out = {}
    for k, v in items:
        if torch.is_tensor(v):
            out[k] = v.clone()
        elif isinstance(v, np.ndarray):
            out[k] = v.copy()
        elif isinstance(v, (int, float)):
            out[k] = v
    return out


def _same(a, b):
    if torch.is_tensor(a):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("fused", [True, False])
def test_warm_terminate_leaves_state_and_terminate_unchanged(fused):
    warm = _tracked(fused)
    before = _snapshot(warm)
    assert len(before) > 8
    with torch.backends.mkldnn.flags(enabled=False):
        warm.warm_terminate()
    after = _snapshot(warm)
    assert set(after) == set(before)
    changed = [k for k in before if not _same(before[k], after[k])]
    assert not changed, changed
    cold = _tracked(fused)
    with torch.backends.mkldnn.flags(enabled=False):
        got = warm.terminate(_stream())
        want = cold.terminate(_stream())
    assert got.shape == (len(_frames()), 7)
    np.testing.assert_array_equal(got, want)
    assert warm.backend_runs == cold.backend_runs


@pytest.fixture
def gloo_group():
    """A 1-rank gloo group in this process, destroyed afterwards."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_droid_ba_mesh_matches_single_device(gloo_group):
    mesh = _tracked(True, ba_mesh=gloo_group)
    with torch.backends.mkldnn.flags(enabled=False):
        mesh.warm_terminate(expected_keyframes=6)
        got = mesh.terminate()
        want = _tracked(True).terminate()
    assert got.shape == want.shape == (mesh.counter, 7)
    assert np.abs(got - want).max() < 1e-4
    assert np.abs(want - want[:1]).max() > 1e-3  # a trajectory, not one pose


# chip_smoke.py's BENCH_CONFIG cut to 96x128 and 16 slots
BENCH_CUT = dict(
    image_size=(96, 128),
    buffer=16,
    warmup=4,
    max_factors=24,
    inactive_pad=32,
    window_pad=16,
    filter_thresh=-1.0,
    keyframe_thresh=0.0,
    frontend_window=8,
    frontend_thresh=1e9,
    backend_thresh=1e9,
)
# f32: absolute, the BA's bound; bf16: relative to the largest |pose| and
# |disparity| of the single-device run (module docstring)
SHARDED_VS_SINGLE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.02, 0.02)}  # (poses, disps)


def _terminated(d: Droid):
    traj = d.terminate()
    v = d.video
    return traj, v.poses[: v.counter].clone(), v.disps[: v.counter].clone()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_terminate_against_single_device(gloo_group, monkeypatch, dtype):
    d = Droid(DroidConfig(**dict(BENCH_CUT, compute_dtype=dtype)), params=init_params(0), device="cpu")
    r = np.random.default_rng(0)
    intr = np.array([1.2 * 128, 1.2 * 128, 64.0, 48.0], np.float32)
    with torch.no_grad():
        for t in range(12):
            d.track(t, r.integers(0, 255, (96, 128, 3), np.uint8), intrinsics=intr)
        _, sp, sd = _terminated(d)
        d.ba_mesh = gloo_group
        _, gp, gd = _terminated(d)
        runs = d.backend_runs
    assert d.counter == 12 and np.isfinite(gp.numpy()).all()
    dp, dd = float((gp - sp).abs().max()), float((gd - sd).abs().max())
    tol_p, tol_d = SHARDED_VS_SINGLE_TOL[dtype]
    if dtype == "float32":
        assert dp < tol_p and dd < tol_d, (dp, dd)
        return
    assert dp <= tol_p * float(sp.abs().max()) and dd <= tol_d * float(sd.abs().max()), (dp, dd)
    # the single-device backend with E stored in f32 is the sharded one
    solve = ba_ops.ba_solve
    monkeypatch.setattr(ba_ops, "ba_solve", lambda *a, schur_dtype=None, **k: solve(*a, **k))
    d.ba_mesh = None
    with torch.no_grad():
        _, fp, fd = _terminated(d)
    assert d.backend_runs == runs
    assert float((fp - gp).abs().max()) < 1e-4 and float((fd - gd).abs().max()) < 1e-4


def test_groups_refuse_devices_they_cannot_carry(gloo_group):
    check_device(gloo_group, "cpu")
    with pytest.raises(RuntimeError, match="cannot carry cuda tensors"):
        check_device(gloo_group, torch.device("cuda"))
    with pytest.raises(RuntimeError, match="cannot carry meta tensors"):
        check_device(gloo_group, "meta")
