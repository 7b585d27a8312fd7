"""Port parity: SE(3), projective geometry, frame distance and the
correlation lookup against the JAX package on seeded inputs.

Tolerance 1e-4 L∞ in f32, except the comparison with the Pallas kernel in
interpret mode, which uses the bounds of tests/test_pallas_corr.py (interpret
mode emulates the MXU's bf16 passes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.ops import corr as jcorr
from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.ops import pallas_corr as jpallas
from droid_slam_tpu.ops import projective as jpops
from droid_slam_tpu.runtime import video as jvideo
from droid_slam_tpu_torch.ops import corr as tcorr
from droid_slam_tpu_torch.ops import lie as tlie
from droid_slam_tpu_torch.ops import projective as tpops
from droid_slam_tpu_torch.runtime import video as tvideo

torch.set_num_threads(2)

TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _err(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


def _twists(seed, n=64):
    """Random twists, with rotation angles spread across both Taylor
    switch points (θ² < 1e-8 and θ ≤ 1e-4) and well above them."""
    r = np.random.default_rng(seed)
    xi = r.standard_normal((n, 6)).astype(np.float32)
    scale = np.array([1e-6, 5e-5, 2e-4, 1e-2, 0.5, 2.0], np.float32)
    xi[:, 3:] *= scale[np.arange(n) % len(scale), None]
    return xi


# -----------------------------------------------------------------------------
# SE(3)
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["exp", "log", "inv"])
def test_lie_unary_matches_jax(fn):
    xi = _twists(0)
    if fn == "exp":
        x = xi
    else:
        x = np.asarray(jlie.exp(jnp.asarray(xi)))
    want = getattr(jlie, fn)(jnp.asarray(x))
    got = getattr(tlie, fn)(_t(x))
    assert _err(want, got) < TOL


@pytest.mark.parametrize("fn", ["retr", "mul", "act"])
def test_lie_binary_matches_jax(fn):
    xi = _twists(1)
    G = np.asarray(jlie.exp(jnp.asarray(_twists(2))))
    if fn == "retr":
        a, b = G, xi
    elif fn == "mul":
        a, b = G, np.asarray(jlie.exp(jnp.asarray(xi)))
    else:
        pts = np.random.default_rng(3).standard_normal((G.shape[0], 4)).astype(np.float32)
        a, b = G, pts
    want = getattr(jlie, fn)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tlie, fn)(_t(a), _t(b))
    assert _err(want, got) < TOL


# -----------------------------------------------------------------------------
# projective geometry
# -----------------------------------------------------------------------------


def _geometry(seed, F=4, h=5, w=7):
    r = np.random.default_rng(seed)
    xi = np.concatenate([0.1 * r.standard_normal((F, 3)), 0.05 * r.standard_normal((F, 3))], -1)
    poses = np.array(jlie.exp(jnp.asarray(xi, jnp.float32)))
    disps = (0.2 + r.random((F, h, w))).astype(np.float32)
    intr = np.tile(np.array([[w * 0.8, h * 0.9, w / 2, h / 2]], np.float32), (F, 1))
    ii = np.array([0, 1, 2, 3, 1, 2], np.int32)
    jj = np.array([1, 0, 3, 2, 1, 0], np.int32)  # (1, 1) is a self edge
    return poses, disps, intr, ii, jj


def test_iproj_matches_jax():
    _, disps, intr, _, _ = _geometry(4)
    assert _err(jpops.iproj(jnp.asarray(disps), jnp.asarray(intr)), tpops.iproj(_t(disps), _t(intr))) < TOL


def test_projective_transform_matches_jax():
    poses, disps, intr, ii, jj = _geometry(5)
    want = jpops.projective_transform(
        *map(jnp.asarray, (poses, disps, intr, ii, jj)), jacobian=True
    )
    got = tpops.projective_transform(
        _t(poses), _t(disps), _t(intr), _t(ii).long(), _t(jj).long(), jacobian=True
    )
    coords, valid, jac = got
    assert _err(want[0], coords) < TOL
    assert _err(want[1], valid) == 0.0
    for a, b in zip(want[2], jac):
        assert tuple(a.shape) == tuple(b.shape)
        assert _err(a, b) < TOL


# -----------------------------------------------------------------------------
# frame distance
# -----------------------------------------------------------------------------


def _distance(poses, disps, intr, ii, jj, beta=0.3):
    want = jvideo._frame_distance(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr[0]),
        jnp.asarray(ii), jnp.asarray(jj), beta,
    )
    got = tvideo._frame_distance(
        _t(poses), _t(disps), _t(intr[0]), _t(ii).long(), _t(jj).long(), beta
    )
    return np.asarray(want), got.numpy()


def test_depth_to_disp_sens_matches_jax():
    r = np.random.default_rng(13)
    depth = (0.5 + 4 * r.random((64, 80))).astype(np.float32)
    depth[r.random(depth.shape) < 0.3] = 0.0  # missing depth stays 0
    want = jvideo._depth_to_disp_sens(jnp.asarray(depth), 8, 10)
    got = tvideo._depth_to_disp_sens(_t(depth), 8, 10)
    assert got.shape == (8, 10)
    assert (got == 0).any()
    assert _err(want, got) < 1e-6


def test_frame_distance_matches_jax():
    want, got = _distance(*_geometry(6))
    assert np.abs(want - got).max() < TOL


def test_frame_distance_z_zero_pixel_is_finite():
    poses, disps, intr, ii, jj = _geometry(7)
    # frame 1 sits at the same depth plane as one source pixel: Z1 = 0 there,
    # while every other pixel stays valid (so the pair is not the 1000 case)
    disps[0] = 0.3
    disps[0, 2, 3] = 1.0
    poses[1] = [0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 1.0]
    poses[0] = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
    want, got = _distance(poses, disps, intr, ii[:1], jj[:1])
    assert np.isfinite(got).all()
    assert np.abs(want - got).max() < TOL


def test_frame_distance_below_75_percent_valid_is_1000():
    poses, disps, intr, ii, jj = _geometry(8)
    # move frame 1 far in front of frame 0's points: most land behind it
    poses[0] = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
    poses[1] = [0.0, 0.0, -3.0, 0.0, 0.0, 0.0, 1.0]
    want, got = _distance(poses, disps, intr, ii[:1], jj[:1])
    assert got[0] == 1000.0
    assert want[0] == 1000.0


# -----------------------------------------------------------------------------
# correlation
# -----------------------------------------------------------------------------


def _case(rng, N=1, h=6, w=8, C=16):
    """The shapes of tests/test_pallas_corr.py::_case."""
    f1 = (rng.standard_normal((N, h * w, C)) * 0.25).astype(np.float32)
    f2 = (rng.standard_normal((N, h, w, C)) * 0.25).astype(np.float32)
    coords = (rng.random((N, h * w, 2)) * np.array([w + 6, h + 6]) - 3).astype(np.float32)
    return f1, f2, coords


def test_corr_level_ref_matches_xla_sampler():
    f1, f2, coords = _case(np.random.default_rng(9), N=2)
    with jax.default_matmul_precision("highest"):
        want = jcorr._alt_corr_level_T(*map(jnp.asarray, (f1, f2, coords)), 3)
    got = tcorr.corr_level_ref(_t(f1), _t(f2), _t(coords))
    assert got.shape == want.shape
    assert _err(want, got) < TOL


def test_corr_level_ref_matches_pallas_interpret():
    f1, f2, coords = _case(np.random.default_rng(10))
    want = jpallas.corr_level_pallas(*map(jnp.asarray, (f1, f2, coords)), interpret=True)
    got = tcorr.corr_level_ref(_t(f1), _t(f2), _t(coords)).transpose(1, 2)
    diff = np.abs(np.asarray(want) - got.numpy())
    assert diff.max() < 1e-2
    assert diff.mean() < 2e-3


@pytest.mark.parametrize("far", [1000.0, 1e5])
def test_corr_level_out_of_range_is_exact_zero(far):
    f1, f2, _ = _case(np.random.default_rng(11))
    coords = np.full(f1.shape[:2] + (2,), far, np.float32)
    assert float(tcorr.corr_level_ref(_t(f1), _t(f2), _t(coords)).abs().max()) == 0.0
    assert float(tcorr.corr_level_ref(_t(f1), _t(f2), _t(-coords)).abs().max()) == 0.0


def test_corr_lookup_matches_jax():
    r = np.random.default_rng(12)
    N, h, w, C = 2, 8, 8, 128
    f1 = r.standard_normal((N, h, w, C)).astype(np.float32)
    f2 = r.standard_normal((N, h, w, C)).astype(np.float32)
    coords = (r.random((N, h, w, 2)) * np.array([w + 4, h + 4]) - 2).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jcorr.corr_lookup_fused(*map(jnp.asarray, (f1, f2, coords)))
    got = tcorr.corr_lookup(_t(f1), _t(f2), _t(coords))
    assert got.shape == want.shape == (N, h, w, 196)
    # |corr| reaches ~10 at C=128: 1e-4 relative to the largest value
    scale = float(np.abs(np.asarray(want)).max())
    assert _err(want, got) < TOL * max(scale, 1.0)


# -----------------------------------------------------------------------------
# correlation: the backend's split lookup and the filler's volume mode
# -----------------------------------------------------------------------------


def test_corr_level_split_ref_matches_xla_sampler():
    f1, f2, coords = _case(np.random.default_rng(21), N=2)
    with jax.default_matmul_precision("highest"):
        want = jcorr._alt_corr_level_T(*map(jnp.asarray, (f1, f2, coords)), 3)
    got = tcorr.corr_level_split_ref(_t(f1), _t(f2), _t(coords))
    assert got.shape == want.shape
    assert _err(want, got) < TOL


def test_corr_level_split_ref_matches_pallas_split_interpret():
    f1, f2, coords = _case(np.random.default_rng(22))
    want = jpallas.corr_level_pallas_split(*map(jnp.asarray, (f1, f2, coords)), interpret=True)
    got = tcorr.corr_level_split_ref(_t(f1), _t(f2), _t(coords)).transpose(1, 2)
    diff = np.abs(np.asarray(want) - got.numpy())
    assert diff.max() < 1e-2
    assert diff.mean() < 2e-3


def test_corr_slab_ref_matches_numpy_slab():
    """Row selection and zero rows against an explicit slab; exact up to
    the f32 summation order of the dot."""
    f1, f2, coords = _case(np.random.default_rng(23), N=2)
    n, p, _ = f1.shape
    h2, w2 = f2.shape[1:3]
    coords[0, :4, 1] = [-9.0, -3.5, h2 + 2.5, 1e5]  # windows partly or wholly off the map
    got = tcorr.corr_slab_ref(_t(f1), _t(f2), _t(coords)).numpy()
    want = np.zeros((n, p, 8, w2), np.float32)
    y0 = np.floor(np.clip(coords[..., 1] - 3, -1e4, 1e4)).astype(np.int64)
    for e in range(n):
        for q in range(p):
            for r in range(8):
                y = y0[e, q] + r
                if 0 <= y < h2:
                    want[e, q, r] = f2[e, y] @ f1[e, q]
    assert (want[0, :4] == 0).any() and (want[0, 3] == 0).all()
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-6 * scale
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("shape", [(0, 3), (3, 0)])
def test_corr_lookups_on_an_empty_map_are_zero(shape):
    """The coarsest level of a small image can have no rows or columns."""
    f1, _, coords = _case(np.random.default_rng(28))
    f2 = _t(np.zeros((1,) + shape + (16,), np.float32))
    for fn in (tcorr.corr_level_ref, tcorr.corr_level_split_ref):
        out = fn(_t(f1), f2, _t(coords))
        assert out.shape == (1, f1.shape[1], 49)
        assert float(out.abs().max()) == 0.0


@pytest.mark.parametrize("far", [1000.0, 1e5])
def test_corr_level_split_out_of_range_is_exact_zero(far):
    f1, f2, _ = _case(np.random.default_rng(24))
    coords = np.full(f1.shape[:2] + (2,), far, np.float32)
    for c in (coords, -coords):
        slab = tcorr.corr_slab_ref(_t(f1), _t(f2), _t(c))
        assert float(slab.abs().max()) == 0.0
        assert float(tcorr.corr_window_ref(slab, _t(c)).abs().max()) == 0.0


def _fmaps_coords(seed, n=3, h=8, w=8, c=128):
    r = np.random.default_rng(seed)
    fmaps = r.standard_normal((n, h, w, c)).astype(np.float32)
    coords = (r.random((n, h, w, 2)) * np.array([w + 4, h + 4]) - 2).astype(np.float32)
    return fmaps, coords


def test_alt_corr_matches_jax():
    fmaps, coords = _fmaps_coords(25)
    ii = np.array([0, 1, 2, 0], np.int32)
    jj = np.array([1, 2, 0, 0], np.int32)
    coords = np.concatenate([coords, coords[:1]])
    with jax.default_matmul_precision("highest"):
        want = jcorr.AltCorr.build(jnp.asarray(fmaps))(jnp.asarray(coords), jnp.asarray(ii), jnp.asarray(jj))
    got = tcorr.AltCorr.build(_t(fmaps))(_t(coords), _t(ii).long(), _t(jj).long())
    assert got.shape == want.shape == (4, 8, 8, 196)
    scale = float(np.abs(np.asarray(want)).max())
    assert _err(want, got) < TOL * max(scale, 1.0)


def test_corr_pyramid_matches_jax():
    # the JAX package's volume-mode pyramid (its host engine's and filler's
    # lookup) against the port's fused lookup, which takes its place there
    fmaps, coords = _fmaps_coords(26, n=2)
    f2 = np.roll(fmaps, 1, axis=0)
    with jax.default_matmul_precision("highest"):
        want = jcorr.CorrPyramid.build(jnp.asarray(fmaps), jnp.asarray(f2))(jnp.asarray(coords))
    got = tcorr.corr_lookup(_t(fmaps), _t(f2), _t(coords))
    assert got.shape == want.shape == (2, 8, 8, 196)
    assert _err(want, got) < TOL * max(float(np.abs(np.asarray(want)).max()), 1.0)


def test_corr_index_matches_jax():
    # the window lookup into a volume: the port's window sampler under
    # corr_level_ref, with far-out coords giving exact zeros
    r = np.random.default_rng(27)
    vol = r.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    coords = (r.random((2, 3, 4, 2)) * np.array([12, 10]) - 3).astype(np.float32)
    coords[0, 0, 0] = [1e5, -1e5]
    with jax.default_matmul_precision("highest"):
        want = jcorr.corr_index(jnp.asarray(vol), jnp.asarray(coords))
    got = tcorr._window_sample(_t(vol).reshape(24, 5, 6), _t(coords).reshape(24, 2), 3).reshape(2, 3, 4, 49)
    assert got.shape == want.shape == (2, 3, 4, 49)
    assert _err(want, got) < TOL
    assert float(got[0, 0, 0].abs().max()) == 0.0
