"""The differentiable correlation lookup of the training path
(``ops/corr.py::CorrPyramid``/``CorrLevel``) against ``jax.grad`` through
the JAX package's ``CorrPyramid``; the plain backward under
``torch.autograd.gradcheck``; and numpy emulations of the backward kernel
(``csrc/corr_backward.cu``): its launch plan (the per-edge sort's bin
starts and the per-target candidate ranges of df2), df1 (per-pixel 8x8
support gradient, one chain per channel over the cells in row-major order)
and df2 (one chain per output over the candidates in sorted order), each
against the plain version. The kernel itself runs only on the card
(``chip_smoke.py`` phase 9a)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.ops import corr as jcorr
from droid_slam_tpu_torch.ops import corr, kernels

torch.set_num_threads(2)

# gradients against JAX's: f32 sums in other orders, relative to the
# largest entry of each gradient
TOL = 1e-5


def _features(seed, n, h, w, c=32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, h, w, c)).astype(np.float32),
            r.standard_normal((n, h, w, c)).astype(np.float32))


def _coords(kind, seed, n, h, w):
    r = np.random.default_rng(seed)
    y, x = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    grid = np.stack([x, y], -1)[None]
    if kind == "smooth":
        return (grid * 1.02 + np.array([2.5, -1.5], np.float32)
                + 0.5 * r.standard_normal((n, h, w, 2))).astype(np.float32)
    coords = grid + 3.0 * r.standard_normal((n, h, w, 2)).astype(np.float32)
    if kind == "far":
        far = r.random((n, h, w)) < 0.2
        coords[far] = 1e5 * np.where(r.random((int(far.sum()), 2)) < 0.5, -1.0, 1.0)
        coords[:, 0, :, 1] = -1.0
        coords[:, :, -1, 0] = w - 1.0
    return coords.astype(np.float32)


def _jax_grads(f1, f2, coords, g):
    def fn(a, b):
        return jcorr.CorrPyramid.build(a, b)(jnp.asarray(coords))

    out, vjp = jax.vjp(fn, jnp.asarray(f1), jnp.asarray(f2))
    d1, d2 = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(d1), np.asarray(d2)


def _torch_grads(f1, f2, coords, g):
    a = torch.from_numpy(f1).requires_grad_()
    b = torch.from_numpy(f2).requires_grad_()
    out = corr.CorrPyramid.build(a, b)(torch.from_numpy(coords))
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), a.grad.numpy(), b.grad.numpy()


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kind,hw", [
    ("iid", (8, 8)),  # 64x64 images: the pyramid reaches 1x1
    ("smooth", (8, 8)),
    ("far", (8, 8)),
    ("iid", (6, 8)),  # 48x64 images: level 3 is 0x1, an empty map
])
def test_lookup_gradient_matches_jax(kind, hw):
    h, w = hw
    n = 3
    f1, f2 = _features(1, n, h, w)
    coords = _coords(kind, 2, n, h, w)
    g = np.random.default_rng(3).standard_normal((n, h, w, 4 * 49)).astype(np.float32)
    j_out, j_d1, j_d2 = _jax_grads(f1, f2, coords, g)
    t_out, t_d1, t_d2 = _torch_grads(f1, f2, coords, g)
    assert np.isfinite(t_d1).all() and np.isfinite(t_d2).all()
    assert _rel_err(t_out, j_out) < TOL
    assert _rel_err(t_d1, j_d1) < TOL
    assert _rel_err(t_d2, j_d2) < TOL


def test_lookup_gradcheck_float64():
    r = np.random.default_rng(4)
    f1 = torch.tensor(r.standard_normal((2, 12, 32)), requires_grad=True)
    f2 = torch.tensor(r.standard_normal((2, 3, 4, 32)), requires_grad=True)
    # coords off the integer grid (the lookup is not differentiable in the
    # features' neighbours there), some windows half off the map
    coords = torch.tensor(r.random((2, 12, 2)) * 6 - 1.5 + 0.01)
    assert torch.autograd.gradcheck(lambda a, b: corr.CorrLevel.apply(a, b, coords, 3), (f1, f2))


def test_lookup_refuses_coords_that_require_grad():
    f1, f2 = _features(5, 1, 4, 4)
    pyr = corr.CorrPyramid.build(torch.from_numpy(f1), torch.from_numpy(f2))
    coords = torch.zeros((1, 4, 4, 2), requires_grad=True)
    with pytest.raises(ValueError, match="detach"):
        pyr(coords)


def test_backward_cpu_uses_plain_version_without_launch():
    kernels.reset_launches()
    r = np.random.default_rng(6)
    f1 = torch.from_numpy(r.standard_normal((2, 12, 32)).astype(np.float32))
    f2 = torch.from_numpy(r.standard_normal((2, 3, 4, 32)).astype(np.float32))
    coords = torch.from_numpy((r.random((2, 12, 2)) * 4).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((2, 12, 49)).astype(np.float32))
    got = corr.corr_level_backward(g, f1, f2, coords)
    want = corr.corr_level_backward_ref(g, f1, f2, coords)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES["corr_backward"] == 0


def _origins(coords, radius=3):
    """(x0, y0, dx, dy) of each window: the float expressions of the kernels."""
    f32 = np.float32
    c0 = coords - f32(radius)
    o = np.floor(np.clip(c0, f32(-1e4), f32(1e4)))
    d = c0 - o
    return o[..., 0].astype(np.int64), o[..., 1].astype(np.int64), d[..., 0], d[..., 1]


def _emulate_sort(coords, h2, w2):
    """corr_sort_kernel with its bin starts: per edge a stable sort of the
    pixels by bin (window row + 7, or the last bin row for windows off the
    map's rows; then window column + 7 clamped to [0, W2 + 7]) → perm
    [N, P] and starts [N, bins + 1] (each bin's first sorted position, then
    P)."""
    x0, y0, _, _ = _origins(coords)
    ky = np.where((y0 + 7 >= 0) & (y0 < h2), y0 + 7, h2 + 7)
    kx = np.clip(x0 + 7, 0, w2 + 7)
    key = ky * (w2 + 8) + kx
    bins = (h2 + 8) * (w2 + 8)
    perm = np.argsort(key, axis=1, kind="stable")
    counts = np.stack([np.bincount(k, minlength=bins) for k in key])
    starts = np.concatenate([np.zeros((len(key), 1), np.int64), np.cumsum(counts, axis=1)], axis=1)
    return perm, starts, key


def _df2_candidates(perm, starts, x0, y, xs, w2):
    """The candidates of target (row y, columns [xs, xs+8)) of one edge, the
    list one df2 warp's chain runs over: the 8 bin-row ranges of perm
    (windows with y0 in [y-7, y] and x0 in [xs-7, min(xs+7, W2-1)]) in
    order, then those whose window meets the tile's columns (the ballot)
    → (ranged, kept)."""
    bw = w2 + 8
    lo, hi = xs, min(xs + 14, w2 + 6)
    ranged = np.concatenate([perm[starts[ky * bw + lo]:starts[ky * bw + hi + 1]] for ky in range(y, y + 8)])
    d = x0[ranged] - xs
    return ranged, ranged[(d > -8) & (d < 8)]


def _df2_block_stream(perm, starts, x0, y_lo, xs, h2, w2):
    """The candidates of the df2 block of rows [y_lo, y_lo + 8) and columns
    [xs, xs + 8) of one edge, in stream order: the bin rows of windows with
    y0 in [y_lo - 7, y_hi] and x0 in [xs - 7, min(xs + 7, W2 - 1)], then
    those whose window meets the block's columns."""
    bw = w2 + 8
    y_hi = min(y_lo + 8, h2) - 1
    lo, hi = xs, min(xs + 14, w2 + 6)
    ranged = np.concatenate([perm[starts[ky * bw + lo]:starts[ky * bw + hi + 1]]
                             for ky in range(y_lo, y_hi + 8)])
    d = x0[ranged] - xs
    return ranged[(d > -8) & (d < 8)]


def _level_coords(kind, level, n=3, h=6, w=11):
    return _coords(kind, 8, n, h, w).reshape(n, h * w, 2) / np.float32(2.0**level), h >> level, w >> level


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("kind", ["iid", "smooth", "far"])
def test_backward_plan_candidates_cover_supports(kind, level):
    # far: 20% of the windows at ±1e5, row 0's windows half above the map,
    # the last column's half right of it; W2 = 11 leaves a ragged tile
    coords, h2, w2 = _level_coords(kind, level)
    perm, starts, key = _emulate_sort(coords, h2, w2)
    x0, y0, _, _ = _origins(coords)
    assert starts.shape == (3, (h2 + 8) * (w2 + 8) + 1) and (starts[:, -1] == coords.shape[1]).all()
    for e in range(3):
        for b in range(starts.shape[1] - 1):  # each bin: its pixels, ascending (a stable sort)
            members = perm[e, starts[e, b]:starts[e, b + 1]]
            assert (key[e, members] == b).all() and (np.diff(members) > 0).all()
        for y in range(h2):
            for xs in range(0, w2, 8):
                ranged, kept = _df2_candidates(perm[e], starts[e], x0[e], y, xs, w2)
                meets = ((y0[e] <= y) & (y <= y0[e] + 7) & (x0[e] <= min(xs + 7, w2 - 1))
                         & (x0[e] + 7 >= xs))
                assert sorted(kept) == sorted(np.flatnonzero(meets)) and len(set(kept)) == len(kept)
                # what the ballot drops: far-left windows sharing the bin of x0 = -7
                dropped = np.setdiff1d(ranged, kept)
                assert xs == 0 or len(dropped) == 0
                assert (x0[e, dropped] < -7).all()
                # the block holding this target (8 rows) streams a superset in
                # the same order: its warp's row filter gives the target's list
                stream = _df2_block_stream(perm[e], starts[e], x0[e], y // 8 * 8, xs, h2, w2)
                mine = stream[(y0[e, stream] <= y) & (y <= y0[e, stream] + 7)]
                assert list(mine) == list(kept)


def test_backward_plan_training_shapes():
    # 208 edges (batch 4 x 52 slots), 48x64 features: 3 launches per level,
    # the same number of blocks at every level for the sort and df1 (P does
    # not shrink), df2 one block per 8 rows by 8 columns
    plans = [corr.corr_backward_plan(208, 3072, 48 >> l, 64 >> l, 128) for l in range(4)]
    assert [p.grids for p in plans] == [(208, 208 * 48, 208 * 48), (208, 208 * 48, 208 * 12),
                                        (208, 208 * 48, 208 * 4), (208, 208 * 48, 208)]
    assert plans[0].bins == 56 * 72
    assert plans[0].smem == ((56 * 72 + 3072) * 4, (2 * 64 * 132 + 64 * 64 + 64 * 64) * 4, 64 * 256 * 4)
    assert len(corr.BACKWARD_STAGES) == len(plans[0].grids) == 3
    corr.corr_backward_plan(1, 64, 8, 163, 128)
    with pytest.raises(ValueError, match="227 KB"):
        corr.corr_backward_plan(1, 64, 8, 164, 128)


def _emulate_df1(g, f1, f2, coords, radius=3):
    """Stage 1 of csrc/corr_backward.cu in numpy f32: per pixel the 8x8
    support gradient dPatch (corner weights, cells outside the map zero),
    then df1 as one sum per channel over the cells in row-major order, cells
    off the map skipped → (df1, dPatch [N, P, 8, 8])."""
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    rd, sup = 2 * radius + 1, 2 * radius + 2
    f32 = np.float32
    x0, y0, dx, dy = _origins(coords, radius)
    w00, w10 = (f32(1) - dx) * (f32(1) - dy), dx * (f32(1) - dy)
    w01, w11 = (f32(1) - dx) * dy, dx * dy
    taps = g.reshape(n, p, rd, rd)  # [i (x), j (y)]
    patch = np.zeros((n, p, sup, sup), f32)  # [jy, ix]
    for jy in range(sup):
        for ix in range(sup):
            v = np.zeros((n, p), f32)
            if ix < rd and jy < rd:
                v = v + taps[..., ix, jy] * w00
            if ix > 0 and jy < rd:
                v = v + taps[..., ix - 1, jy] * w10
            if ix < rd and jy > 0:
                v = v + taps[..., ix, jy - 1] * w01
            if ix > 0 and jy > 0:
                v = v + taps[..., ix - 1, jy - 1] * w11
            y, x = y0 + jy, x0 + ix
            inside = (y >= 0) & (y < h2) & (x >= 0) & (x < w2)
            patch[..., jy, ix] = np.where(inside, v, f32(0))
    df1 = np.zeros((n, p, c), f32)
    ni = np.arange(n)[:, None]
    for cell in range(sup * sup):
        jy, ix = divmod(cell, sup)
        y, x = y0 + jy, x0 + ix
        inside = (y >= 0) & (y < h2) & (x >= 0) & (x < w2)
        rows = f2.reshape(n, h2 * w2, c)[ni, np.where(inside, y * w2 + x, 0)]  # [n, p, c]
        df1 = df1 + np.where(inside[..., None], patch[..., jy, ix][..., None] * rows, f32(0))
    return df1, patch


def _emulate_df2(patch, f1, coords, h2, w2):
    """Stage 2 of csrc/corr_backward.cu in numpy f32: per edge and target
    (row y, columns [xs, xs+8)) one float32 sum per output over the kept
    candidates in sorted order, each candidate's dPatch row y - y0 shifted
    onto the tile's columns; outputs no candidate reaches stay 0."""
    n, p, c = f1.shape
    perm, starts, _ = _emulate_sort(coords, h2, w2)
    x0, y0, _, _ = _origins(coords)
    df2 = np.zeros((n, h2, w2, c), np.float32)
    for e in range(n):
        for y in range(h2):
            for xs in range(0, w2, 8):
                acc = np.zeros((8, c), np.float32)
                for q in _df2_candidates(perm[e], starts[e], x0[e], y, xs, w2)[1]:
                    w = np.zeros(8, np.float32)
                    d = x0[e, q] - xs
                    for m in range(8):
                        if 0 <= m + d < 8:
                            w[m + d] = patch[e, q, y - y0[e, q], m]
                    acc = acc + w[:, None] * f1[e, q][None, :]
                df2[e, y, xs:xs + 8] = acc[:min(8, w2 - xs)]
    return df2


def _backward_inputs(kind, level=0):
    coords, h2, w2 = _level_coords(kind, level, h=6, w=8)
    n, p, c = 3, 48, 32
    r = np.random.default_rng(7)
    f1 = r.standard_normal((n, p, c)).astype(np.float32)
    f2 = r.standard_normal((n, h2, w2, c)).astype(np.float32)
    g = r.standard_normal((n, p, 49)).astype(np.float32)
    want = corr.corr_level_backward_ref(*(torch.from_numpy(a) for a in (g, f1, f2, coords)))
    return g, f1, f2, coords, [w.numpy() for w in want]


@pytest.mark.parametrize("kind", ["iid", "smooth", "far"])
def test_kernel_emulation_matches_plain_backward(kind):
    g, f1, f2, coords, (w1, _) = _backward_inputs(kind)
    df1, patch = _emulate_df1(g, f1, f2, coords)
    assert _rel_err(df1, w1) < TOL
    # the dPatch scratch df2 reads: every cell off the map is exactly 0
    x0, y0, _, _ = _origins(coords)
    h2, w2 = f2.shape[1:3]
    jy, ix = np.arange(8)[:, None], np.arange(8)[None, :]
    y, x = y0[..., None, None] + jy, x0[..., None, None] + ix
    off = (y < 0) | (y >= h2) | (x < 0) | (x >= w2)
    assert off.any() and (patch[off] == 0).all()


@pytest.mark.parametrize("kind", ["iid", "smooth", "far"])
def test_df2_emulation_matches_plain_backward(kind):
    g, f1, f2, coords, (_, w2) = _backward_inputs(kind)
    _, patch = _emulate_df1(g, f1, f2, coords)
    df2 = _emulate_df2(patch, f1, coords, *f2.shape[1:3])
    assert _rel_err(df2, w2) < TOL

