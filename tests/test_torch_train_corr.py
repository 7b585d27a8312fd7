"""The differentiable correlation lookup of the training path
(``ops/corr.py::CorrPyramid``/``CorrLevel``) against ``jax.grad`` through
the JAX package's ``CorrPyramid``; the plain backward under
``torch.autograd.gradcheck``; and a numpy emulation of the backward
kernel's arithmetic (``csrc/corr_backward.cu``: per-pixel 8x8 support
gradient, dense dV rows, df1 gather, df2 = dVᵀ·f1) against the plain
version. The kernel itself runs only on the card (``chip_smoke.py`` phase
9a)."""

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


def test_backward_chunks():
    # at the training defaults (48x64 features, 208 edges) level 0's dV is
    # 37.7 MB per edge: 56 edges per 2 GiB launch, 4 launches; the coarser
    # levels fit in one
    assert corr.backward_chunk_edges(3072, 48, 64) == 56
    assert [-(-208 // corr.backward_chunk_edges(3072, 48 >> l, 64 >> l)) for l in range(4)] == [4, 1, 1, 1]
    assert corr.backward_chunk_edges(1, 0, 8) == 65535


def _emulate_kernel(g, f1, f2, coords, radius=3):
    """The arithmetic of csrc/corr_backward.cu in numpy f32: per pixel the
    8x8 support gradient (corner weights, cells outside the map zero), the
    pixel's dense dV row, df1 as one sum per channel over the cells in
    row-major order, then df2 = dVᵀ·f1 per edge."""
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    rd, sup = 2 * radius + 1, 2 * radius + 2
    f32 = np.float32
    c0 = coords - f32(radius)
    o = np.floor(np.clip(c0, f32(-1e4), f32(1e4)))
    d = c0 - o
    dx, dy = d[..., 0], d[..., 1]
    x0, y0 = o[..., 0].astype(np.int64), o[..., 1].astype(np.int64)
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
    dV = np.zeros((n, p, h2 * w2), f32)
    df1 = np.zeros((n, p, c), f32)
    ni, pi = np.meshgrid(np.arange(n), np.arange(p), indexing="ij")
    for cell in range(sup * sup):
        jy, ix = divmod(cell, sup)
        y, x = y0 + jy, x0 + ix
        inside = (y >= 0) & (y < h2) & (x >= 0) & (x < w2)
        idx = np.where(inside, y * w2 + x, 0)
        dV[ni[inside], pi[inside], idx[inside]] = patch[..., jy, ix][inside]
        rows = f2.reshape(n, h2 * w2, c)[ni, idx]  # [n, p, c]
        df1 = df1 + np.where(inside[..., None], patch[..., jy, ix][..., None] * rows, f32(0))
    df2 = np.einsum("npv,npc->nvc", dV, f1).reshape(n, h2, w2, c)
    return df1, df2.astype(f32), dV


@pytest.mark.parametrize("kind", ["iid", "smooth", "far"])
def test_kernel_emulation_matches_plain_backward(kind):
    n, h, w, c = 3, 6, 8, 32
    r = np.random.default_rng(7)
    f1 = r.standard_normal((n, h * w, c)).astype(np.float32)
    f2 = r.standard_normal((n, h, w, c)).astype(np.float32)
    coords = _coords(kind, 8, n, h, w).reshape(n, h * w, 2)
    g = r.standard_normal((n, h * w, 49)).astype(np.float32)
    df1, df2, dV = _emulate_kernel(g, f1, f2, coords)
    w1, w2 = corr.corr_level_backward_ref(*(torch.from_numpy(a) for a in (g, f1, f2, coords)))
    assert _rel_err(df1, w1.numpy()) < TOL
    assert _rel_err(df2, w2.numpy()) < TOL
    # each pixel's dV row holds at most its 8x8 support
    assert ((dV != 0).sum(-1) <= 64).all()
