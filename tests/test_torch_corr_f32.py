"""The float32 band tiles of the correlation kernels
(``csrc/corr_tile_f32.cuh``: ``corr_slab_f32_kernel``,
``corr_level_f32_kernel``) on the CPU.

The kernels run only on a CUDA device, where ``chip_smoke.py`` holds them
against their plain versions. What these tests reach:

(a) the f32 tile plan that every launch passes in and the entry points
    check: the pixel tile, the padded staged rows, the shared memory, the
    shapes it refuses, and the wrappers' refusal before any launch;
(b) a numpy emulation of the kernels' work partition: per edge a stable
    sort of the pixels by window origin (row, then column), per block one
    edge and tp consecutive sorted pixels, warps of 16 that multiply a band
    row only when one of their pixels needs it (``corr_level`` only over
    the columns of their windows), one fmaf chain per output over ascending
    channels, the off-map rows written as zeros once, the supports and the
    blend of ``corr_level``.
    It holds that every slab entry is written exactly once, that a warp
    skips exactly the band rows none of its pixels needs, and that the
    emulated arithmetic agrees with ``corr_slab_ref`` and
    ``corr_level_ref``;
(c) ``chip_smoke.py``'s count of band rows computed against rows needed,
    against the emulation.

The plain versions' parity with the Pallas kernels (interpret mode) is held
in ``tests/test_torch_ops.py``.
"""

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.ops import corr

torch.set_num_threads(2)

R = 3
ROWS = 2 * R + 2
TAPS = (2 * R + 1) ** 2
NO_ROW = -(1 << 20)  # corr_tile.cuh::kNoRow, the origin of a pixel past P

# (H2, W2) of every level the paths use at C=128: 240×320 (tracking, the
# backend), 192×256 (the monocular protocol rows), 96×128 (RGB-D, stereo,
# the cull replay) and 384×512 (the long loop), 1/8 resolution, pooled 3×
FEATURES = [(30, 40), (24, 32), (12, 16), (48, 64)]
LEVELS = sorted({(h >> l, w >> l) for h, w in FEATURES for l in range(4)})


# -----------------------------------------------------------------------------
# (a) the f32 tile plan
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["corr_level", "corr_slab"])
@pytest.mark.parametrize("h2,w2", LEVELS)
@pytest.mark.parametrize("n", [48, 256, 1])
def test_f32_plan_fits_and_pads(kernel, h2, w2, n):
    c, p = 128, 1200
    plan = corr.corr_tile_plan_f32(kernel, n, p, w2, c)
    assert plan.w2pad % 8 == 0 and w2 <= plan.w2pad < w2 + 8
    assert plan.row_stride == 4 * (c + 4) and (plan.row_stride // 16) % 2 == 1  # odd 16-byte units
    assert plan.n_tiles == min(8, plan.w2pad // 8)
    # 64 pixels when that gives every SM a block; the probe's one edge takes 16
    want_tp = next((tp for tp in (64, 32, 16) if n * -(-p // tp) >= corr.SM_COUNT), 16)
    assert plan.tp == want_tp
    if n == 1:
        assert plan.tp == 16
    assert plan.grid == (-(-p // plan.tp), n)
    static, supports = corr._F32_SMEM[kernel]
    want = (plan.tp + corr.STAGES * plan.w2pad) * plan.row_stride + (plan.tp * 256 if supports else 0)
    assert plan.smem_bytes == want
    assert static + plan.smem_bytes <= corr.SMEM_LIMIT == 227 * 1024


# the widest map each kernel's plan takes per C (the shapes refused past
# them are listed in csrc/corr_tile_f32.cuh)
WIDEST = [(k, c, w) for k in ("corr_level", "corr_slab") for c, w in ((128, 136), (256, 64), (64, 272))]
WIDEST += [("corr_level", 32, 520), ("corr_slab", 32, 528)]


@pytest.mark.parametrize("kernel,c,widest", WIDEST)
def test_f32_plan_shrinks_the_tile_then_raises_past_227kb(kernel, c, widest):
    plan = corr.corr_tile_plan_f32(kernel, 256, 1200, widest, c)
    assert plan.tp in (16, 32, 64)
    if c == 256:  # 64 pixels of 1040-byte rows do not fit beside 3 × 64 columns
        assert plan.tp < 64
    with pytest.raises(ValueError, match="227 KB"):
        corr.corr_tile_plan_f32(kernel, 256, 1200, widest + 8, c)


@pytest.mark.parametrize("wrapper", ["corr_level", "corr_slab"])
def test_f32_wrappers_raise_on_a_plan_that_does_not_fit(wrapper, monkeypatch):
    """A non-CPU f32 tensor whose plan needs more than 227 KB raises before
    any launch (meta tensors stand in for CUDA ones; the device check is
    bypassed, the plan and the launch counts are real)."""
    from droid_slam_tpu_torch.ops import kernels

    monkeypatch.setattr(corr, "_check_cuda", lambda name, *t: None)
    kernels.reset_launches()
    f1 = torch.empty((1, 64, 256), dtype=torch.float32, device="meta")
    f2 = torch.empty((1, 4, 72, 256), dtype=torch.float32, device="meta")
    coords = torch.empty((1, 64, 2), dtype=torch.float32, device="meta")
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    with pytest.raises(ValueError, match="227 KB"):
        getattr(corr, wrapper)(f1, f2, coords)
    assert kernels.LAUNCHES[wrapper] == 0 and not kernels.DTYPE_LAUNCHES


def test_launch_counts_by_dtype(monkeypatch):
    """kernels.launch counts a launch under its kernel and, when the wrapper
    names one, under kernel_dtype; reset clears both."""
    from droid_slam_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "library", lambda name: type("L", (), {
        kernels.KERNELS[name][1]: staticmethod(lambda *a: 0)})())
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    kernels.reset_launches()
    kernels.launch("corr_level", None, dtype="f32")
    kernels.launch("corr_level", None, dtype="f32")
    kernels.launch("corr_level", None, dtype="bf16")
    kernels.launch("corr_window", None)
    assert kernels.LAUNCHES["corr_level"] == 3 and kernels.LAUNCHES["corr_window"] == 1
    assert kernels.DTYPE_LAUNCHES == {"corr_level_f32": 2, "corr_level_bf16": 1}
    kernels.reset_launches()
    assert kernels.LAUNCHES["corr_level"] == 0 and kernels.DTYPE_LAUNCHES == {}


# -----------------------------------------------------------------------------
# (b) the work partition, emulated in numpy
# -----------------------------------------------------------------------------


def _origin(c):
    """floor of the clipped coordinate minus r (corr_tile.cuh::origin)."""
    c0 = (c - R).astype(np.float32)
    f = np.floor(np.clip(c0, -1e4, 1e4))
    return f.astype(np.int64), (c0 - f).astype(np.float32)


def _fma_volume(f1, f2):
    """vol[n, p, y, x]: per output one fmaf chain from 0 over ascending
    channels, in float32 (the product exact in float64, one rounding per
    step)."""
    n, p, c = f1.shape
    a = f1.astype(np.float64)[:, :, None, None, :]
    b = f2.astype(np.float64)[:, None]
    acc = np.zeros((n, p) + f2.shape[1:3], np.float32)
    for k in range(c):
        acc = (acc.astype(np.float64) + a[..., k] * b[..., k]).astype(np.float32)
    return acc


def _sort_order(coords, h2, w2):
    """corr_sort_kernel: per edge, the pixels in a stable order of their
    bin: the window's first row (windows that miss the map last), then its
    first column clamped to [-7, W2]."""
    x0, _ = _origin(coords[..., 0])
    y0, _ = _origin(coords[..., 1])
    ky = np.where((y0 + ROWS - 1 >= 0) & (y0 < h2), y0 + ROWS - 1, h2 + ROWS - 1)
    kx = np.clip(x0 + ROWS - 1, 0, w2 + ROWS - 1)
    return np.argsort(ky * (w2 + ROWS) + kx, axis=1, kind="stable")


def _emulate(f1, f2, coords, tp):
    """The kernels' partition: per edge the sort, blocks of tp consecutive
    sorted pixels, warps of 16 that multiply a band row only when one of
    their pixels needs it, over every column (the slab) or over the 8-column
    blocks that hold the windows' in-map columns (the fused lookup). Returns
    the slab, how many times each slab entry was written, the supports of
    corr_level, and per warp (band rows multiplied, band rows skipped, rows
    needed)."""
    n, p, _ = f1.shape
    h2, w2 = f2.shape[1:3]
    w2pad = -(-w2 // 8) * 8
    vol = _fma_volume(f1, f2)
    x0, _ = _origin(coords[..., 0])
    y0, _ = _origin(coords[..., 1])
    order = _sort_order(coords, h2, w2)
    slab = np.full((n, p, ROWS, w2), np.nan, np.float32)
    writes = np.zeros((n, p, ROWS, w2), np.int64)
    sup = np.zeros((n, p, ROWS, ROWS), np.float32)
    warps = []
    for e in range(n):
        for p0 in range(0, p, tp):
            pos = np.arange(p0, p0 + tp)
            valid = pos < p
            pixel = order[e, np.minimum(pos, p - 1)]  # the pixel at each tile position
            key = np.where(valid, y0[e, pixel], NO_ROW)
            # the band: the union of the in-map window rows of the tile
            hit = valid & (key + ROWS - 1 >= 0) & (key < h2)
            band = (max(key[hit].min(), 0), min(key[hit].max() + ROWS - 1, h2 - 1)) if hit.any() else (1, -1)
            # zeros once: the window rows off the map
            for i in np.nonzero(valid)[0]:
                rows = key[i] + np.arange(ROWS)
                off = (rows < 0) | (rows >= h2)
                slab[e, pixel[i], off] = 0.0
                writes[e, pixel[i], off] += 1
            for w in range(tp // 16):
                at = np.arange(16 * w, 16 * (w + 1))
                done, skipped = [], []
                for y in range(band[0], band[1] + 1):
                    need = (y >= key[at]) & (y < key[at] + ROWS)
                    if not need.any():
                        skipped.append(y)
                        continue
                    done.append(y)
                    # corr_level's columns: the 8-column blocks that hold the
                    # in-map columns of the needing pixels' windows
                    xs = x0[e, pixel[at[need]]]
                    lo, hi = max(xs.min(), 0), min(xs.max() + ROWS - 1, w2 - 1)
                    lvl_cols = np.arange(lo // 8 * 8, hi // 8 * 8 + 8) if lo <= hi else np.arange(0)
                    cols = np.arange(w2pad)
                    cols = cols[cols < w2]  # every column of the pass, stored where < W2
                    lvl_cols = lvl_cols[lvl_cols < w2]
                    for i in at[need]:
                        q = pixel[i]
                        r = y - key[i]
                        slab[e, q, r, cols] = vol[e, q, y, cols]
                        writes[e, q, r, cols] += 1
                        c = lvl_cols - x0[e, q]
                        ok = (c >= 0) & (c < ROWS)
                        sup[e, q, r, c[ok]] = vol[e, q, y, lvl_cols[ok]]
                needed = set()
                for i in at[valid[at]]:
                    needed |= {y for y in range(key[i], key[i] + ROWS) if 0 <= y < h2}
                warps.append((done, skipped, needed))
    return slab, writes, sup, warps


def _blend(sup, coords):
    """The four-term blend of the kernels, in its order: tap (i, j) from
    support row j (y), column i (x)."""
    _, dx = _origin(coords[..., 0])
    _, dy = _origin(coords[..., 1])
    dx, dy = dx[..., None, None], dy[..., None, None]
    v00, v10 = sup[..., :-1, :-1], sup[..., :-1, 1:]
    v01, v11 = sup[..., 1:, :-1], sup[..., 1:, 1:]
    one = np.float32(1.0)
    out = (v00 * (one - dx) * (one - dy) + v10 * dx * (one - dy) + v01 * (one - dx) * dy
           + v11 * dx * dy)  # [n, p, j, i]
    return np.swapaxes(out, -1, -2).reshape(*sup.shape[:2], TAPS)


def _coords(kind, n, h, w, rng):
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    grid = np.stack([gx, gy], -1)[None].repeat(n, 0)
    if kind == "smooth":
        c = grid * 1.02 + np.array([2.5, -1.5], np.float32) + 0.5 * rng.standard_normal(grid.shape)
    else:
        c = grid + 3.0 * rng.standard_normal(grid.shape)
    if kind == "far":  # ±1e5 for a fifth of the pixels, windows half off each border
        far = rng.random((n, h, w)) < 0.2
        c[far] = 1e5 * np.sign(rng.standard_normal((int(far.sum()), 2)))
        c[:, 0, :, 1] = -1.0
        c[:, -1, :, 1] = h - 1.0
        c[:, :, 0, 0] = -1.0
        c[:, :, -1, 0] = w - 1.0
    return c.astype(np.float32).reshape(n, h * w, 2)


CASES = [(h, w, c, kind, tp) for h, w in [(12, 16), (9, 13)] for c in (32, 128)
         for kind in ("iid", "smooth", "far") for tp in (16, 64)]


@pytest.mark.parametrize("h,w,c,kind,tp", CASES)
def test_f32_partition_writes_each_entry_once_and_matches_the_plain_versions(h, w, c, kind, tp):
    rng = np.random.default_rng(h * 100 + c + len(kind) + tp)
    n = 2
    f1 = (rng.standard_normal((n, h * w, c)) * 0.25).astype(np.float32)
    f2 = (rng.standard_normal((n, h, w, c)) * 0.25).astype(np.float32)
    coords = _coords(kind, n, h, w, rng)
    assert corr.corr_tile_plan_f32("corr_slab", n, h * w, w, c).tp == 16  # small grid: the small tile
    slab, writes, sup, warps = _emulate(f1, f2, coords, tp)

    # every entry of every pixel's 8 rows written exactly once; off-map rows 0
    assert (writes == 1).all()
    y0, _ = _origin(coords[..., 1])
    rows = y0[..., None] + np.arange(ROWS)
    off = (rows < 0) | (rows >= h)
    assert (slab[off] == 0).all()

    # a warp skips exactly the band rows that none of its pixels needs
    for done, skipped, needed in warps:
        assert set(done) == needed
        assert not set(skipped) & needed

    t = [torch.from_numpy(a) for a in (f1, f2, coords)]
    ref = corr.corr_slab_ref(*t).numpy()
    scale = np.abs(ref).max()
    assert np.abs(slab - ref).max() <= 1e-5 * scale
    ref = corr.corr_level_ref(*t).numpy()
    assert np.abs(_blend(sup, coords) - ref).max() <= 1e-5 * np.abs(ref).max()


def test_f32_result_does_not_depend_on_the_tile():
    """Each output is one chain over ascending channels, so every tile size
    gives the same bits."""
    rng = np.random.default_rng(3)
    f1 = rng.standard_normal((1, 117, 32)).astype(np.float32)
    f2 = rng.standard_normal((1, 9, 13, 32)).astype(np.float32)
    coords = _coords("iid", 1, 9, 13, rng)
    outs = [_emulate(f1, f2, coords, tp) for tp in (16, 32, 64)]
    for slab, _, sup, _ in outs[1:]:
        assert np.array_equal(slab, outs[0][0]) and np.array_equal(sup, outs[0][2])


# -----------------------------------------------------------------------------
# (c) chip_smoke.py's band-row count
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["iid", "smooth", "far"])
@pytest.mark.parametrize("tp", [16, 64])
def test_chip_smoke_band_row_count_matches_the_emulation(kind, tp):
    """chip_smoke.f32_band_rows counts in pixel-rows: 16 per band row a warp
    multiplies, against the in-map window rows of every pixel."""
    import chip_smoke

    rng = np.random.default_rng(tp + len(kind))
    n, h, w = 2, 9, 13
    coords = _coords(kind, n, h, w, rng)
    f1 = np.zeros((n, h * w, 4), np.float32)
    f2 = np.zeros((n, h, w, 4), np.float32)
    _, _, _, warps = _emulate(f1, f2, coords, tp)
    computed, needed = chip_smoke.f32_band_rows(torch, torch.from_numpy(coords), h, w, tp)
    assert computed == 16 * sum(len(done) for done, _, _ in warps)
    y0, _ = _origin(coords[..., 1])
    rows = y0[..., None] + np.arange(ROWS)
    assert needed == int(((rows >= 0) & (rows < h)).sum())
    assert needed <= computed
