"""Stage B of the split correlation lookup (``corr_window``) on the CPU.

(a) The plain version, ``ops/corr.py::corr_window_ref``, against the TPU
kernel it stands for, ``pallas_corr.py::_corr_window_kernel``, launched
alone through ``pl.pallas_call`` in interpret mode as
``corr_level_pallas_split`` launches it.

(b) A numpy emulation of the CUDA kernel's mapping
(``csrc/corr_split.cu::corr_window_warp_kernel``): which lane reads which
slab row and column, how the blend finds its four neighbours, and where
each pixel's taps land in ``out``. It must reproduce the plain version.
The kernel itself runs only on a CUDA device, where ``chip_smoke.py`` holds
it against the plain version.

Neither path sums anything (the Pallas kernel's one-hot selection adds
exact zeros), so both comparisons are held to 1e-6·max|ref|, a few ulps.

(c) What ``chip_smoke.py`` reads beside the kernel on the card: its
library yardstick, one ``F.grid_sample`` call, computes the same function,
and its count of the 32- and 64-byte sectors the kernel must read agrees
with a count by hand.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from droid_slam_tpu.ops import pallas_corr as jpallas
from droid_slam_tpu_torch.ops import corr

torch.set_num_threads(2)

R = 3
ROWS = 2 * R + 2  # rows and columns of a window's integer support
TAPS = (2 * R + 1) ** 2
TOL = 1e-6  # relative to max |ref|
H = 8  # map rows: only the fraction dy of the y coordinate reaches stage B


def _inputs(seed, n, p, w2, kind):
    """A seeded f32 slab [n, p, 8, w2] and coords [n, p, 2] of one kind:
    iid: windows anywhere from 3 columns off the left edge to 3 off the
      right one;
    edges: every window half off the map, to the left, right, top or bottom;
    far: iid, then a fifth of the pixels at x = ±1e5 and a fifth at
      y = ±1e5, whose slab rows are zero, as stage A writes rows off the map.
    """
    rng = np.random.default_rng(seed)
    slab = rng.standard_normal((n, p, ROWS, w2)).astype(np.float32)
    x = rng.random((n, p)) * (w2 + 6) - 3
    y = rng.random((n, p)) * (H + 6) - 3
    frac = rng.random((n, p))
    if kind == "edges":
        side = rng.integers(0, 4, (n, p))
        # x0 = -4 or W2 - 4 (4 of the 8 columns off the map), y0 likewise
        x = np.where(side == 0, -1 + frac, np.where(side == 1, w2 - 1 + frac, x))
        y = np.where(side == 2, -1 + frac, np.where(side == 3, H - 1 + frac, y))
    coords = np.stack([x, y], -1).astype(np.float32)
    if kind == "far":
        pick = rng.random((n, p))
        sign = np.where(rng.random((n, p)) < 0.5, -1e5, 1e5).astype(np.float32)
        coords[..., 0] = np.where(pick < 0.2, sign, coords[..., 0])
        far_y = pick > 0.8
        coords[..., 1] = np.where(far_y, sign, coords[..., 1])
        slab[far_y] = 0.0
    return slab, coords


def _ref(slab, coords):
    return corr.corr_window_ref(torch.from_numpy(slab), torch.from_numpy(coords), R).numpy()


def _assert_close(got, want):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL * scale
    np.testing.assert_array_equal(got == 0, want == 0)


# -----------------------------------------------------------------------------
# (a) the plain version against the Pallas kernel
# -----------------------------------------------------------------------------


def _pallas_window(slab, coords, tile=128):
    """``_corr_window_kernel`` on corr_window_ref's inputs, launched as
    ``corr_level_pallas_split`` launches it (pallas_corr.py:295-310), in
    interpret mode: the slab in the TPU layout [N, 8, Wp, P_pad], PAD zero
    columns on the left and Wp = 8·⌈W2/8⌉ + 16; out [N, 49, P_pad] back
    to [N, P, 49]."""
    n, p, rows, w2 = slab.shape
    wp = 8 * -(-w2 // 8) + 16
    p_pad = -(-p // tile) * tile
    tpu = np.zeros((n, rows, wp, p_pad), np.float32)
    tpu[:, :, jpallas.PAD : jpallas.PAD + w2, :p] = slab.transpose(0, 2, 3, 1)
    cpad = np.zeros((n, p_pad, 2), np.float32)
    cpad[:, :p] = coords
    out = pl.pallas_call(
        functools.partial(jpallas._corr_window_kernel, w2=w2, radius=R),
        grid=(n, p_pad // tile),
        in_specs=[
            pl.BlockSpec((1, rows, wp, tile), lambda i, j: (i, 0, 0, j), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, tile, 2), lambda i, j: (i, j, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, TAPS, tile), lambda i, j: (i, 0, j), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, TAPS, p_pad), jnp.float32),
        interpret=True,
    )(jnp.asarray(tpu), jnp.asarray(cpad))
    return np.asarray(out)[:, :, :p].transpose(0, 2, 1)


@pytest.mark.parametrize("kind", ["iid", "edges", "far"])
@pytest.mark.parametrize("w2", [1, 5, 8, 40])
def test_corr_window_ref_matches_pallas_window_kernel(w2, kind):
    """The Pallas kernel clips coords to ±1000 before the floor, the port to
    ±1e4; a window that far out is all zero in both (off the map in x, or
    zero slab rows in y), so the clip does not show."""
    slab, coords = _inputs(40 + w2, 2, 150, w2, kind)
    _assert_close(_ref(slab, coords), _pallas_window(slab, coords))


# -----------------------------------------------------------------------------
# (b) the CUDA kernel's mapping, emulated in numpy
# -----------------------------------------------------------------------------


def _emulate_window_kernel(slab, coords):
    """corr_window_warp_kernel, lane by lane: a block of
    WINDOW_BLOCK_PIXELS pixels, 8 lanes per pixel (one per support column),
    pixels indexed over N·P flat. Returns out [N, P, 49] and how many times
    each element of out was written and each slab element read."""
    n, p, rows, w2 = slab.shape
    warp_pix = 32 // ROWS
    warps = corr.WINDOW_BLOCK_PIXELS // warp_pix
    n_pix = n * p
    flat_slab = slab.reshape(-1)
    flat_coords = coords.reshape(-1)
    out = np.full(n_pix * TAPS, np.nan, np.float32)
    writes = np.zeros(n_pix * TAPS, np.int64)
    reads = np.zeros(flat_slab.size, np.int64)
    one = np.float32(1)
    lane = np.arange(32)
    q, c = lane // ROWS, lane % ROWS  # the lane's pixel in the warp, its support column
    for block in range(-(-n_pix // corr.WINDOW_BLOCK_PIXELS)):
        for warp in range(warps):
            p0 = (block * warps + warp) * warp_pix
            if p0 >= n_pix:
                continue
            nv = min(warp_pix, n_pix - p0)
            # lane k < 2·nv loads coordinate k of the warp's pixels and takes
            # its origin and fraction once
            o = np.zeros(32, np.int64)
            frac = np.zeros(32, np.float32)
            k = lane < 2 * nv
            v = flat_coords[2 * p0 + lane[k]]
            of = np.floor(np.clip(v - np.float32(R), -1e4, 1e4).astype(np.float32))
            o[k] = of.astype(np.int64)
            frac[k] = (v - np.float32(R)) - of
            # shuffles from lanes 2q and 2q + 1
            x0, dx, dy = o[2 * q], frac[2 * q], frac[2 * q + 1]
            # lane (q, c) reads column x0 + c of the pixel's 8 rows
            x = x0 + c
            ok = (q < nv) & (x >= 0) & (x < w2)
            idx = ((p0 + q)[:, None] * rows + np.arange(rows)) * w2 + x[:, None]
            a = np.zeros((32, rows), np.float32)
            a[ok] = flat_slab[idx[ok]]
            np.add.at(reads, idx[ok].reshape(-1), 1)
            # shfl_down by 1: column x0 + c + 1 from lane c + 1 (lane 31 keeps its own)
            b = np.concatenate([a[1:], a[31:]])
            stage = np.full(warp_pix * TAPS, np.nan, np.float32)
            for l in np.flatnonzero(c < 2 * R + 1):
                for j in range(2 * R + 1):
                    stage[q[l] * TAPS + c[l] * (2 * R + 1) + j] = (
                        a[l, j] * (one - dx[l]) * (one - dy[l])
                        + b[l, j] * dx[l] * (one - dy[l])
                        + a[l, j + 1] * (one - dx[l]) * dy[l]
                        + b[l, j + 1] * dx[l] * dy[l]
                    )
            base = p0 * TAPS
            if nv == warp_pix:  # 16-byte stores of the warp's whole run
                assert base % 4 == 0
                for s in range(warp_pix * TAPS // 4):
                    out[base + 4 * s : base + 4 * s + 4] = stage[4 * s : 4 * s + 4]
                    writes[base + 4 * s : base + 4 * s + 4] += 1
            else:  # the ragged last warp: its whole pixels, element by element
                out[base : base + nv * TAPS] = stage[: nv * TAPS]
                writes[base : base + nv * TAPS] += 1
    return out.reshape(n, p, TAPS), writes, reads


@pytest.mark.parametrize("kind", ["iid", "edges", "far"])
@pytest.mark.parametrize("w2", [1, 5, 8, 40])
def test_window_kernel_mapping_reproduces_the_plain_version(w2, kind):
    """N·P = 111 pixels: not a multiple of the block's 32 pixels nor of the
    warp's 4, so the last block has idle warps and a ragged last warp."""
    n, p = 3, 37
    assert (n * p) % corr.WINDOW_BLOCK_PIXELS and (n * p) % (32 // ROWS)
    slab, coords = _inputs(60 + w2, n, p, w2, kind)
    got, writes, reads = _emulate_window_kernel(slab, coords)
    want = _ref(slab, coords)
    _assert_close(got, want)
    assert (writes == 1).all()  # every tap written once, nothing past N·P
    assert reads.max() <= 1  # each support value read once


# -----------------------------------------------------------------------------
# (c) chip_smoke.py's yardstick and sector count for the kernel
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["iid", "edges", "far"])
@pytest.mark.parametrize("w2", [1, 5, 10, 40])
def test_grid_sample_yardstick_computes_corr_window(w2, kind):
    """The one F.grid_sample call that chip_smoke.py times beside the kernel
    computes the plain version's function: within 1e-5·max|ref| (its grid
    is normalised and unnormalised in f32, which moves a sample by a few
    ulps of its coordinate)."""
    import chip_smoke

    slab, coords = _inputs(80 + w2, 2, 37, w2, kind)
    inp, grid = chip_smoke.grid_sample_inputs(torch, torch.from_numpy(slab), torch.from_numpy(coords))
    assert inp.shape == (2 * 37, 1, ROWS, w2) and grid.shape == (2 * 37, 7, 7, 2)
    got = chip_smoke.grid_sample(torch, inp, grid).reshape(2, 37, TAPS).numpy()
    want = _ref(slab, coords)
    assert np.abs(got - want).max() <= 1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("sector", [32, 64])
@pytest.mark.parametrize("kind", ["iid", "edges", "far"])
@pytest.mark.parametrize("w2", [1, 5, 10, 40])
def test_window_sector_bytes_counts_each_touched_sector_once(w2, kind, sector):
    import chip_smoke

    n, p = 2, 37
    _, coords = _inputs(100 + w2, n, p, w2, kind)
    sectors = set()
    x0 = np.floor(np.clip(coords[..., 0] - R, -1e4, 1e4)).astype(np.int64).reshape(-1)
    for pix, x in enumerate(x0):
        for r in range(ROWS):
            for col in range(max(x, 0), min(x + ROWS, w2)):
                sectors.add((((pix * ROWS + r) * w2 + col) * 4) // sector)
    want = sector * len(sectors) + coords.size * 4 + n * p * TAPS * 4
    assert chip_smoke.window_sector_bytes(torch, torch.from_numpy(coords), w2, sector=sector) == want


def test_launch_records_pairs_device_kernels_with_host_launches():
    """chip_smoke.py's check that a profile kept every kernel record: one
    device record per cudaLaunchKernel-like call of the host, memsets and
    copies on neither side."""
    import chip_smoke

    events = [("corr_level_f32_kernel", True, 4), ("cudaLaunchKernel", False, 3), ("cudaLaunchKernelExC", False, 1),
              ("Memset (Device)", True, 2), ("cudaMemsetAsync", False, 2), ("Memcpy DtoD (Device -> Device)", True, 1),
              ("cudaMemcpyAsync", False, 1), ("aten::sum", False, 4), ("cuLaunchKernel", False, 1)]
    assert chip_smoke.launch_records(events) == (4, 5)
    assert chip_smoke.launch_records(events[:3]) == (4, 4)
