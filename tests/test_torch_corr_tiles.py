"""The tile plan and the window band of the bf16 correlation kernels
(``csrc/corr_tile.cuh``), and the order-fixed segment sums of the BA and
GraphAgg, on the CPU.

The kernels themselves run only on a CUDA device (``chip_smoke.py`` holds
them against their plain versions there); what surrounds them is Python
that these tests reach: the shared-memory plan each launch passes in. The
band of rows each block multiplies is emulated here in numpy, which holds
the reduction's rule (every in-map window row lies in its tile's band);
the kernel's own band is held on the card by chip_smoke's smooth, iid and
far-out cases.
"""

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.models.update import GraphAgg
from droid_slam_tpu_torch.ops import ba, corr
from droid_slam_tpu_torch.ops.segment import segment_sum

torch.set_num_threads(2)

# (H2, W2) of the 4 pyramid levels at 240×320 and 384×512 (1/8 resolution)
LEVELS = [(30 >> l, 40 >> l) for l in range(4)] + [(48 >> l, 64 >> l) for l in range(4)]


@pytest.mark.parametrize("kernel", ["corr_level", "corr_slab"])
@pytest.mark.parametrize("h2,w2", LEVELS)
def test_tile_plan_fits_and_pads_to_the_n8_tile(kernel, h2, w2):
    n, p, c = 48, 1200, 128
    plan = corr.corr_tile_plan(kernel, n, p, w2, c)
    assert plan.w2pad % 8 == 0 and w2 <= plan.w2pad < w2 + 8
    assert plan.row_stride == 2 * c + 16
    assert plan.n_tiles in (1, 2, 4, 8) and 8 * plan.n_tiles >= min(plan.w2pad, 64) > 4 * plan.n_tiles
    assert plan.tp == corr.TILE_PIXELS == 64
    assert plan.grid == (-(-p // 64), n)
    static, extra = corr._TILE_SMEM[kernel]
    assert plan.smem_bytes == corr.STAGES * plan.w2pad * plan.row_stride + extra
    assert static + plan.smem_bytes <= corr.SMEM_LIMIT == 227 * 1024


@pytest.mark.parametrize("kernel", ["corr_level", "corr_slab"])
def test_tile_plan_over_227kb_raises(kernel):
    # C=256: 528-byte staged columns; 152 of them in three buffers take 235 KB
    corr.corr_tile_plan(kernel, 1, 64, 120, 256)
    with pytest.raises(ValueError, match="227 KB"):
        corr.corr_tile_plan(kernel, 1, 64, 152, 256)


@pytest.mark.parametrize("wrapper", ["corr_level", "corr_slab"])
def test_wrappers_raise_on_a_plan_that_does_not_fit(wrapper, monkeypatch):
    """A non-CPU tensor whose plan needs more than 227 KB raises before any
    launch (meta tensors stand in for CUDA ones; the device check is
    bypassed, the plan and launch count are real)."""
    from droid_slam_tpu_torch.ops import kernels

    monkeypatch.setattr(corr, "_check_cuda", lambda name, *t: None)
    kernels.reset_launches()
    f1 = torch.empty((1, 64, 256), dtype=torch.bfloat16, device="meta")
    f2 = torch.empty((1, 4, 152, 256), dtype=torch.bfloat16, device="meta")
    coords = torch.empty((1, 64, 2), dtype=torch.float32, device="meta")
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    with pytest.raises(ValueError, match="227 KB"):
        getattr(corr, wrapper)(f1, f2, coords)
    assert kernels.LAUNCHES[wrapper] == 0


def _band_numpy(y, h2, tp=64, radius=3):
    """The kernels' band reduction (``corr_tile.cuh::tile_band``) in numpy:
    per tile of tp pixels, [lo, hi] of the union of the window rows
    [y0, y0 + 2r + 2), clamped to [0, H2), of the pixels whose window
    touches the map; (1, -1) when none does. Pixels past P add nothing."""
    n, p = y.shape
    y0 = np.floor(np.clip(y - radius, -1e4, 1e4)).astype(np.int64)
    bands = np.zeros((n, -(-p // tp), 2), np.int64)
    for e in range(n):
        for t in range(bands.shape[1]):
            w = y0[e, t * tp:(t + 1) * tp]  # the ragged last tile holds fewer
            hit = (w + 2 * radius + 1 >= 0) & (w < h2)
            if hit.any():
                bands[e, t] = (max(w[hit].min(), 0), min(w[hit].max() + 2 * radius + 1, h2 - 1))
            else:
                bands[e, t] = (1, -1)
    return bands


def _coords(kind, n, h, w, rng):
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    grid = np.stack([gx, gy], -1)[None].repeat(n, 0)
    if kind == "smooth":  # a global shift, a small affine warp, σ 0.5 noise
        c = grid * 1.02 + np.array([2.5, -1.5], np.float32) + 0.5 * rng.standard_normal(grid.shape)
    elif kind == "iid":
        c = grid + 3.0 * rng.standard_normal(grid.shape)
    else:  # far out: ±1e5 for a fifth of the pixels, windows half off each border
        c = grid + 3.0 * rng.standard_normal(grid.shape)
        far = rng.random((n, h, w)) < 0.2
        c[far] = 1e5 * np.sign(rng.standard_normal((int(far.sum()), 2)))
        c[:, 0, :, 1] = -4.0
        c[:, -1, :, 1] = h + 3.0
    return c.astype(np.float32).reshape(n, h * w, 2)


@pytest.mark.parametrize("kind", ["smooth", "iid", "far"])
@pytest.mark.parametrize("h,w,level", [(30, 40, 0), (30, 40, 1), (30, 40, 3), (48, 64, 0), (48, 64, 2)])
def test_band_covers_every_in_map_window_row(kind, h, w, level):
    rng = np.random.default_rng(level + 10 * h)
    c = _coords(kind, 3, h, w, rng) / 2.0**level
    h2 = h >> level
    bands = _band_numpy(c[..., 1], h2)
    # every in-map row of every pixel's window lies inside its tile's band
    y0 = np.floor(np.clip(c[..., 1] - 3, -1e4, 1e4)).astype(np.int64)
    rows = y0[..., None] + np.arange(8)
    tile = np.arange(c.shape[1]) // 64
    lo = bands[:, tile, 0][..., None]
    hi = bands[:, tile, 1][..., None]
    in_map = (rows >= 0) & (rows < h2)
    assert ((rows >= lo) & (rows <= hi))[in_map].all()
    if kind == "smooth" and level == 0:  # tracking's locality: a narrow band
        assert (bands[..., 1] - bands[..., 0] + 1).max() <= 14


def test_band_of_far_out_and_past_p_pixels_is_empty():
    c = np.full((1, 100, 2), 1e5, np.float32)
    c[0, 70, :] = (5.0, 6.0)  # one pixel in the map, in the ragged last tile
    bands = _band_numpy(c[..., 1], 30)
    assert bands[0, 0, 0] > bands[0, 0, 1]  # empty: writes only zeros
    assert tuple(bands[0, 1]) == (3, 10)


# -----------------------------------------------------------------------------
# order-fixed segment sums: on the CPU exactly the index_add_ the BA and
# GraphAgg used before, which adds each segment's rows in edge order
# -----------------------------------------------------------------------------

# the tracking replay's shapes (64×64 images: 8×8 features, 24 edges, pose
# window 16, depth window 24) and a backend chunk's GraphAgg
SEGMENT_SHAPES = {
    "pose_blocks": (16 * 16, (6, 6), 24),
    "pose_rhs": (16, (6,), 24),
    "depth_rows": (24, (64,), 24),
    "dense_E": (24 * 16, (6, 64), 48),
    "graph_agg": (24, (128 * 64,), 24),
    "graph_agg_backend": (48, (128 * 64,), 256),
}


def _edge_order_numpy(idx, src, n_seg):
    """Per segment, a float32 accumulator from 0, adding the rows with that
    id one at a time in increasing k."""
    out = np.zeros((n_seg,) + src.shape[1:], np.float32)
    for s in range(n_seg):
        for k in np.nonzero(idx == s)[0]:
            out[s] = (out[s] + src[k]).astype(np.float32)
    return out


@pytest.mark.parametrize("shape", sorted(SEGMENT_SHAPES))
def test_segment_sum_is_bitwise_index_add_on_cpu(shape):
    n_seg, row, k = SEGMENT_SHAPES[shape]
    rng = np.random.default_rng(len(shape))
    idx = rng.integers(-1, n_seg + 1, k)  # ids outside [0, n_seg) are dropped
    idx[: k // 2] = idx[0] if 0 <= idx[0] < n_seg else 0  # many rows into one segment
    src = (rng.standard_normal((k,) + row) * 10.0 ** rng.integers(-3, 3, (k,) + row)).astype(np.float32)
    ti, ts = torch.from_numpy(idx), torch.from_numpy(src)
    # the formulation before the repair: index_add_ into zeros with a dump row
    want = torch.zeros((n_seg + 1,) + row).index_add_(0, torch.where((ti >= 0) & (ti < n_seg), ti, n_seg), ts)
    got = segment_sum(ti, ts, n_seg)
    assert torch.equal(got, want[:n_seg])
    assert np.array_equal(got.numpy(), _edge_order_numpy(idx, src, n_seg))


def test_scatter_rows_and_graph_agg_are_unchanged_on_cpu():
    rng = np.random.default_rng(5)
    blocks = torch.from_numpy(rng.standard_normal((24, 6, 6)).astype(np.float32))
    ii = torch.from_numpy(rng.integers(-2, 18, 24))
    jj = torch.from_numpy(rng.integers(-2, 18, 24))
    ok = (ii >= 0) & (jj >= 0) & (ii < 16) & (jj < 16)
    want = torch.zeros(16 * 16 + 1, 6, 6).index_add_(0, torch.where(ok, ii * 16 + jj, 256), blocks)[:256]
    assert torch.equal(ba._scatter_mat(blocks, ii, jj, 16, 16), want.reshape(16, 16, 6, 6))

    torch.manual_seed(0)
    agg = GraphAgg().eval()
    net = torch.from_numpy(rng.standard_normal((24, 128, 8, 8)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, 24, 24))
    valid = torch.from_numpy(rng.random(24) > 0.2)
    with torch.no_grad():
        eta, upmask = agg(net, src, 24, valid)
        # the scatter-mean written with index_add_, as before the repair
        h = torch.relu(agg.conv1(net))
        seg = torch.where(valid, src, 24)
        sums = torch.zeros(25, 128 * 64).index_add_(0, seg, h.reshape(24, -1))
        cnt = torch.zeros(25).index_add_(0, seg, torch.ones(24))
        mean = (sums[:24] / cnt[:24].clamp(min=1.0)[:, None]).reshape(24, 128, 8, 8)
        h = torch.relu(agg.conv2(mean))
        want_eta = 0.01 * torch.nn.functional.softplus(agg.eta(h))[:, 0]
        want_up = agg.upmask(h).permute(0, 2, 3, 1)
    assert torch.equal(eta, want_eta)
    assert torch.equal(upmask, want_up)
