"""Correlation volumes and pyramid lookups (PyTorch + CUDA).

Counterpart of the JAX package's ``ops/corr.py``: per edge, the correlation
of the source features with the target features pooled to 4 levels, sampled
in a (2r+1)² bilinear window around each source pixel's target coordinates.
Channel order of the result is (level, i, j) with i the x-offset; taps
outside the map are 0.

Two formulations of the JAX package's three (its volume mode, the
all-pairs volume pooled over the target dims, computes the fused lookup's
function, ``droid_slam_tpu/ops/corr.py:186-201``; the port uses the fused
lookup where the JAX package uses the volume, in training too):

* fused lookup (:func:`corr_lookup` → :func:`corr_level`): both tracking
  engines, the motion probe and the trajectory filler. On a CUDA tensor
  :func:`corr_level` launches ``csrc/corr_level.cu``.
  :class:`CorrPyramid` → :class:`CorrLevel` is its differentiable form, for
  the training unroll: forward :func:`corr_level`, backward
  :func:`corr_level_backward`, which launches ``csrc/corr_backward.cu`` on
  a CUDA tensor.
* split lookup (:class:`AltCorr` → :func:`corr_level_split`): the global
  backend. Stage A (:func:`corr_slab`, ``csrc/corr_split.cu``) writes the
  8 volume rows of each pixel's window support across the full width;
  stage B (:func:`corr_window`) takes the 8 columns of the window from that
  slab and blends the bilinear taps.

Each kernel wrapper runs its plain version (``*_ref``) on a CPU tensor and
launches its kernel on a CUDA tensor; there is no fallback between the two.
For bf16 features ``corr_level`` and ``corr_slab`` run tensor-core tiles of
64 source pixels against the f2 rows of the tile's window band, staged in
shared memory (``csrc/corr_tile.cuh``); :func:`corr_tile_plan` lays the
tile out. For f32 features they run the same band tiles with the dots in
f32 FMA on the CUDA cores (``csrc/corr_tile_f32.cuh``), laid out by
:func:`corr_tile_plan_f32`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from . import kernels

Tensor = torch.Tensor


def avg_pool2x2(x: Tensor) -> Tensor:
    """2×2 average pool over the two trailing dims (odd trailing rows/cols
    are dropped, torch's floor mode)."""
    *lead, h, w = x.shape
    h2, w2 = h // 2, w // 2
    x = x[..., : 2 * h2, : 2 * w2].reshape(*lead, h2, 2, w2, 2)
    return x.mean(dim=(-3, -1))


def _window_origin(c: Tensor, radius: int):
    """(floor, fraction) of a window's first tap along one axis: the floor
    of the coordinate clipped to ±1e4, so far-out coords give exact zeros
    and the int cast stays defined. The CUDA kernels use the same float
    expression."""
    c0 = c - radius
    c0f = torch.floor(c0.clamp(-1e4, 1e4))
    return c0f.long(), c0 - c0f


def _blend(patch: Tensor, dx: Tensor, dy: Tensor, radius: int) -> Tensor:
    """Bilinear taps from the (2r+2)² integer support patch [..., j(y), i(x)]
    → [..., (2r+1)²] in (i, j) order."""
    rd = 2 * radius + 1
    dx = dx[..., None, None]
    dy = dy[..., None, None]
    v00 = patch[..., :rd, :rd]
    v01 = patch[..., 1:, :rd]
    v10 = patch[..., :rd, 1:]
    v11 = patch[..., 1:, 1:]
    out = (
        v00 * (1 - dx) * (1 - dy)
        + v10 * dx * (1 - dy)
        + v01 * (1 - dx) * dy
        + v11 * dx * dy
    )
    return out.transpose(-1, -2).reshape(*out.shape[:-2], rd * rd)


def _window_sample(vol: Tensor, coords: Tensor, radius: int) -> Tensor:
    """Bilinear (2r+1)² window of per-pixel maps: vol [M, H2, W2] f32,
    coords [M, 2] (x, y) → [M, (2r+1)²], taps outside the map 0 (all of
    them for an empty map, such as the coarsest level of a small image)."""
    m, h2, w2 = vol.shape
    if h2 * w2 == 0:
        return vol.new_zeros((m, (2 * radius + 1) ** 2))
    sup = 2 * radius + 2
    x0, dx = _window_origin(coords[..., 0], radius)
    y0, dy = _window_origin(coords[..., 1], radius)
    off = torch.arange(sup, device=vol.device)
    ys = y0[..., None] + off  # [M, sup]
    xs = x0[..., None] + off
    ok = ((ys >= 0) & (ys < h2))[..., :, None] & ((xs >= 0) & (xs < w2))[..., None, :]
    idx = ys.clamp(0, h2 - 1)[..., :, None] * w2 + xs.clamp(0, w2 - 1)[..., None, :]
    patch = torch.gather(vol.reshape(m, h2 * w2), 1, idx.reshape(m, sup * sup))
    patch = torch.where(ok, patch.reshape(m, sup, sup), torch.zeros((), device=vol.device))
    return _blend(patch, dx, dy, radius)


# -----------------------------------------------------------------------------
# fused lookup (tracking)
# -----------------------------------------------------------------------------


def _sum_dtype(t: Tensor) -> torch.dtype:
    """f32 for bf16 and f32 features; float64 stays (the gradient checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def corr_level_ref(f1: Tensor, f2: Tensor, coords: Tensor, radius: int = 3) -> Tensor:
    """Plain version of one level: per-edge correlation volume (a batched
    f32 matmul) followed by a gather of the (2r+2)² integer support and the
    bilinear blend.

    f1 [N, P, C] source features (pre-scaled), f2 [N, H2, W2, C] target
    features (pre-scaled), coords [N, P, 2] f32 (x, y) at this level's
    resolution → [N, P, (2r+1)²] f32.
    """
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    dt = _sum_dtype(f1)
    vol = torch.bmm(f1.to(dt), f2.to(dt).reshape(n, h2 * w2, c).transpose(1, 2))
    out = _window_sample(vol.reshape(n * p, h2, w2), coords.reshape(n * p, 2), radius)
    return out.reshape(n, p, -1)


# -----------------------------------------------------------------------------
# the tile plan of the bf16 kernels (csrc/corr_tile.cuh)
# -----------------------------------------------------------------------------

TILE_PIXELS = 64  # source pixels per block: 4 warps of 16 (one m16 tile each)
ROW_PAD_BYTES = 16  # per staged f2 row: the 8 rows of a B fragment load on distinct banks
STAGES = 3  # f2 row buffers: two rows in flight while one is multiplied
SMEM_LIMIT = 232448  # shared memory one block may use on Hopper (227 KB)
_RED = 2 * TILE_PIXELS // 32 * 4  # the band reduction's scratch
# per kernel: (static shared bytes, dynamic bytes beside the f2 row
# buffers): corr_level keeps the tile's 8×8 f32 supports and its pixels'
# origins and fractions; corr_slab writes straight from the accumulators
_TILE_SMEM = {
    "corr_level": (4 * TILE_PIXELS * 4 + _RED, TILE_PIXELS * 64 * 4),
    "corr_slab": (TILE_PIXELS * 4 + _RED, 0),
}


class TilePlan(NamedTuple):
    """Launch layout of a bf16 tile kernel, passed to its entry point, which
    checks it against the source's layout."""

    tp: int  # source pixels per block
    w2pad: int  # staged columns: W2 rounded up to the n8 tile
    row_stride: int  # bytes per staged f2 column: 2·C + 16
    n_tiles: int  # n8 tiles per accumulator chunk: w2pad/8 rounded up to 1, 2, 4 or 8
    smem_bytes: int  # dynamic shared memory of one block
    grid: Tuple[int, int]  # (pixel tiles, edges)


def corr_tile_plan(kernel: str, n: int, p: int, w2: int, c: int) -> TilePlan:
    """The tile plan of ``kernel`` ("corr_level" or "corr_slab") for N edges,
    P source pixels, a map W2 wide and C channels. Raises ValueError when a
    block would need more than the 227 KB of shared memory Hopper gives it."""
    static, extra = _TILE_SMEM[kernel]
    w2pad = -(-w2 // 8) * 8
    row_stride = 2 * c + ROW_PAD_BYTES
    smem = STAGES * w2pad * row_stride + extra
    if static + smem > SMEM_LIMIT:
        raise ValueError(
            f"{kernel}: a tile of a map {w2} wide at C={c} needs {static + smem} bytes of "
            f"shared memory, above the {SMEM_LIMIT} (227 KB) a block can use"
        )
    n_tiles = min(t for t in (1, 2, 4, 8) if 8 * t >= min(w2pad, 64))
    return TilePlan(TILE_PIXELS, w2pad, row_stride, n_tiles, smem, (-(-p // TILE_PIXELS), n))


# -----------------------------------------------------------------------------
# the tile plan of the float32 kernels (csrc/corr_tile_f32.cuh)
# -----------------------------------------------------------------------------

F32_TILE_PIXELS = (64, 32, 16)  # source pixels per block: 16 per warp (4 per thread)
F32_ROW_PAD_FLOATS = 4  # per staged f1/f2 row: C + 4 floats, an odd number of 16-byte units
SM_COUNT = 132  # streaming multiprocessors of the H100 SXM
# per kernel: static shared bytes (window origins, the tile's pixels, the
# band reduction's scratch; corr_level adds x0 and the fractions) and
# whether the tile's 8×8 f32 supports sit beside the row buffers
_F32_SMEM = {
    "corr_level": (5 * 64 * 4 + _RED, True),
    "corr_slab": (2 * 64 * 4 + _RED, False),
}


def corr_tile_plan_f32(kernel: str, n: int, p: int, w2: int, c: int) -> TilePlan:
    """The tile plan of the float32 ``kernel`` ("corr_level" or
    "corr_slab") for N edges, P source pixels, a map W2 wide and C channels:
    64 source pixels per block, or 32 or 16 when N·⌈P/tp⌉ blocks would leave
    SMs of the H100 without one (the motion probe runs one edge), and smaller
    still when the block's shared memory would not fit otherwise.
    ``n_tiles`` is the columns per thread of a row's first pass (a pass
    covers up to 64 columns). Raises ValueError when even 16 pixels need more
    than the 227 KB of shared memory Hopper gives a block: at C=128 a map
    wider than 136, at C=256 wider than 64 (no path of the repo)."""
    static, supports = _F32_SMEM[kernel]
    w2pad = -(-w2 // 8) * 8
    row_stride = 4 * (c + F32_ROW_PAD_FLOATS)
    busy = [tp for tp in F32_TILE_PIXELS if n * -(-p // tp) >= SM_COUNT]
    first = F32_TILE_PIXELS.index(busy[0]) if busy else len(F32_TILE_PIXELS) - 1
    for tp in F32_TILE_PIXELS[first:]:
        smem = (tp + STAGES * w2pad) * row_stride + (tp * 64 * 4 if supports else 0)
        if static + smem <= SMEM_LIMIT:
            return TilePlan(tp, w2pad, row_stride, min(8, w2pad // 8), smem, (-(-p // tp), n))
    raise ValueError(
        f"{kernel}: a float32 tile of a map {w2} wide at C={c} needs {static + smem} bytes of "
        f"shared memory even at 16 pixels, above the {SMEM_LIMIT} (227 KB) a block can use"
    )


def _check_cuda(name: str, *tensors: Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def _check_lookup(name: str, f1: Tensor, f2: Tensor, coords: Tensor, radius: int) -> None:
    """The argument checks of the lookup kernels (contract of
    :func:`corr_level_ref`)."""
    _check_cuda(name, f1, f2, coords)
    if f1.dtype not in (torch.bfloat16, torch.float32) or f2.dtype != f1.dtype:
        raise TypeError(f"{name}: f1/f2 must both be bf16 or f32, got {f1.dtype}/{f2.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"{name}: coords must be f32, got {coords.dtype}")
    if f1.dim() != 3 or f2.dim() != 4 or coords.dim() != 3:
        raise ValueError(f"{name}: expects f1 [N,P,C], f2 [N,H2,W2,C], coords [N,P,2]")
    n, p, c = f1.shape
    if f2.shape[0] != n or f2.shape[3] != c or tuple(coords.shape) != (n, p, 2):
        raise ValueError(
            f"{name}: shape mismatch f1 {tuple(f1.shape)}, f2 {tuple(f2.shape)}, "
            f"coords {tuple(coords.shape)}"
        )
    if c not in (32, 64, 128, 256) or radius != 3:
        raise ValueError(f"{name}: kernel takes C in (32, 64, 128, 256) and radius 3, got {c}, {radius}")
    if n > 65535:
        raise ValueError(f"{name}: at most 65535 edges per launch, got {n}")


def _plan_args(name: str, f1: Tensor, f2: Tensor) -> Tuple[int, int, int, int, int]:
    """The tile plan passed to a lookup kernel's entry point (bf16 or f32);
    raises on 16-byte misalignment of the feature maps (16-byte copies) or
    on a plan that does not fit."""
    if f1.data_ptr() % 16 or f2.data_ptr() % 16:
        raise ValueError(f"{name}: f1 and f2 must start on a 16-byte boundary (16-byte loads)")
    n, p, c = f1.shape
    plan_of = corr_tile_plan if f1.dtype == torch.bfloat16 else corr_tile_plan_f32
    plan = plan_of(name, n, p, f2.shape[2], c)
    return plan.tp, plan.w2pad, plan.row_stride, plan.n_tiles, plan.smem_bytes


def _dtype_tag(t: Tensor) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def _sort_scratch(f1: Tensor) -> Optional[Tensor]:
    """The int32 [N, P] scratch of the f32 kernels' per-edge sort (None for
    bf16, passed as a null pointer)."""
    if f1.dtype == torch.bfloat16:
        return None
    return torch.empty(f1.shape[:2], dtype=torch.int32, device=f1.device)


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def corr_level(f1: Tensor, f2: Tensor, coords: Tensor, radius: int = 3) -> Tensor:
    """One pyramid level of fused correlation + window lookup.

    Same contract as :func:`corr_level_ref`. A CUDA tensor goes to the
    kernel of ``csrc/corr_level.cu`` (bf16 or f32 features, f32 coords, all
    contiguous, feature maps 16-byte aligned, C ∈ {32, 64, 128, 256},
    radius 3, a tile plan within 227 KB); anything it does not take raises.
    A CPU tensor goes to the plain version.
    """
    if f1.device.type == "cpu":
        return corr_level_ref(f1, f2, coords, radius)
    _check_lookup("corr_level", f1, f2, coords, radius)
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    rd = 2 * radius + 1
    out = torch.empty((n, p, rd * rd), dtype=torch.float32, device=f1.device)
    if n == 0 or p == 0 or h2 == 0 or w2 == 0:
        return out.zero_()
    plan = _plan_args("corr_level", f1, f2)
    perm = _sort_scratch(f1)  # alive until the launch is queued
    kernels.launch(
        "corr_level", f1.device, f1.data_ptr(), f2.data_ptr(), coords.data_ptr(), _ptr(perm),
        out.data_ptr(), n, p, h2, w2, c, radius, int(f1.dtype == torch.bfloat16), *plan,
        dtype=_dtype_tag(f1),
    )
    return out


# -----------------------------------------------------------------------------
# split lookup (global backend)
# -----------------------------------------------------------------------------


def corr_slab_ref(f1: Tensor, f2: Tensor, coords: Tensor, radius: int = 3) -> Tensor:
    """Plain version of stage A: slab[n, p, r, x] = ⟨f1[n, p], f2[n, y0+r, x]⟩
    for the (2r+2) rows r of pixel p's window support, y0 = the window's
    first row; rows outside the map are 0.

    f1 [N, P, C], f2 [N, H2, W2, C], coords [N, P, 2] f32 →
    [N, P, 2r+2, W2] f32 (f32 arithmetic for bf16 inputs too).
    """
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    if h2 == 0:
        return torch.zeros((n, p, 2 * radius + 2, w2), device=f1.device)
    y0, _ = _window_origin(coords[..., 1], radius)
    ys = y0[..., None] + torch.arange(2 * radius + 2, device=f1.device)  # [N, P, R]
    vol = torch.bmm(f1.float(), f2.float().reshape(n, h2 * w2, c).transpose(1, 2))
    rows = torch.gather(
        vol.reshape(n, p, h2, w2), 2,
        ys.clamp(0, h2 - 1)[..., None].expand(n, p, ys.shape[-1], w2),
    )
    ok = ((ys >= 0) & (ys < h2))[..., None]
    return torch.where(ok, rows, torch.zeros((), device=f1.device))


def corr_window_ref(slab: Tensor, coords: Tensor, radius: int = 3) -> Tensor:
    """Plain version of stage B: the (2r+2) columns x0.. of the window from
    the slab (columns outside the map 0), blended to the bilinear taps.

    slab [N, P, 2r+2, W2] f32, coords [N, P, 2] f32 → [N, P, (2r+1)²] f32,
    taps in (i, j) order with i the x-offset.
    """
    n, p, rows, w2 = slab.shape
    if w2 == 0:
        return slab.new_zeros((n, p, (2 * radius + 1) ** 2))
    x0, dx = _window_origin(coords[..., 0], radius)
    _, dy = _window_origin(coords[..., 1], radius)
    xs = x0[..., None] + torch.arange(rows, device=slab.device)  # [N, P, R]
    patch = torch.gather(slab, 3, xs.clamp(0, w2 - 1)[..., None, :].expand(n, p, rows, rows))
    ok = ((xs >= 0) & (xs < w2))[..., None, :]
    patch = torch.where(ok, patch, torch.zeros((), device=slab.device))
    return _blend(patch, dx, dy, radius)


def corr_level_split_ref(f1: Tensor, f2: Tensor, coords: Tensor, radius: int = 3) -> Tensor:
    """The composition of the two stages' plain versions (contract of
    :func:`corr_level_ref`)."""
    return corr_window_ref(corr_slab_ref(f1, f2, coords, radius), coords, radius)


def corr_slab(f1: Tensor, f2: Tensor, coords: Tensor, radius: int = 3) -> Tensor:
    """Stage A: the contract of :func:`corr_slab_ref`. A CUDA tensor goes to
    the ``corr_slab`` kernel of ``csrc/corr_split.cu`` (the inputs
    :func:`corr_level` takes); a CPU tensor to the plain version."""
    if f1.device.type == "cpu":
        return corr_slab_ref(f1, f2, coords, radius)
    _check_lookup("corr_slab", f1, f2, coords, radius)
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    slab = torch.empty((n, p, 2 * radius + 2, w2), dtype=torch.float32, device=f1.device)
    if slab.numel() == 0:
        return slab
    if h2 == 0:
        return slab.zero_()
    plan = _plan_args("corr_slab", f1, f2)
    perm = _sort_scratch(f1)  # alive until the launch is queued
    kernels.launch(
        "corr_slab", f1.device, f1.data_ptr(), f2.data_ptr(), coords.data_ptr(), _ptr(perm),
        slab.data_ptr(), n, p, h2, w2, c, radius, int(f1.dtype == torch.bfloat16), *plan,
        dtype=_dtype_tag(f1),
    )
    return slab


# pixels per block of the corr_window kernel (csrc/corr_split.cu): 8 warps
# of 4 pixels, 8 lanes per pixel, one per support column. The entry point
# checks it against its own layout.
WINDOW_BLOCK_PIXELS = 32


def corr_window(slab: Tensor, coords: Tensor, radius: int = 3) -> Tensor:
    """Stage B: the contract of :func:`corr_window_ref`. A CUDA tensor goes
    to the ``corr_window`` kernel of ``csrc/corr_split.cu`` (f32 slab
    [N, P, 8, W2] and f32 coords, contiguous, radius 3); a CPU tensor to the
    plain version."""
    if slab.device.type == "cpu":
        return corr_window_ref(slab, coords, radius)
    _check_cuda("corr_window", slab, coords)
    if slab.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"corr_window: slab and coords must be f32, got {slab.dtype}/{coords.dtype}")
    if slab.dim() != 4 or radius != 3 or slab.shape[2] != 2 * radius + 2:
        raise ValueError(f"corr_window: expects slab [N,P,8,W2] and radius 3, "
                         f"got {tuple(slab.shape)}, {radius}")
    n, p, _, w2 = slab.shape
    if tuple(coords.shape) != (n, p, 2):
        raise ValueError(f"corr_window: coords {tuple(coords.shape)} do not match slab {tuple(slab.shape)}")
    rd = 2 * radius + 1
    out = torch.empty((n, p, rd * rd), dtype=torch.float32, device=slab.device)
    if out.numel() == 0:
        return out
    if w2 == 0:
        return out.zero_()
    kernels.launch("corr_window", slab.device, slab.data_ptr(), coords.data_ptr(), out.data_ptr(),
                   n, p, w2, radius, WINDOW_BLOCK_PIXELS)
    return out


def corr_level_split(f1: Tensor, f2: Tensor, coords: Tensor, radius: int = 3) -> Tensor:
    """One pyramid level through the split pair: :func:`corr_slab` then
    :func:`corr_window`, on the current stream. Contract and argument
    checks of :func:`corr_level`; the slab is f32 [N, P, 8, W2]."""
    return corr_window(corr_slab(f1, f2, coords, radius), coords, radius)


class AltCorr:
    """Feature-map pyramid for on-the-fly correlation (the backend's low
    memory mode): the fmaps scaled by 1/4 and average-pooled per level, so
    no O(N·HW²) volume is kept; each lookup runs :func:`corr_level_split`
    per level."""

    def __init__(self, pyramid: List[Tensor], radius: int):
        self.pyramid = pyramid  # level i: [F, H/2^i, W/2^i, C]
        self.radius = radius

    @staticmethod
    def build(fmaps: Tensor, num_levels: int = 4, radius: int = 3) -> "AltCorr":
        f = fmaps * 0.25
        pyr = [f]
        for _ in range(num_levels - 1):
            f = avg_pool2x2(f.movedim(-1, 1)).movedim(1, -1).contiguous()
            pyr.append(f)
        return AltCorr(pyr, radius)

    def __call__(self, coords: Tensor, ii: Tensor, jj: Tensor) -> Tensor:
        """coords [N, H, W, 2] level-0 targets of edges ii → jj →
        [N, H, W, L·(2r+1)²] f32."""
        n, h, w, _ = coords.shape
        c = self.pyramid[0].shape[-1]
        f1 = self.pyramid[0][ii].reshape(n, h * w, c)
        cflat = coords.float().reshape(n, h * w, 2)
        out = [
            corr_level_split(f1, lvl[jj], (cflat / (2.0**i)).contiguous(), self.radius)
            for i, lvl in enumerate(self.pyramid)
        ]
        return torch.cat(out, dim=-1).reshape(n, h, w, -1)


# -----------------------------------------------------------------------------
# fused lookup over the pyramid (tracking)
# -----------------------------------------------------------------------------


def _target_levels(fmap2: Tensor, num_levels: int):
    """The target features of each level: fmap2 scaled by 1/4, then
    average-pooled per level, each contiguous [N, H/2^l, W/2^l, C]."""
    f2 = fmap2 * 0.25
    for i in range(num_levels):
        if i > 0:
            f2 = avg_pool2x2(f2.movedim(-1, 1)).movedim(1, -1)
        yield f2.contiguous()


def lookup_levels(fmap1: Tensor, fmap2: Tensor, coords: Tensor, num_levels: int = 4):
    """The per-level inputs of :func:`corr_level` for one lookup: yields
    (f1 [N, P, C], f2 [N, H/2^l, W/2^l, C], coords [N, P, 2] / 2^l) with
    the feature maps scaled by 1/4 and f2 average-pooled per level."""
    n, h1, w1, c = fmap1.shape
    f1 = (fmap1 * 0.25).reshape(n, h1 * w1, c).contiguous()
    cflat = coords.float().reshape(n, h1 * w1, 2).contiguous()
    for i, f2 in enumerate(_target_levels(fmap2, num_levels)):
        yield f1, f2, cflat / (2.0**i)


def corr_lookup(
    fmap1: Tensor,
    fmap2: Tensor,
    coords: Tensor,
    num_levels: int = 4,
    radius: int = 3,
) -> Tensor:
    """Per-edge correlation pyramid + window lookup (``corr_lookup_fused``).

    fmap1/fmap2 [N, H, W, C] per-edge features, coords [N, H, W, 2] level-0
    targets → [N, H, W, L·(2r+1)²] f32. The feature maps are scaled by 1/4
    and f2 is average-pooled per level outside the kernel; the coords are
    divided by 2^level.
    """
    n, h1, w1, _ = fmap1.shape
    out = [
        corr_level(f1, f2, c, radius)
        for f1, f2, c in lookup_levels(fmap1, fmap2, coords, num_levels)
    ]
    return torch.cat(out, dim=-1).reshape(n, h1, w1, -1)


# -----------------------------------------------------------------------------
# the differentiable lookup (training)
# -----------------------------------------------------------------------------

# the most bytes of the dense volume gradient dV that one launch of the
# backward kernel fills: corr_level_backward cuts the edges into chunks
BACKWARD_DV_BYTES = 1 << 31


def backward_chunk_edges(p: int, h2: int, w2: int) -> int:
    """Edges per launch of the backward kernel at P source pixels and an
    H2 x W2 map: as many as fill :data:`BACKWARD_DV_BYTES` of dV, at least
    one, at most 65535 (the grid's limit)."""
    return max(1, min(65535, BACKWARD_DV_BYTES // max(1, p * h2 * w2 * 4)))


def corr_level_backward_ref(g: Tensor, f1: Tensor, f2: Tensor, coords: Tensor,
                            radius: int = 3) -> Tuple[Tensor, Tensor]:
    """Plain version of the backward of :func:`corr_level_ref`: autograd
    through it. g [N, P, (2r+1)²] f32 → (df1 [N, P, C], df2 [N, H2, W2, C])
    f32; the coords get no gradient."""
    with torch.enable_grad():
        a = f1.detach().to(_sum_dtype(f1)).requires_grad_()
        b = f2.detach().to(_sum_dtype(f2)).requires_grad_()
        out = corr_level_ref(a, b, coords.detach(), radius)
        if not out.requires_grad:  # an empty map: the taps are constant zeros
            return torch.zeros_like(a), torch.zeros_like(b)
        return torch.autograd.grad(out, (a, b), g)


def corr_level_backward(g: Tensor, f1: Tensor, f2: Tensor, coords: Tensor,
                        radius: int = 3) -> Tuple[Tensor, Tensor]:
    """Backward of one level of the lookup (contract of
    :func:`corr_level_backward_ref`).

    A CUDA tensor goes to ``csrc/corr_backward.cu`` (f32 g, features and
    coords, contiguous, C a multiple of 32 up to 256, radius 3): per chunk
    of :func:`backward_chunk_edges` edges one launch writes df1 and each
    pixel's row of the dense volume gradient dV [n, P, H2·W2], then df2 =
    dVᵀ·f1 is one batched product. Nothing is summed with atomics, so equal
    inputs give equal bits. A CPU tensor goes to the plain version.
    """
    if g.device.type == "cpu":
        return corr_level_backward_ref(g, f1, f2, coords, radius)
    _check_cuda("corr_backward", g, f1, f2, coords)
    if any(t.dtype != torch.float32 for t in (g, f1, f2, coords)):
        raise TypeError("corr_backward: g, f1, f2 and coords must be f32, got "
                        f"{g.dtype}/{f1.dtype}/{f2.dtype}/{coords.dtype}")
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    rd = 2 * radius + 1
    if (f2.dim() != 4 or f2.shape[0] != n or f2.shape[3] != c or tuple(coords.shape) != (n, p, 2)
            or tuple(g.shape) != (n, p, rd * rd)):
        raise ValueError(f"corr_backward: shape mismatch g {tuple(g.shape)}, f1 {tuple(f1.shape)}, "
                         f"f2 {tuple(f2.shape)}, coords {tuple(coords.shape)}")
    if c % 32 or not 0 < c <= 256 or radius != 3:
        raise ValueError(f"corr_backward: kernel takes C a multiple of 32 up to 256 and radius 3, "
                         f"got {c}, {radius}")
    if n == 0 or p == 0 or h2 == 0 or w2 == 0:
        return torch.zeros_like(f1), torch.zeros_like(f2)
    df1 = torch.empty_like(f1)  # every row written by the kernel
    df2 = torch.empty_like(f2)  # every row written by the product
    chunk = backward_chunk_edges(p, h2, w2)
    dV = torch.empty((min(chunk, n), p, h2 * w2), dtype=torch.float32, device=f1.device)
    for e0 in range(0, n, chunk):
        e1 = min(n, e0 + chunk)
        kernels.launch(
            "corr_backward", f1.device, g[e0:e1].data_ptr(), f2[e0:e1].data_ptr(),
            coords[e0:e1].data_ptr(), df1[e0:e1].data_ptr(), dV.data_ptr(),
            e1 - e0, p, h2, w2, c, radius, dtype="f32",
        )
        torch.bmm(dV[: e1 - e0].transpose(1, 2), f1[e0:e1], out=df2[e0:e1].view(e1 - e0, h2 * w2, c))
    return df1, df2


class CorrLevel(torch.autograd.Function):
    """One level of the lookup with its gradient with respect to both
    feature maps: forward :func:`corr_level`, backward
    :func:`corr_level_backward`. The coords get no gradient (the training
    unroll detaches them every step); coords that require one are refused."""

    @staticmethod
    def forward(ctx, f1: Tensor, f2: Tensor, coords: Tensor, radius: int) -> Tensor:
        ctx.save_for_backward(f1, f2, coords)
        ctx.radius = radius
        return corr_level(f1, f2, coords, radius)

    @staticmethod
    def backward(ctx, g: Tensor):
        f1, f2, coords = ctx.saved_tensors
        df1, df2 = corr_level_backward(g.contiguous(), f1, f2, coords, ctx.radius)
        return df1, df2, None, None


class CorrPyramid:
    """The training forward's lookup (``CorrPyramid`` of the JAX package,
    ``models/droid_net.py:111-114,141``): the per-edge feature pyramid is
    built once per unroll (f1 scaled by 1/4, f2 scaled and pooled per
    level, which computes the JAX package's pooled volume) and each call
    runs :class:`CorrLevel` per level, so gradients reach both feature
    maps through the backward kernel."""

    def __init__(self, f1: Tensor, levels: List[Tensor], radius: int):
        self.f1 = f1  # [N, P, C]
        self.levels = levels  # level l: [N, H/2^l, W/2^l, C]
        self.radius = radius

    @staticmethod
    def build(fmap1: Tensor, fmap2: Tensor, num_levels: int = 4, radius: int = 3) -> "CorrPyramid":
        n, h1, w1, c = fmap1.shape
        f1 = (fmap1 * 0.25).reshape(n, h1 * w1, c).contiguous()
        return CorrPyramid(f1, list(_target_levels(fmap2, num_levels)), radius)

    def __call__(self, coords: Tensor) -> Tensor:
        """coords [N, H, W, 2] level-0 targets (no gradient) →
        [N, H, W, L·(2r+1)²] f32."""
        if coords.requires_grad:
            raise ValueError("CorrPyramid: the lookup gives no gradient to coords; detach them")
        n, h1, w1, _ = coords.shape
        cflat = coords.float().reshape(n, h1 * w1, 2).contiguous()
        out = [
            CorrLevel.apply(self.f1, f2, (cflat / (2.0**i)).contiguous(), self.radius)
            for i, f2 in enumerate(self.levels)
        ]
        return torch.cat(out, dim=-1).reshape(n, h1, w1, -1)
