"""Correlation pyramid lookup (PyTorch), as the reference runs it.

Counterpart of the port's ``ops/corr.py``: per edge, the correlation of the
source features with the target features pooled to 4 levels, sampled in a
(2r+1)² bilinear window around each source pixel's target coordinates.
Channel order of the result is (level, i, j) with i the x-offset; taps
outside the map are 0. The fused lookup (:func:`corr_lookup` →
:func:`corr_level`) serves the tracking step and the motion probe.

Departure from the port: :func:`corr_level` is the plain version,
:func:`corr_level_ref` (a per-edge correlation volume by batched f32
matmul, then a gather of the support and the bilinear blend), on any
device, where the port launches ``csrc/corr_level.cu`` on a CUDA tensor.
The port's split pair (the global backend's), its tile plans and the
differentiable lookup of the training unroll are not copied.
"""

from __future__ import annotations

import torch

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


# the reference: the lookup is its plain version, on any device
corr_level = corr_level_ref


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
