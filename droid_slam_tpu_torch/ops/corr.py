"""Correlation pyramid lookup of the tracking path (PyTorch + CUDA).

Counterpart of ``corr_lookup_fused`` in the JAX package's ``ops/corr.py``:
per edge, the correlation of the source features with the target features
pooled to 4 levels, sampled in a (2r+1)² bilinear window around each
source pixel's target coordinates. Channel order of the result is
(level, i, j) with i the x-offset; taps outside the map are 0.

One level is :func:`corr_level`. On a CUDA tensor it launches the
hand-written kernel ``csrc/corr_level.cu``; on a CPU tensor it runs the
plain version :func:`corr_level_ref`. There is no fallback between the two.
"""

from __future__ import annotations

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
    rd = 2 * radius + 1
    sup = rd + 1
    vol = torch.bmm(f1.float(), f2.float().reshape(n, h2 * w2, c).transpose(1, 2))

    x0 = coords[..., 0] - radius
    y0 = coords[..., 1] - radius
    x0f = torch.floor(x0.clamp(-1e4, 1e4))
    y0f = torch.floor(y0.clamp(-1e4, 1e4))
    dx = (x0 - x0f)[..., None, None]
    dy = (y0 - y0f)[..., None, None]

    off = torch.arange(sup, device=f1.device)
    ys = y0f.long()[..., None] + off  # [N, P, sup]
    xs = x0f.long()[..., None] + off
    ok = ((ys >= 0) & (ys < h2))[..., :, None] & ((xs >= 0) & (xs < w2))[..., None, :]
    idx = ys.clamp(0, h2 - 1)[..., :, None] * w2 + xs.clamp(0, w2 - 1)[..., None, :]
    patch = torch.gather(vol, 2, idx.reshape(n, p, sup * sup)).reshape(n, p, sup, sup)
    patch = torch.where(ok, patch, torch.zeros_like(patch))  # [N, P, j(y), i(x)]

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
    return out.transpose(-1, -2).reshape(n, p, rd * rd)


def corr_level(f1: Tensor, f2: Tensor, coords: Tensor, radius: int = 3) -> Tensor:
    """One pyramid level of fused correlation + window lookup.

    Same contract as :func:`corr_level_ref`. A CUDA tensor goes to the
    kernel of ``csrc/corr_level.cu`` (bf16 or f32 features, f32 coords, all
    contiguous, C ∈ {32, 64, 128, 256}, radius 3); anything it does not take
    raises. A CPU tensor goes to the plain version.
    """
    if f1.device.type == "cpu":
        return corr_level_ref(f1, f2, coords, radius)
    if f1.device.type != "cuda":
        raise ValueError(f"corr_level: unsupported device {f1.device}")
    if f2.device != f1.device or coords.device != f1.device:
        raise ValueError("corr_level: f1, f2 and coords must be on one device")
    if f1.dtype not in (torch.bfloat16, torch.float32) or f2.dtype != f1.dtype:
        raise TypeError(f"corr_level: f1/f2 must both be bf16 or f32, got {f1.dtype}/{f2.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"corr_level: coords must be f32, got {coords.dtype}")
    if f1.dim() != 3 or f2.dim() != 4 or coords.dim() != 3:
        raise ValueError("corr_level: expects f1 [N,P,C], f2 [N,H2,W2,C], coords [N,P,2]")
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    if f2.shape[0] != n or f2.shape[3] != c or tuple(coords.shape) != (n, p, 2):
        raise ValueError(
            f"corr_level: shape mismatch f1 {tuple(f1.shape)}, f2 {tuple(f2.shape)}, "
            f"coords {tuple(coords.shape)}"
        )
    if c not in (32, 64, 128, 256) or radius != 3:
        raise ValueError(f"corr_level: kernel takes C in (32, 64, 128, 256) and radius 3, got {c}, {radius}")
    if not (f1.is_contiguous() and f2.is_contiguous() and coords.is_contiguous()):
        raise ValueError("corr_level: inputs must be contiguous")
    if n > 65535:
        raise ValueError(f"corr_level: at most 65535 edges per launch, got {n}")

    rd = 2 * radius + 1
    out = torch.empty((n, p, rd * rd), dtype=torch.float32, device=f1.device)
    if n == 0 or p == 0 or h2 == 0 or w2 == 0:
        return out.zero_()
    lib = kernels.library("corr_level")
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_level_launch(
            f1.data_ptr(), f2.data_ptr(), coords.data_ptr(), out.data_ptr(),
            n, p, h2, w2, c, radius, int(f1.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"corr_level: kernel launch failed with CUDA error {err}")
    kernels.LAUNCHES["corr_level"] += 1
    return out


def lookup_levels(fmap1: Tensor, fmap2: Tensor, coords: Tensor, num_levels: int = 4):
    """The per-level inputs of :func:`corr_level` for one lookup: yields
    (f1 [N, P, C], f2 [N, H/2^l, W/2^l, C], coords [N, P, 2] / 2^l) with
    the feature maps scaled by 1/4 and f2 average-pooled per level."""
    n, h1, w1, c = fmap1.shape
    f1 = (fmap1 * 0.25).reshape(n, h1 * w1, c).contiguous()
    f2 = fmap2 * 0.25
    cflat = coords.float().reshape(n, h1 * w1, 2).contiguous()
    for i in range(num_levels):
        if i > 0:
            f2 = avg_pool2x2(f2.movedim(-1, 1)).movedim(1, -1)
        yield f1, f2.contiguous(), cflat / (2.0**i)


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
