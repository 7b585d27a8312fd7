"""The yardstick's arithmetic: the card's peaks, the bytes and operations a
lookup needs, and the floating-point operations of DroidNet's convolutions
from its layer shapes.

``corr_level_cost`` and ``bound`` are copied from the
repository's ``chip_smoke.py`` (as it stood when the benchmark was
written), with their counting unchanged. The DroidNet counts are written
from the layer shapes of the published network (fnet 128, cnet 256, GRU
128, 4 levels of radius 3): 2 operations per multiply-add, per output
pixel, bias and activations not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s and peak operations/s by
# input type (bf16 runs on the tensor cores; float32, with TF32 off,
# outside them)
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

RADIUS = 3
LEVELS = 4
TAPS = (2 * RADIUS + 1) ** 2  # 49 taps per level
CORR_CHANNELS = 128  # fnet's output width


def bound(nbytes, ops, dtype):
    """(least ms the card needs for ``nbytes`` moved and ``ops`` of type
    ``dtype``, and which of the two sets it)."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def corr_level_cost(torch, f1, f2, coords, radius=RADIUS):
    """Bytes the level must move (each input read once, the output written
    once) and the operations these inputs need: 2·C per in-bounds support
    dot, plus 12 per output tap for the bilinear blend."""
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    rd = 2 * radius + 1
    out_bytes = n * p * rd * rd * 4
    nbytes = sum(t.numel() * t.element_size() for t in (f1, f2, coords)) + out_bytes
    off = torch.arange(rd + 1, device=coords.device)
    x0 = torch.floor((coords[..., 0] - radius).clamp(-1e4, 1e4))[..., None] + off
    y0 = torch.floor((coords[..., 1] - radius).clamp(-1e4, 1e4))[..., None] + off
    xs_in = ((x0 >= 0) & (x0 < w2)).sum(-1)
    ys_in = ((y0 >= 0) & (y0 < h2)).sum(-1)
    dots = int((xs_in * ys_in).sum())
    ops = 2 * c * dots + 12 * n * p * rd * rd
    return nbytes, ops


# ---------------------------------------------------------------------------
# lookups counted from shapes alone (the counting passes)
# ---------------------------------------------------------------------------


def level_sizes(h: int, w: int, levels: int = LEVELS):
    """The target map of each pyramid level: 2×2 average pools, floor mode."""
    return [(h >> lvl, w >> lvl) for lvl in range(levels)]


def lookup_work(edges: int, h: int, w: int, feat_bytes: int, c: int = CORR_CHANNELS,
                radius: int = RADIUS, levels: int = LEVELS) -> Tuple[int, int]:
    """(bytes, operations) of one fused 4-level lookup over ``edges`` edges
    at a level-0 map of h×w, features of ``feat_bytes`` bytes per channel:
    per level f1 [E, h·w, C], f2 [E, h_l, w_l, C] and the coords read once
    and the f32 taps written once; 2·C operations per support dot and 12
    per tap. Every support dot is counted as in the map, which overcounts
    the operations at the border; the bytes set the bound by about tenfold
    at the tracking shapes, so the count of dots does not move the share."""
    p = h * w
    sup = (2 * radius + 2) ** 2
    taps = (2 * radius + 1) ** 2
    nbytes = ops = 0
    for h2, w2 in level_sizes(h, w, levels):
        nbytes += edges * (p * c * feat_bytes + h2 * w2 * c * feat_bytes + p * 2 * 4 + p * taps * 4)
        ops += edges * p * (2 * c * sup + 12 * taps)
    return nbytes, ops


def lookup_dots(edges: int, h: int, w: int, c: int = CORR_CHANNELS, radius: int = RADIUS,
                levels: int = LEVELS) -> int:
    """The correlation's multiply-add operations (2 per multiply-add) of one
    4-level lookup: a C-long dot per support point of every pixel and level."""
    return edges * h * w * levels * 2 * c * (2 * radius + 2) ** 2


# ---------------------------------------------------------------------------
# DroidNet's convolutions, from the layer shapes
# ---------------------------------------------------------------------------


def conv_flops(cin: int, cout: int, k: int, h_out: int, w_out: int) -> int:
    return 2 * cin * cout * k * k * h_out * w_out


def encoder_flops(H: int, W: int, output_dim: int) -> int:
    """One image through the stride-8 residual encoder (fnet: output 128,
    cnet: 256): a 7×7 stride-2 stem of 32, residual stages of 32, 64 and
    128 channels (two blocks of two 3×3 convs each; the first block of
    stages 2 and 3 has stride 2 and a 1×1 projection), a 1×1 head."""
    dim = 32
    h, w = (H + 1) // 2, (W + 1) // 2
    total = conv_flops(3, dim, 7, h, w)
    cin = dim
    for planes, stride in ((dim, 1), (2 * dim, 2), (4 * dim, 2)):
        if stride == 2:
            h, w = (h + 1) // 2, (w + 1) // 2
        total += conv_flops(cin, planes, 3, h, w) + conv_flops(planes, planes, 3, h, w)
        if stride != 1 or cin != planes:
            total += conv_flops(cin, planes, 1, h, w)
        total += 2 * conv_flops(planes, planes, 3, h, w)  # the stage's second block
        cin = planes
    total += conv_flops(cin, output_dim, 1, h, w)
    return total


# per pixel of the 1/8 map, per edge: corr_enc 196→128 (1×1), 128→128
# (3×3); flow_enc 4→128 (7×7), 128→64 (3×3); the GRU's three 3×3 gates
# over 128 + 320 inputs and its 1×1 context map; the delta and weight heads
# 128→128→2 (3×3 each); GraphAgg's first 3×3
_EDGE_PIXEL = (2 * (196 * 128 + 128 * 128 * 9 + 4 * 128 * 49 + 128 * 64 * 9)
               + 2 * (3 * (128 + 320) * 128 * 9 + 128 * 128)
               + 2 * 2 * (128 * 128 * 9 + 128 * 2 * 9))
_AGG_EDGE_PIXEL = 2 * 128 * 128 * 9
# per pixel, per frame of GraphAgg's scatter-mean: 128→128 (3×3), eta
# 128→1 (3×3), upmask 128→576 (1×1)
_AGG_FRAME_PIXEL = 2 * (128 * 128 * 9 + 128 * 9 + 128 * 576)
# per edge, on the GRU's pooled 1×1 context: three 128→128 1×1 maps
_GRU_GLOBAL_EDGE = 3 * 2 * 128 * 128


def update_flops(edges: int, h: int, w: int, frames: int = 0) -> int:
    """One update-operator iteration over ``edges`` edges at h×w, with
    GraphAgg over ``frames`` distinct source frames (0: no aggregation, as
    in the motion filter's probe)."""
    p = h * w
    total = edges * (p * _EDGE_PIXEL + _GRU_GLOBAL_EDGE)
    if frames:
        total += edges * p * _AGG_EDGE_PIXEL + frames * p * _AGG_FRAME_PIXEL
    return total


def add(acc: Dict[str, float], dtype: str, n: float) -> None:
    acc[dtype] = acc.get(dtype, 0) + n


def peak_seconds(flops: Dict[str, float]) -> float:
    """Seconds the card needs at its peaks for operations by type."""
    return sum(n / PEAK_OPS_PER_S[dt] for dt, n in flops.items())
