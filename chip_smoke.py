#!/usr/bin/env python3
"""Smoke run of the PyTorch port (droid_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out DIR]

Phases, each of which fails the run:
  1. float32 matmuls and convolutions without TF32;
  2. build every hand-written CUDA kernel from droid_slam_tpu_torch/csrc,
     and count the tensor-core instructions (HMMA/HGMMA) of each function
     in the built libraries' SASS: each bf16 tile kernel must have some;
  3. hold corr_level against its plain PyTorch version at the tracking
     path's shapes (48 edges, 30x40 features, C=128, all 4 pyramid levels):
     iid-noise coords in bf16 and f32 (timed, with the plain version),
     smooth-flow coords (timed) and far-out coords in bf16, the 384x512
     levels (48x64 down to 6x8, timed), and the single-edge f32 probe;
  3b. hold the split pair (corr_slab, corr_window) against its plain
     versions at the backend's shapes (one chunk of 256 edges, same
     widths, all 4 levels): iid coords in bf16 and f32 (timed, with
     corr_level's time on the same inputs beside them: the fused-vs-split
     A/B, and with one F.grid_sample call on the same slab, corr_window's
     library yardstick, which it must not lose to at iid bf16), smooth and
     far-out coords in bf16, and the 384x512 levels at 32 edges;
  3c. hold segment_sum, the order-fixed float scatter-add of the BA and
     GraphAgg (index_put_ with accumulate on the card), against index_add_
     (atomic adds on the card) at the tracking and terminate shapes: it must
     agree and repeat bit for bit over 5 runs; index_add_'s repeats are
     counted, both are timed, and the kernels one call launches are named.
     In phases 3 and 3b every kernel runs twice on each input and the two
     results must be bitwise equal;
  4. track 8 seeded 64x64 RGB-D frames on the GPU and on the CPU (plain
     versions) with the same seeded weights, then terminate() and
     terminate(stream) on both: same keyframes and edge sets, poses within
     5e-3 and disparities within 1e-2 after tracking, trajectories within
     5e-3 after terminate (with random weights a monocular replay can flip
     a per-pixel depth-validity mask on one-ulp differences, and the two
     devices sum in different orders; the depth prior keeps the pixels off
     those thresholds);
  5. drive the tracking path, Droid.track, at the bench configuration
     (240x320, buffer 64, 48 edge slots, every frame a keyframe, bfloat16
     compute): warmup+4 frames, then 30 timed frames; the kernel launch
     counts of this phase show the path went through corr_level. Then 5
     more frames under torch.profiler give device time per frame by kernel
     and that of the segment sums;
  6. drive the terminate path, Droid.terminate(), on phase 5's Droid (47
     keyframes) twice, as bench.py does; the launch counts of each show it
     went through the split pair, 4 levels x 19 global-BA steps x the
     update-operator chunks, and the two must repeat: the same backend edge
     counts and chunks, trajectories within 1e-6. Then one more terminate
     under torch.profiler.

It prints a `kernels` JSON line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}. With ``--out DIR`` the details go
to DIR/chip_smoke.json and the profile table to DIR/profile.txt.

Without a CUDA device, or without the droid_slam_tpu_torch package beside
it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s and peak operations/s by
# input type (bf16 runs on the tensor cores; float32 outside them)
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

KERNEL_TOL = 1e-4  # max |kernel − plain| relative to max |plain|
# segment sums: index_add_'s atomic adds sum in another order
SEGMENT_TOL = 1e-5
SEGMENT_REPEATS = 5

# ms per 4-level bf16 lookup of the first designs (corr_level, corr_slab:
# one warp per pixel, f32 FMA; corr_window: one thread per tap), on the
# inputs of phases 3 and 3b: constants, not measured by this run; taken by
# earlier versions of this script on an NVIDIA H100 80GB HBM3 at 700 W
# (the first-design column of PERF.md §6): corr_level and corr_slab with
# CUDA events; corr_window is the low end of its first design's runs,
# 0.3870-0.3896 ms (CUDA events, then profiler device time).
# Printed on a log line of their own beside this run's profiler times.
FIRST_DESIGN_MS = {"corr_level": 0.7206, "corr_slab": 10.6588, "corr_window": 0.3870}

BENCH_CONFIG = dict(
    image_size=(240, 320),
    buffer=64,
    warmup=8,
    max_factors=48,
    inactive_pad=96,
    window_pad=32,
    filter_thresh=-1.0,  # every frame keyframes (worst case)
    keyframe_thresh=0.0,  # never cull
    frontend_window=16,
    frontend_thresh=1e9,
    backend_thresh=1e9,
)

SMALL_CONFIG = dict(
    image_size=(64, 64),
    buffer=32,
    warmup=4,
    max_factors=24,
    inactive_pad=16,
    window_pad=16,
    filter_thresh=-1.0,
    keyframe_thresh=0.0,
    frontend_window=8,
    frontend_thresh=1e9,
    backend_thresh=1e9,
    compute_dtype="float32",
)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Mean time of fn over reps back-to-back calls between two CUDA events:
    the device time when the device is the bottleneck, the host's launch
    time when it is not."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Mean device time of fn per call: the sum of the self device times of
    every kernel fn launched, over reps calls, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler can come back without device events; ask again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        if total > 0:
            return total / 1e3 / reps
    raise RuntimeError("torch.profiler recorded no device time")


def corr_level_cost(torch, f1, f2, coords, radius=3):
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


def make_coords(torch, pops, kind: str, n: int, h: int, w: int, g, dev):
    """Level-0 target coords [n, h, w, 2] of one kind:
    iid: the pixel grid plus iid σ=3 motion, some windows off the map (the
      worst case: a tile's band is most of the map);
    smooth: the grid under a global shift and a 2% zoom, σ=0.5 noise (the
      locality of real tracking: a tile's band is ~8-12 rows);
    far: iid, then a fifth of the pixels at ±1e5 and the border rows and
      columns moved so their windows lie half off the map."""
    grid = pops.coords_grid(h, w, device=dev)
    noise = torch.randn((n, h, w, 2), generator=g, device=dev)
    if kind == "smooth":
        return grid * 1.02 + torch.tensor([2.5, -1.5], device=dev) + 0.5 * noise
    coords = grid + 3.0 * noise
    if kind == "far":
        far = torch.rand((n, h, w), generator=g, device=dev) < 0.2
        sign = torch.where(torch.rand((n, h, w, 2), generator=g, device=dev) < 0.5, -1.0, 1.0)
        coords = torch.where(far[..., None], 1e5 * sign, coords)
        coords[:, 0, :, 1] = -1.0
        coords[:, -1, :, 1] = h - 1.0
        coords[:, :, 0, 0] = -1.0
        coords[:, :, -1, 0] = w - 1.0
    return coords


def compare(torch, out, out2, ref):
    """(max |out − ref|, max |ref|, out finite, out and out2 bitwise equal)."""
    return (float((out - ref).abs().max()), float(ref.abs().max()),
            bool(torch.isfinite(out).all()), bool(torch.equal(out, out2)))


def check_kernels(torch, corr, pops, dev, seed: int, N: int = 48, n_big: int = 48):
    """Phase 3: corr_level against corr_level_ref: the tracking path's
    shapes (N=48, 30x40, C=128, all 4 levels) with iid coords in bf16 and
    f32 (timed, with the plain version), smooth coords (timed) and far-out
    coords in bf16, the 384x512 levels (48x64 down to 6x8, timed) and the
    single-edge f32 probe; every case runs twice and must repeat bitwise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w, C = 30, 40, 128
    fmap1 = torch.randn((N, h, w, C), generator=g, device=dev)
    fmap2 = torch.randn((N, h, w, C), generator=g, device=dev)
    inputs = [("iid", dt, fmap1, fmap2, make_coords(torch, pops, "iid", N, h, w, g, dev))
              for dt in ("bfloat16", "float32")]
    inputs += [(kind, "bfloat16", fmap1, fmap2, make_coords(torch, pops, kind, N, h, w, g, dev))
               for kind in ("smooth", "far")]
    H, W = 48, 64
    big = [torch.randn((n_big, H, W, C), generator=g, device=dev) for _ in range(2)]
    inputs.append(("iid_384x512", "bfloat16", *big, make_coords(torch, pops, "iid", n_big, H, W, g, dev)))
    # the motion-filter probe: one edge, f32 features, identity coords
    probe = [torch.randn((1, h, w, C), generator=g, device=dev) for _ in range(2)]
    inputs.append(("probe", "float32", *probe, pops.coords_grid(h, w, device=dev)[None]))
    cases = []
    for kind, dtype, m1, m2, coords in inputs:
        dt = getattr(torch, dtype)
        for lvl, (f1, f2, c) in enumerate(corr.lookup_levels(m1.to(dt), m2.to(dt), coords)):
            ref = corr.corr_level_ref(f1, f2, c)
            out, out2 = corr.corr_level(f1, f2, c), corr.corr_level(f1, f2, c)
            torch.cuda.synchronize()
            err, scale, finite, bitwise = compare(torch, out, out2, ref)
            del out, out2, ref
            case = dict(kind=kind, dtype=dtype, level=lvl, N=f1.shape[0], P=f1.shape[1],
                        H2=f2.shape[1], W2=f2.shape[2], C=C, max_abs_err=err, max_abs_ref=scale,
                        tol=KERNEL_TOL * scale, bitwise_repeat=bitwise,
                        ok=finite and bitwise and err <= KERNEL_TOL * scale)
            msg = (f"  corr_level {kind:11s} {dtype:8s} L{lvl} [{f1.shape[0]},{f1.shape[1]},{C}]x"
                   f"[{f2.shape[1]}x{f2.shape[2]}]: max_err {err:.3e} (tol {KERNEL_TOL * scale:.3e}) "
                   f"repeat {'bitwise' if bitwise else 'DIFFERS'}")
            if kind != "far" and kind != "probe":
                case["ms"] = device_ms(torch, lambda: corr.corr_level(f1, f2, c), reps=50)
                case["event_ms"] = cuda_ms(torch, lambda: corr.corr_level(f1, f2, c), reps=50)
                nbytes, ops = corr_level_cost(torch, f1, f2, c)
                case.update(bytes=nbytes, ops=ops)
                case["bound_ms"], case["bound_by"] = bound(nbytes, ops, dtype)
                msg += (f" kernel {case['ms']:.4f} ms (events {case['event_ms']:.4f}) "
                        f"bound {case['bound_ms']:.4f} ms")
                if kind == "iid":
                    case["plain_ms"] = device_ms(torch, lambda: corr.corr_level_ref(f1, f2, c), reps=5, warm=1)
                    msg += f" plain {case['plain_ms']:.4f} ms"
            cases.append(case)
            log(msg)
    return cases


def split_cost(torch, f1, f2, coords, radius=3):
    """Bytes and operations of the split pair for one level, per kernel.

    corr_slab: f1, f2 and coords read once, the f32 slab written once;
    2·C operations per dot of an in-range slab row. corr_window: coords
    read, the in-range columns of each pixel's 8x8 slab support read once,
    the output written; 12 f32 operations per output tap."""
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    rows = 2 * radius + 2
    taps = (2 * radius + 1) ** 2
    off = torch.arange(rows, device=coords.device)
    y0 = torch.floor((coords[..., 1] - radius).clamp(-1e4, 1e4))[..., None] + off
    x0 = torch.floor((coords[..., 0] - radius).clamp(-1e4, 1e4))[..., None] + off
    rows_in = int(((y0 >= 0) & (y0 < h2)).sum())
    cols_in = int(((x0 >= 0) & (x0 < w2)).sum())
    coord_bytes = coords.numel() * 4
    slab_bytes = (f1.numel() * f1.element_size() + f2.numel() * f2.element_size()
                  + coord_bytes + n * p * rows * w2 * 4)
    window_bytes = coord_bytes + cols_in * rows * 4 + n * p * taps * 4
    return dict(
        corr_slab=(slab_bytes, 2 * c * rows_in * w2),
        corr_window=(window_bytes, 12 * n * p * taps),
    )


def window_sector_bytes(torch, coords, w2, radius=3, sector=32):
    """What corr_window must move when device memory moves whole sectors
    (32 bytes, or pairs of them with sector=64): the distinct sectors of the
    f32 slab [N·P, 8, W2] that hold the in-map support columns of each
    pixel's 8 rows (8 columns span at most two), the coords and the taps
    written."""
    n, p, _ = coords.shape
    rows = 2 * radius + 2
    x0 = torch.floor((coords[..., 0] - radius).clamp(-1e4, 1e4)).long().reshape(-1, 1)
    lo, hi = x0.clamp(0, w2), (x0 + rows).clamp(0, w2)  # in-map columns [lo, hi)
    row0 = (torch.arange(n * p, device=coords.device)[:, None] * rows
            + torch.arange(rows, device=coords.device)) * w2  # [N·P, 8] first element of each row
    ok = (hi > lo).expand(-1, rows)
    first = ((row0 + lo) * 4 // sector)[ok]
    last = (((row0 + hi) * 4 - 1) // sector)[ok]
    sectors = torch.unique(torch.cat([first, last])).numel()
    return sectors * sector + coords.numel() * 4 + n * p * (2 * radius + 1) ** 2 * 4


def grid_sample_inputs(torch, slab, coords, radius=3):
    """The input [N·P, 1, 8, W2] and grid [N·P, 7(i), 7(j), 2] of the one
    F.grid_sample call (bilinear, zeros padding, align_corners=False) that
    computes corr_window_ref(slab, coords): each pixel's slab is a
    one-channel image, and tap (i, j) samples it at x = x0 + dx + i,
    y = dy + j from the clipped origin, pixel x at (2x + 1) / W2 − 1 and row
    y at (2y + 1) / 8 − 1. The output flattens to taps in (i, j) order."""
    n, p, rows, w2 = slab.shape
    c = coords.reshape(n * p, 2) - radius
    o = torch.floor(c.clamp(-1e4, 1e4))
    d = c - o
    off = torch.arange(2 * radius + 1, device=slab.device, dtype=torch.float32)
    x = (o[:, 0] + d[:, 0])[:, None, None] + off[None, :, None]  # [N·P, 7(i), 1]
    y = d[:, 1][:, None, None] + off[None, None, :]  # [N·P, 1, 7(j)]
    grid = torch.stack(torch.broadcast_tensors((2 * x + 1) / w2 - 1, (2 * y + 1) / rows - 1), -1)
    return slab.reshape(n * p, 1, rows, w2), grid.contiguous()


def grid_sample(torch, inp, grid):
    return torch.nn.functional.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                                           align_corners=False)


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_split_kernels(torch, corr, pops, dev, seed: int, N: int = 256, n_big: int = 32):
    """Phase 3b: corr_slab + corr_window against their plain versions at the
    backend's chunk shapes (N=256, 30x40, C=128, all 4 levels) with iid
    coords in bf16 and f32 (timed, with corr_level on the same inputs: the
    fused-vs-split A/B), smooth (timed) and far-out coords in bf16, and the
    384x512 levels at N=32 (timed); every kernel runs twice per case and
    must repeat bitwise. Each timed case also times corr_window's library
    yardstick, one F.grid_sample call on the same slab, and gives its error
    against the plain version; counts the 32- and 64-byte sectors that
    corr_window must read; and times one sum() over the slab, the rate at
    which the card streams it."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    h, w, C = 30, 40, 128
    fmap1 = torch.randn((N, h, w, C), generator=g, device=dev)
    fmap2 = torch.randn((N, h, w, C), generator=g, device=dev)
    inputs = [("iid", dt, fmap1, fmap2, make_coords(torch, pops, "iid", N, h, w, g, dev))
              for dt in ("bfloat16", "float32")]
    inputs += [(kind, "bfloat16", fmap1, fmap2, make_coords(torch, pops, kind, N, h, w, g, dev))
               for kind in ("smooth", "far")]
    H, W = 48, 64
    big = [torch.randn((n_big, H, W, C), generator=g, device=dev) for _ in range(2)]
    inputs.append(("iid_384x512", "bfloat16", *big, make_coords(torch, pops, "iid", n_big, H, W, g, dev)))
    cases = []
    for kind, dtype, m1, m2, coords in inputs:
        dt = getattr(torch, dtype)
        for lvl, (f1, f2, c) in enumerate(corr.lookup_levels(m1.to(dt), m2.to(dt), coords)):
            slab_ref = corr.corr_slab_ref(f1, f2, c)
            ref = corr.corr_window_ref(slab_ref, c)
            res = dict(
                corr_slab=compare(torch, corr.corr_slab(f1, f2, c), corr.corr_slab(f1, f2, c), slab_ref),
                corr_window=compare(torch, corr.corr_window(slab_ref, c), corr.corr_window(slab_ref, c), ref),
                split=compare(torch, corr.corr_level_split(f1, f2, c), corr.corr_level_split(f1, f2, c), ref),
            )
            torch.cuda.synchronize()
            errs = {k: v[0] for k, v in res.items()}
            scales = {k: v[1] for k, v in res.items()}
            bitwise = {k: v[3] for k, v in res.items()}
            ok = all(v[2] and v[3] and v[0] <= KERNEL_TOL * v[1] for v in res.values())
            case = dict(kind=kind, dtype=dtype, level=lvl, N=f1.shape[0], P=f1.shape[1],
                        H2=f2.shape[1], W2=f2.shape[2], C=C, max_abs_err=errs, max_abs_ref=scales,
                        tol=KERNEL_TOL * scales["split"], bitwise_repeat=bitwise, ok=ok)
            msg = (f"  split {kind:11s} {dtype:8s} L{lvl} [{f1.shape[0]},{f1.shape[1]},{C}]x"
                   f"[{f2.shape[1]}x{f2.shape[2]}]: max_err slab {errs['corr_slab']:.3e} "
                   f"window {errs['corr_window']:.3e} pair {errs['split']:.3e} "
                   f"(tol {KERNEL_TOL * scales['split']:.3e}) "
                   f"repeat {'bitwise' if all(bitwise.values()) else 'DIFFERS'}")
            if kind != "far":
                case["ms"] = dict(
                    corr_slab=device_ms(torch, lambda: corr.corr_slab(f1, f2, c), reps=20),
                    corr_window=device_ms(torch, lambda: corr.corr_window(slab_ref, c), reps=20),
                )
                case["event_ms"] = dict(
                    corr_slab=cuda_ms(torch, lambda: corr.corr_slab(f1, f2, c), reps=20),
                    corr_window=cuda_ms(torch, lambda: corr.corr_window(slab_ref, c), reps=20),
                )
                case["kernels"] = {}
                for name, (nbytes, ops) in split_cost(torch, f1, f2, c).items():
                    b_ms, b_by = bound(nbytes, ops, dtype if name == "corr_slab" else "float32")
                    case["kernels"][name] = dict(bytes=nbytes, ops=ops, bound_ms=b_ms, bound_by=b_by)
                win = case["kernels"]["corr_window"]
                win["sector_bytes"] = window_sector_bytes(torch, c, f2.shape[2])
                win["sector_floor_ms"] = win["sector_bytes"] / MEM_BYTES_PER_S * 1e3
                win["sector64_bytes"] = window_sector_bytes(torch, c, f2.shape[2], sector=64)
                # the rate at which the card streams: one library reduction over the whole slab
                case["slab_read_ms"] = device_ms(torch, lambda: slab_ref.sum(), reps=20)
                # the library yardstick: one grid_sample call on the same slab
                inp, grid = grid_sample_inputs(torch, slab_ref, c)
                lib = grid_sample(torch, inp, grid).reshape(ref.shape)
                case["grid_sample_err"] = float((lib - ref).abs().max())
                case["library_ms"] = dict(corr_window=device_ms(torch, lambda: grid_sample(torch, inp, grid), reps=20))
                del inp, grid, lib
                split_bound = sum(k["bound_ms"] for k in case["kernels"].values())
                msg += (f" slab {case['ms']['corr_slab']:.4f} + window {case['ms']['corr_window']:.4f} ms"
                        f" (bound {split_bound:.4f} ms; window bound {win['bound_ms']:.4f}, sector floor "
                        f"{win['sector_floor_ms']:.4f}, 64-byte sectors {win['sector64_bytes'] / 1e6:.1f} MB in "
                        f"{win['sector64_bytes'] / case['ms']['corr_window'] / 1e9:.2f} TB/s; slab read by sum() "
                        f"{slab_ref.numel() * 4 / case['slab_read_ms'] / 1e9:.2f} TB/s); grid_sample "
                        f"{case['library_ms']['corr_window']:.4f} ms, max_err {case['grid_sample_err']:.3e}")
                if kind == "iid":
                    case["plain_ms"] = dict(
                        corr_slab=device_ms(torch, lambda: corr.corr_slab_ref(f1, f2, c), reps=3, warm=1),
                        corr_window=device_ms(torch, lambda: corr.corr_window_ref(slab_ref, c), reps=3, warm=1),
                    )
                    case["corr_level_ms"] = device_ms(torch, lambda: corr.corr_level(f1, f2, c), reps=20)
                    case["corr_level_bound_ms"], _ = bound(*corr_level_cost(torch, f1, f2, c), dtype)
                    msg += (f" plain {case['plain_ms']['corr_slab']:.4f} + "
                            f"{case['plain_ms']['corr_window']:.4f} ms; corr_level {case['corr_level_ms']:.4f} ms "
                            f"(bound {case['corr_level_bound_ms']:.4f} ms)")
            cases.append(case)
            log(msg)
            del slab_ref, ref
    return cases


# (segments, row shape, rows) of the segment sums on the paths: tracking's
# dense-window BA (6x6 pose blocks into the 32x32 window, the E couplings of
# 48 edges' Ei and Ej rows into 40x32 cells) and GraphAgg over 48 edges into
# 40 frames; terminate's GraphAgg over a 256-edge chunk, its Ei rows of a
# 768-slot edge store into 64 frames, and ~6000 Schur block pairs into the
# 64x64 window
SEGMENT_CASES = {
    "track_pose_blocks": (32 * 32, (6, 6), 48),
    "track_E": (40 * 32, (6, 1200), 96),
    "track_graph_agg": (40, (128 * 1200,), 48),
    "terminate_graph_agg": (64, (128 * 1200,), 256),
    "terminate_Ei": (64, (6, 1200), 768),
    "terminate_pairs": (64 * 64, (6, 6), 6000),
}


def launched_kernels(torch, fn) -> list:
    """Names of the CUDA kernels one call of fn launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:80] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation})


def check_segment_sum(torch, segment, dev, seed: int):
    """Phase 3c: segment_sum (index_put_ with accumulate on the card: the
    ids sorted, each segment's rows summed without atomics) against
    index_add_ at the paths' shapes: within SEGMENT_TOL and bitwise equal
    over SEGMENT_REPEATS runs. index_add_'s own repeats (atomic adds on the
    card) are reported, not required; both are timed."""
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    cases = []
    for name, (n_seg, row, k) in SEGMENT_CASES.items():
        idx = torch.randint(-1, n_seg + 1, (k,), generator=g, device=dev)  # some dropped
        idx[: k // 4] = n_seg // 2  # a crowded segment
        src = torch.randn((k,) + row, generator=g, device=dev)
        outs = [segment.segment_sum(idx, src, n_seg) for _ in range(SEGMENT_REPEATS)]
        refs = [segment.segment_sum_ref(idx, src, n_seg) for _ in range(SEGMENT_REPEATS)]
        cpu = segment.segment_sum_ref(idx.cpu(), src.cpu(), n_seg)
        torch.cuda.synchronize()
        err, scale, finite, _ = compare(torch, outs[0], outs[1], refs[0])
        repeats = all(torch.equal(outs[0], o) for o in outs[1:])
        ref_repeats = all(torch.equal(refs[0], r) for r in refs[1:])
        same_as_cpu = bool(torch.equal(outs[0].cpu(), cpu))
        del outs, refs
        ms = device_ms(torch, lambda: segment.segment_sum(idx, src, n_seg), reps=20)
        index_add_ms = device_ms(torch, lambda: segment.segment_sum_ref(idx, src, n_seg), reps=20)
        launched = launched_kernels(torch, lambda: segment.segment_sum(idx, src, n_seg))
        cases.append(dict(name=name, segments=n_seg, row=list(row), rows=k, max_abs_err=err,
                          max_abs_ref=scale, tol=SEGMENT_TOL * scale, bitwise_repeat=repeats,
                          index_add_bitwise_repeat=ref_repeats, bitwise_cpu=same_as_cpu,
                          ms=ms, index_add_ms=index_add_ms, kernels=launched,
                          ok=finite and repeats and err <= SEGMENT_TOL * scale))
        log(f"  segment_sum {name:20s} [{k}]->[{n_seg}]x{list(row)}: max_err {err:.3e} "
            f"(tol {SEGMENT_TOL * scale:.3e}) repeat {'bitwise' if repeats else 'DIFFERS'} "
            f"(index_add_: {'bitwise' if ref_repeats else 'DIFFERS'}), "
            f"{'bitwise' if same_as_cpu else 'not bitwise'} = CPU; {ms:.4f} ms, "
            f"index_add_ {index_add_ms:.4f} ms; kernels {launched}")
    return cases


def small_replay(torch, np, Droid, DroidConfig, init_params, seed: int):
    """Phase 4: the same 8 RGB-D frames through the GPU port and the CPU port."""
    params = init_params(seed)
    rng = np.random.default_rng(1234 + seed)
    intr = np.array([64.0, 64.0, 32.0, 32.0], np.float32)
    frames = [
        (rng.integers(0, 255, (64, 64, 3), np.uint8),
         ((1.0 + 2.0 * rng.random((64, 64))) * (rng.random((64, 64)) > 0.2)).astype(np.float32))
        for _ in range(8)
    ]
    # the frames between the keyframes, for the trajectory filler
    stream = [(t + 0.5, img, intr) for t, (img, _) in enumerate(frames)]
    runs, trajs = {}, {}
    for device in ("cuda", "cpu"):
        d = Droid(DroidConfig(**SMALL_CONFIG), params=params, device=device)
        for t, (img, depth) in enumerate(frames):
            d.track(t, img, depth=depth, intrinsics=intr)
        runs[device] = d
        trajs[device] = (d.terminate(), d.terminate(iter(stream)))
    gpu, cpu = runs["cuda"], runs["cpu"]
    dp = float((gpu.poses.cpu() - cpu.poses).abs().max())
    dd = float((gpu.disps.cpu() - cpu.disps).abs().max())
    (g_traj, g_fill), (c_traj, c_fill) = trajs["cuda"], trajs["cpu"]
    res = dict(
        keyframes=gpu.counter, same_keyframes=gpu.counter == cpu.counter,
        same_edges=gpu.edges == cpu.edges and gpu.inactive_edges == cpu.inactive_edges,
        n_edges=len(gpu.edges), n_inactive=len(gpu.inactive_edges),
        pose_err=dp, disp_err=dd,
        terminate_err=float(np.abs(g_traj - c_traj).max()),
        terminate_stream_err=float(np.abs(g_fill - c_fill).max()),
        shapes_ok=g_traj.shape == (gpu.counter, 7) and g_fill.shape == (len(stream), 7),
        finite=bool(np.isfinite(g_traj).all() and np.isfinite(g_fill).all()),
    )
    res["ok"] = bool(res["same_keyframes"] and res["same_edges"] and dp < 5e-3 and dd < 1e-2
                     and res["terminate_err"] < 5e-3 and res["terminate_stream_err"] < 5e-3
                     and res["shapes_ok"] and res["finite"])
    log(f"  {res}")
    return res


def main_path(torch, np, kernels, Droid, DroidConfig, init_params, seed: int, out_dir):
    """Phase 5: Droid.track at the bench configuration; returns the result
    and the Droid, which phase 6 terminates."""
    cfg = DroidConfig(**BENCH_CONFIG)
    dev = torch.device("cuda")
    droid = Droid(cfg, params=init_params(seed), device=dev)
    H, W = cfg.image_size
    rng = np.random.default_rng(seed)
    frames = [torch.from_numpy(rng.integers(0, 255, (H, W, 3), np.uint8)).to(dev) for _ in range(28)]
    intr = torch.tensor([W * 1.2, W * 1.2, W / 2, H / 2], device=dev)
    torch.cuda.synchronize()

    n_warm, n_timed = cfg.warmup + 4, 30
    kernels.reset_launches()
    t = 0
    t0 = time.perf_counter()
    for _ in range(n_warm):
        droid.track(t, frames[t % len(frames)], intrinsics=intr)
        t += 1
    droid.sync()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_timed):
        droid.track(t, frames[t % len(frames)], intrinsics=intr)
        t += 1
    droid.sync()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    poses, disps = droid.poses, droid.disps
    h, w = cfg.feat_size
    res = dict(
        frames=t, keyframes=droid.counter, fps=n_timed / elapsed, timed_s=elapsed,
        warmup_s=warm_s, launches=launches, n_edges=len(droid.edges),
        n_inactive=len(droid.inactive_edges),
        # probe on frames 1..warmup-1, 16 init iterations, then per frame
        # 1 probe + 4 + 2 iterations; 4 levels each
        expected_corr_launches=4 * ((cfg.warmup - 1) + 16 + 7 * (t - cfg.warmup)),
        finite=bool(torch.isfinite(poses).all() and torch.isfinite(disps).all()),
        shapes_ok=tuple(poses.shape) == (droid.counter, 7) and tuple(disps.shape) == (droid.counter, h, w),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    res["ok"] = bool(res["finite"] and res["shapes_ok"] and droid.counter == t
                     and launches["corr_level"] == res["expected_corr_launches"])
    log(f"  {res}")

    # device time by kernel over 5 more frames (after the counts were read)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            droid.track(t, frames[t % len(frames)], intrinsics=intr)
            t += 1
        droid.sync()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    if out_dir is not None:
        (out_dir / "profile.txt").write_text(events.table(sort_by="self_cuda_time_total", row_limit=40))
    # the kernel rows only, as the table's own footer sums device time
    kernel_us = {e.key: e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    dev_ms = sum(kernel_us.values()) / 1e3 / n_prof
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:8]
    seg_ms, seg_calls = range_ms(events, DeviceType, "segment_sum")
    res["profile"] = dict(
        frames=n_prof,
        profiled_wall_ms_per_frame=wall * 1e3 / n_prof,
        device_ms_per_frame=dev_ms,
        corr_level_ms_per_frame=sum(v for k, v in kernel_us.items() if "corr_level" in k) / 1e3 / n_prof,
        segment_sum_ms_per_frame=seg_ms / n_prof,
        segment_sum_calls_per_frame=seg_calls / n_prof,
        # against the unprofiled frame time of the timed window
        device_busy_share=dev_ms * res["fps"] / 1e3,
        top_kernels_ms_per_frame={k[:60]: v / 1e3 / n_prof for k, v in top},
    )
    log(f"  profile: {res['profile']}")
    return res, droid


def kernel_ms(events, DeviceType, needle: str) -> float:
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and needle in e.key) / 1e3


def range_ms(events, DeviceType, name: str):
    """(device ms, calls) of the kernels launched inside the profiler
    range ``name`` (torch.profiler.record_function)."""
    for e in events:
        if e.key == name and e.device_type == DeviceType.CPU:
            return e.device_time_total / 1e3, e.count
    return 0.0, 0


def terminate_path(torch, np, kernels, droid, out_dir):
    """Phase 6: Droid.terminate() twice on phase 5's Droid, which must
    repeat (the same backend edge counts and chunks, trajectories within
    1e-6), then once more under torch.profiler."""
    runs, trajs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        traj = droid.terminate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        steps_x_chunks = sum(steps * chunks for steps, (_, chunks) in zip((7, 12), droid.backend_runs))
        run = dict(
            wall_s=wall, launches=launches, backend_runs=droid.backend_runs,
            expected_split_launches=4 * steps_x_chunks,
            finite=bool(np.isfinite(traj).all()),
            shape_ok=traj.shape == (droid.counter, 7),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        )
        run["ok"] = bool(run["finite"] and run["shape_ok"] and steps_x_chunks > 0
                         and launches["corr_slab"] == launches["corr_window"] == run["expected_split_launches"])
        log(f"  terminate: {run}")
        runs.append(run)
        trajs.append(traj)
    repeat = dict(
        same_backend_runs=runs[0]["backend_runs"] == runs[1]["backend_runs"],
        trajectory_max_diff=float(np.abs(trajs[0] - trajs[1]).max()),
    )
    repeat["ok"] = bool(repeat["same_backend_runs"] and repeat["trajectory_max_diff"] <= 1e-6)
    log(f"  repeat: {repeat}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        droid.terminate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    if out_dir is not None:
        (out_dir / "profile_terminate.txt").write_text(
            events.table(sort_by="self_cuda_time_total", row_limit=40))
    kernel_us = {e.key: e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    dev_ms = sum(kernel_us.values()) / 1e3
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:10]
    seg_ms, seg_calls = range_ms(events, DeviceType, "segment_sum")
    profile_res = dict(
        profiled_wall_ms=wall * 1e3, device_ms=dev_ms,
        corr_slab_ms=kernel_ms(events, DeviceType, "corr_slab"),
        corr_window_ms=kernel_ms(events, DeviceType, "corr_window"),
        segment_sum_ms=seg_ms, segment_sum_calls=seg_calls,
        device_busy_share=dev_ms / (runs[-1]["wall_s"] * 1e3),
        top_kernels_ms={k[:60]: v / 1e3 for k, v in top},
    )
    log(f"  profile: {profile_res}")
    return dict(runs=runs, repeat=repeat, profile=profile_res, keyframes=droid.counter,
                ok=all(r["ok"] for r in runs) and repeat["ok"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    ap.add_argument("--out", type=Path, default=None, help="directory for the detail files")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs one CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from droid_slam_tpu_torch.models.droid_net import init_params
    from droid_slam_tpu_torch.ops import corr, kernels, segment
    from droid_slam_tpu_torch.ops import projective as pops
    from droid_slam_tpu_torch.runtime import Droid, DroidConfig

    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    log("phase 1: TF32 off")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    log("phase 2: build kernels")
    t0 = time.perf_counter()
    build_logs = kernels.build()
    build_s = time.perf_counter() - t0
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
    log(f"  built {sorted(build_logs) or 'nothing (cached)'} in {build_s:.1f} s")
    sass = kernels.sass_counts()
    for func, counts in sorted(sass.items()):
        log(f"  sass {func}: " + ", ".join(f"{op} {k}" for op, k in counts.items()))
    # the bf16 instantiations must run on the tensor cores
    tile_mma = {f: sum(c.values()) for f, c in sass.items() if "tile_kernel" in f}

    log("phase 3: kernels vs plain versions at main-path shapes")
    cases = check_kernels(torch, corr, pops, dev, args.seed)

    log("phase 3b: split pair vs plain versions at backend shapes")
    split_cases = check_split_kernels(torch, corr, pops, dev, args.seed)

    log("phase 3c: order-fixed segment sums vs index_add_ at the paths' shapes")
    seg_cases = check_segment_sum(torch, segment, dev, args.seed)

    log("phase 4: small replay + terminate, GPU port vs CPU port")
    small = small_replay(torch, np, Droid, DroidConfig, init_params, args.seed)

    log("phase 5: main path, Droid.track at the bench configuration")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    main_res, droid = main_path(torch, np, kernels, Droid, DroidConfig, init_params, args.seed, args.out)

    log("phase 6: terminate path, Droid.terminate() at the bench configuration")
    term_res = terminate_path(torch, np, kernels, droid, args.out)
    del droid

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]

    def share(row):
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        return row

    # one main-path lookup: the 4 levels at N=48, iid coords, bf16 features
    main_cases = [c for c in cases if c["dtype"] == "bfloat16" and c["kind"] == "iid"]
    bound_bytes = sum(c["bytes"] / MEM_BYTES_PER_S for c in main_cases)
    bound_ops = sum(c["ops"] / PEAK_OPS_PER_S["bfloat16"] for c in main_cases)
    kernel_rows = [share(dict(
        name="corr_level",
        route="cuda",
        source="droid_slam_tpu_torch/csrc/corr_level.cu",
        replaces="droid_slam_tpu/ops/pallas_corr.py:80",
        launches=main_res["launches"]["corr_level"],
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=sum(c["ms"] for c in main_cases),
        plain_ms=sum(c["plain_ms"] for c in main_cases),
        bound_ms=sum(c["bound_ms"] for c in main_cases),
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        library_ms=None,
    ))]
    # the split pair: one backend chunk lookup, the 4 levels at N=256, iid, bf16
    split_bf16 = [c for c in split_cases if c["dtype"] == "bfloat16" and c["kind"] == "iid"]
    for name, line in (("corr_slab", 170), ("corr_window", 212)):
        k_bytes = sum(c["kernels"][name]["bytes"] / MEM_BYTES_PER_S for c in split_bf16)
        k_ops = sum(c["kernels"][name]["ops"] / PEAK_OPS_PER_S["bfloat16" if name == "corr_slab" else "float32"]
                    for c in split_bf16)
        row = share(dict(
            name=name,
            route="cuda",
            source="droid_slam_tpu_torch/csrc/corr_split.cu",
            replaces=f"droid_slam_tpu/ops/pallas_corr.py:{line}",
            launches=term_res["runs"][0]["launches"][name],
            max_abs_err=max(c["max_abs_err"][name] for c in split_cases),
            ms=sum(c["ms"][name] for c in split_bf16),
            plain_ms=sum(c["plain_ms"][name] for c in split_bf16),
            bound_ms=sum(c["kernels"][name]["bound_ms"] for c in split_bf16),
            bound_by="bytes" if k_bytes >= k_ops else "operations",
            library_ms=(sum(c["library_ms"][name] for c in split_bf16)
                        if name == "corr_window" else None),
        ))
        kernel_rows.append(row)
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(dict(
            device=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__,
            build_s=build_s, sass=sass, cases=cases, split_cases=split_cases, segment_cases=seg_cases,
            small_replay=small,
            main_path=main_res, terminate_path=term_res, kernels=kernel_rows,
        ), indent=1))

    failed = [f"{f}: no tensor-core instructions" for f, k in tile_mma.items() if k == 0]
    # 2 kernels x C in (32, 64, 128, 256) x 1, 2, 4 or 8 n8 tiles per chunk
    if len(tile_mma) != 32:
        failed.append(f"expected 32 bf16 tile instantiations in the SASS, found {len(tile_mma)}")
    failed += [f"corr_level {c['kind']} {c['dtype']} L{c['level']} N={c['N']}" for c in cases if not c["ok"]]
    if not small["ok"]:
        failed.append("small replay")
    failed += [f"split pair {c['kind']} {c['dtype']} L{c['level']}" for c in split_cases if not c["ok"]]
    failed += [f"grid_sample yardstick {c['kind']} {c['dtype']} L{c['level']}: max_err {c['grid_sample_err']:.3e}"
               for c in split_cases
               if c.get("grid_sample_err", 0.0) > KERNEL_TOL * c["max_abs_ref"]["corr_window"]]
    window = next(r for r in kernel_rows if r["name"] == "corr_window")
    if window["ms"] > window["library_ms"]:
        failed.append(f"corr_window {window['ms']:.4f} ms is slower than grid_sample "
                      f"{window['library_ms']:.4f} ms (iid, bf16, N=256, 4 levels)")
    failed += [f"segment_sum {c['name']}" for c in seg_cases if not c["ok"]]
    if not main_res["ok"]:
        failed.append("main path")
    if not term_res["ok"]:
        failed.append("terminate path")
    if failed:
        print("chip_smoke: FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1

    log(f"main path: {main_res['fps']:.2f} frames/s, {main_res['keyframes']} keyframes, "
        f"corr_level launches {main_res['launches']['corr_level']}")
    walls = ", ".join(f"{r['wall_s']:.3f}" for r in term_res["runs"])
    first = term_res["runs"][0]["launches"]
    log(f"terminate path: {term_res['keyframes']} keyframes, wall {walls} s, "
        f"corr_slab/corr_window launches {first['corr_slab']}/{first['corr_window']}, "
        f"repeats: {term_res['repeat']}")
    for row in kernel_rows:
        if row["name"] in FIRST_DESIGN_MS:
            log(f"{row['name']}: {row['ms']:.4f} ms in this run (profiler); first design "
                f"{FIRST_DESIGN_MS[row['name']]} ms (a constant from earlier runs)")
    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
