#!/usr/bin/env python3
"""Smoke run of the PyTorch port (droid_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out DIR]

Phases, each of which fails the run:
  1. float32 matmuls and convolutions without TF32;
  2. build every hand-written CUDA kernel from droid_slam_tpu_torch/csrc,
     print each f32 function's registers, shared memory and spills, and
     count the tensor-core instructions (HMMA/HGMMA) of each function in
     the built libraries' SASS: each bf16 tile kernel must have some, and
     the f32 functions (the band tiles and their sort) none: a TF32 route
     would show there;
  3. hold corr_level against its plain PyTorch version at the tracking
     path's shapes (48 edges, 30x40 features, C=128, all 4 pyramid levels)
     in bf16 and f32: iid-noise coords (timed, with the plain version),
     smooth-flow coords (timed), far-out coords, the 384x512 levels (48x64
     down to 6x8, timed), and the single-edge f32 probe (timed, with the
     plain version);
  3b. hold the split pair (corr_slab, corr_window) against its plain
     versions at the backend's shapes (one chunk of 256 edges, same
     widths, all 4 levels) in bf16 and f32: iid coords (timed, with
     corr_level's time on the same inputs beside them: the fused-vs-split
     A/B, and with one F.grid_sample call on the same slab, corr_window's
     library yardstick, which it must not lose to at iid bf16), smooth
     (timed) and far-out coords, and the 384x512 levels at 32 edges
     (timed); each timed f32 case counts the band rows the f32 tiles
     multiply against the rows the pixels need;
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
     counts of this phase show the path went through corr_level, in bf16
     (the operator's lookups) and in f32 (the motion probe). Then 5
     more frames under torch.profiler give device time per frame by kernel
     and that of the segment sums;
  6. drive the terminate path, Droid.terminate(), on phase 5's Droid (47
     keyframes) twice, as bench.py does; the launch counts of each show it
     went through the split pair, 4 levels x 19 global-BA steps x the
     update-operator chunks, and the two must repeat: the same backend edge
     counts and chunks, trajectories within 1e-6. Then one more terminate
     under torch.profiler;
  7. the synthetic protocol with the shipped weights
     (weights/droid_synth.msgpack, read by the port's own msgpack reader)
     through droid_slam_tpu_torch/apps/evaluate.py's run_slam: rows 1-6 the
     six monocular SEED_GATES of tests/test_accuracy.py (48 frames at
     192x256, scale-corrected ATE), rows 7-8 RGB-D and stereo (24 frames at
     96x128, unscaled ATE), each within its ATE bound, scale band and
     keyframe range, with tracking and terminate walls and each kernel's
     launches, by feature type (each row must launch corr_level and the
     split pair; the trajectory filler's lookups are corr_level launches
     too); row 1's terminate once more under torch.profiler, device
     activity only (device ms by kernel, busy share, the profile's cost);
     row 9 the cull replay of tests/test_engine_equivalence.py with the fixture
     weights on the GPU and the CPU: the same keyframes after every frame,
     at least one cull, poses within 5e-3;
  8. the host-driven engine, Droid(fused=False): (a) phase 5's frames at
     the bench configuration, whose lookups all read the f32 video
     features: corr_level_f32 launches equal to 4 x (probes + 16
     initialisation iterations + 6 per later keyframe), none in bf16; the
     tracking walls, 5 profiled frames (busy share beside phase 5's), one
     terminate() launching the split pair 4 x (7 + 12) x chunks times, then
     export_map into DIR/host_map and the consistent point cloud of the
     terminated video against the same from CPU copies (masks agreeing on
     >= 99.9% of the pixels, shared points within 1e-4 of their largest
     |p|); (b) the
     cull replay through the host engine on the card, the fused engine on
     the card and the host engine on the CPU: the same keyframes after
     every frame, at least one cull, poses within 5e-3; (c) phase 7's row 1
     through the host engine, inside the same gates;
  9. training: (a) run before phase 4, beside the other kernel checks
     (late in a run torch.profiler has dropped device events):
     corr_backward, the backward of the lookup (csrc/corr_backward.cu),
     against autograd through corr_level_ref at the training path's
     shapes (208 edges, 48x64 down to 6x8, C=128, f32)
     with iid (timed, with the plain version, its bound and autograd's
     backward of one F.grid_sample call over the same windows), smooth and
     far-out coords, bitwise on a second run, and no tensor-core
     instruction in its SASS; (b) one grad pass on a small seeded batch,
     card against CPU: the loss and every parameter's gradient within
     TRAIN_LOSS_TOL and TRAIN_GRAD_TOL; (c) apps/train.py's train loop at
     its defaults (384x512, 7 frames, 15 iterations, 52 edge slots, batch
     4) for 3 optimizer steps with a restart pass: finite losses and
     gradients, corr_level_f32 and corr_backward launches equal to their
     counts per pass, step walls, the last step's device time, busy share
     and the peak of allocated memory; (d) LEARN_STEPS steps on one clip
     cut the loss by LEARN_RATIO; (e) a saved train state restores bit for
     bit and its next step's loss and gradients match the uninterrupted
     step's.

It prints a `kernels` JSON line (corr_level, corr_slab and corr_window in
bf16, corr_level_f32, corr_slab_f32 and corr_backward), the card's name
and power limit, and as its last line {"ok": true, "device": {...}}.
With ``--out DIR`` the details go to DIR/chip_smoke.json and the profile
tables to DIR/*.txt.

Without a CUDA device, or without the droid_slam_tpu_torch package beside
it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
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

# ms per 4-level lookup of the first designs (corr_level, corr_slab: one
# warp per pixel, f32 FMA; corr_window: one thread per tap), on the inputs
# of phases 3 and 3b: constants, not measured by this run; taken by earlier
# versions of this script on an NVIDIA H100 80GB HBM3 at 700 W (the
# first-design column of PERF.md §6). bf16 features: corr_level (N=48) and
# corr_slab (N=256) with CUDA events; corr_window (N=256) the low end of its
# first design's runs, 0.3870-0.3896 ms (CUDA events, then profiler device
# time). float32 features, profiler device time, the low end of each range:
# corr_level_f32 at N=48 edges, P=1200, C=128, iid coords (0.5711-0.6800
# ms); corr_slab_f32 at N=256, same widths, iid (19.56-20.49 ms).
# Printed on a log line of their own beside this run's profiler times.
FIRST_DESIGN_MS = {"corr_level": 0.7206, "corr_slab": 10.6588, "corr_window": 0.3870,
                   "corr_level_f32": 0.5711, "corr_slab_f32": 19.56}

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


LOG_PATH = None  # --out DIR: every log line also goes to DIR/chip_smoke.log


def log(msg: str) -> None:
    print(msg, flush=True)
    if LOG_PATH is not None:
        with LOG_PATH.open("a") as f:
            f.write(msg + "\n")


def is_f32_function(name: str) -> bool:
    """The f32 band tiles (corr_tile_f32.cuh) and their sort, by name."""
    return "f32_kernel" in name or "corr_sort_kernel" in name


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
    every kernel fn launched, by torch.profiler, over one untimed call (the
    session's first launches carry its set-up) and reps timed calls. A
    profile must hold one kernel record for each kernel launch the host made
    (the profiler drops records now and then);
    and where the host queued the timed calls in under half of the span of
    two CUDA events around them, the device was the bottleneck and busy the
    whole span, so the profile must cover at least 0.7 of it. A profile that
    fails is taken again, twice; a third failure raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            queued_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            torch.cuda.synchronize()
        span_ms = start.elapsed_time(end)
        stats = prof.key_averages()
        device = [e for e in stats if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        ms = sum(e.self_device_time_total for e in device) / 1e3 / (reps + 1)
        records, launches = launch_records(
            (e.key, e.device_type == DeviceType.CUDA and not e.is_user_annotation, e.count) for e in stats)
        if ms > 0 and records >= launches and (queued_ms >= 0.5 * span_ms or ms * reps >= 0.7 * span_ms):
            return ms
        log(f"  torch.profiler: {records} kernel records for {launches} launches, {ms * reps:.4f} ms of "
            f"device time against {span_ms:.4f} ms of CUDA events (calls queued in {queued_ms:.4f} ms); "
            "profiling again")
    raise RuntimeError(f"torch.profiler failed its checks three times ({records} kernel records for "
                       f"{launches} launches, {ms * reps:.4f} ms against {span_ms:.4f} ms of CUDA events)")


def launch_records(events):
    """(kernel records on the device, kernel launches by the host) among
    (name, on the device, count) profiler events: the launches are the
    runtime and driver calls cudaLaunchKernel, cudaLaunchKernelExC,
    cuLaunchKernel and the like; memsets and copies count on neither side."""
    records = launches = 0
    for name, on_device, count in events:
        if on_device and not name.startswith(("Memset", "Memcpy")):
            records += count
        elif not on_device and "LaunchKernel" in name:
            launches += count
    return records, launches


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
    shapes (N=48, 30x40, C=128, all 4 levels) in bf16 and f32 with iid
    coords (timed, with the plain version), smooth coords (timed), far-out
    coords and the 384x512 levels (48x64 down to 6x8, timed), and the
    single-edge f32 probe (timed, with the plain version); every case runs
    twice and must repeat bitwise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w, C = 30, 40, 128
    fmap1 = torch.randn((N, h, w, C), generator=g, device=dev)
    fmap2 = torch.randn((N, h, w, C), generator=g, device=dev)
    # (the draws in the order of earlier versions of this script, so the
    # bf16 cases see the same inputs; f32 reuses the smooth, far and 384x512 ones)
    inputs = [("iid", dt, fmap1, fmap2, make_coords(torch, pops, "iid", N, h, w, g, dev))
              for dt in ("bfloat16", "float32")]
    for kind in ("smooth", "far"):
        c = make_coords(torch, pops, kind, N, h, w, g, dev)
        inputs += [(kind, dt, fmap1, fmap2, c) for dt in ("bfloat16", "float32")]
    H, W = 48, 64
    big = [torch.randn((n_big, H, W, C), generator=g, device=dev) for _ in range(2)]
    big_coords = make_coords(torch, pops, "iid", n_big, H, W, g, dev)
    inputs += [("iid_384x512", dt, *big, big_coords) for dt in ("bfloat16", "float32")]
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
            if kind != "far":
                case["ms"] = device_ms(torch, lambda: corr.corr_level(f1, f2, c), reps=50)
                case["event_ms"] = cuda_ms(torch, lambda: corr.corr_level(f1, f2, c), reps=50)
                nbytes, ops = corr_level_cost(torch, f1, f2, c)
                case.update(bytes=nbytes, ops=ops)
                case["bound_ms"], case["bound_by"] = bound(nbytes, ops, dtype)
                msg += (f" kernel {case['ms']:.4f} ms (events {case['event_ms']:.4f}) "
                        f"bound {case['bound_ms']:.4f} ms")
                if kind in ("iid", "probe"):
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


def f32_band_rows(torch, coords, h2, w2, tp, radius=3):
    """(computed, needed) pixel-rows of the f32 tile kernels for one level:
    per edge the pixels sorted as corr_sort_kernel sorts them (bin: window
    row, then column), tiles of tp consecutive sorted pixels, warps of 16;
    a warp multiplies a band row for all 16 of its pixels when one of them
    needs it (computed counts 16 per such warp-row), against the in-map
    window rows of every pixel (needed)."""
    n, p, _ = coords.shape
    rows = 2 * radius + 2
    x0 = torch.floor((coords[..., 0] - radius).clamp(-1e4, 1e4)).long()
    y0 = torch.floor((coords[..., 1] - radius).clamp(-1e4, 1e4)).long()
    ky = torch.where((y0 + rows - 1 >= 0) & (y0 < h2), y0 + rows - 1, h2 + rows - 1)
    kx = (x0 + rows - 1).clamp(0, w2 + rows - 1)
    order = torch.sort(ky * (w2 + rows) + kx, dim=1, stable=True).indices
    tiles = -(-p // tp)
    y0s = torch.full((n, tiles * tp), -(1 << 20), dtype=torch.long, device=coords.device)
    y0s[:, :p] = torch.gather(y0, 1, order)
    y0s = y0s.reshape(n, tiles, tp // 16, 16, 1)
    yy = torch.arange(h2, device=coords.device)
    need = (yy >= y0s) & (yy < y0s + rows)  # [n, tiles, warps, 16, H2]
    computed = 16 * int(need.any(-2).sum())
    in_map = y0[..., None] + torch.arange(rows, device=coords.device)
    needed = int(((in_map >= 0) & (in_map < h2)).sum())
    return computed, needed


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
    backend's chunk shapes (N=256, 30x40, C=128, all 4 levels) in bf16 and
    f32 with iid coords (timed, with corr_level on the same inputs: the
    fused-vs-split A/B), smooth (timed) and far-out coords, and the 384x512
    levels at N=32 (timed); every kernel runs twice per case and must
    repeat bitwise. Each timed f32 case counts the band rows the f32 tiles
    multiply against the rows its pixels need (f32_band_rows). Each timed
    case also times corr_window's library
    yardstick, one F.grid_sample call on the same slab, and gives its error
    against the plain version; counts the 32- and 64-byte sectors that
    corr_window must read; and times one sum() over the slab, the rate at
    which the card streams it."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    h, w, C = 30, 40, 128
    fmap1 = torch.randn((N, h, w, C), generator=g, device=dev)
    fmap2 = torch.randn((N, h, w, C), generator=g, device=dev)
    # (the draws in the order of earlier versions of this script, so the
    # bf16 cases see the same inputs; f32 reuses the smooth, far and 384x512 ones)
    inputs = [("iid", dt, fmap1, fmap2, make_coords(torch, pops, "iid", N, h, w, g, dev))
              for dt in ("bfloat16", "float32")]
    for kind in ("smooth", "far"):
        c = make_coords(torch, pops, kind, N, h, w, g, dev)
        inputs += [(kind, dt, fmap1, fmap2, c) for dt in ("bfloat16", "float32")]
    H, W = 48, 64
    big = [torch.randn((n_big, H, W, C), generator=g, device=dev) for _ in range(2)]
    big_coords = make_coords(torch, pops, "iid", n_big, H, W, g, dev)
    inputs += [("iid_384x512", dt, *big, big_coords) for dt in ("bfloat16", "float32")]
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
                if dtype == "float32":
                    tp = corr.corr_tile_plan_f32("corr_slab", f1.shape[0], f1.shape[1], f2.shape[2], C).tp
                    computed, needed = f32_band_rows(torch, c, f2.shape[1], f2.shape[2], tp)
                    case["band_rows"] = dict(computed=computed, needed=needed, tile=tp)
                    msg += f" band rows computed {computed} needed {needed} ({computed / needed:.3f}x);"
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


def bench_frames(torch, np, cfg, seed: int):
    """The bench configuration's inputs on the card: 28 seeded frames, cycled,
    and the intrinsics."""
    dev = torch.device("cuda")
    H, W = cfg.image_size
    rng = np.random.default_rng(seed)
    frames = [torch.from_numpy(rng.integers(0, 255, (H, W, 3), np.uint8)).to(dev) for _ in range(28)]
    return frames, torch.tensor([W * 1.2, W * 1.2, W / 2, H / 2], device=dev)


def timed_tracking(torch, kernels, droid, frames, intr, n_warm: int, n_timed: int):
    """Track n_warm frames, then n_timed timed ones, with the launch counts
    reset before; returns (frames tracked, warm-up s, timed s, launches by
    kernel, launches by kernel and feature type)."""
    torch.cuda.synchronize()
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
    return t, warm_s, elapsed, dict(kernels.LAUNCHES), dict(kernels.DTYPE_LAUNCHES)


def profile_tracking(torch, droid, frames, intr, t: int, fps: float, out_dir, name: str):
    """5 more frames from frame t under torch.profiler: device ms per frame
    by kernel, that of corr_level and of the segment sums, and the busy
    share against the unprofiled frame time of the timed window."""
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
        (out_dir / f"{name}.txt").write_text(events.table(sort_by="self_cuda_time_total", row_limit=40))
    # the kernel rows only, as the table's own footer sums device time
    kernel_us = {e.key: e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    dev_ms = sum(kernel_us.values()) / 1e3 / n_prof
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:8]
    seg_ms, seg_calls = range_ms(events, DeviceType, "segment_sum")
    return dict(
        frames=n_prof,
        profiled_wall_ms_per_frame=wall * 1e3 / n_prof,
        device_ms_per_frame=dev_ms,
        corr_level_ms_per_frame=sum(v for k, v in kernel_us.items() if "corr_level" in k) / 1e3 / n_prof,
        segment_sum_ms_per_frame=seg_ms / n_prof,
        segment_sum_calls_per_frame=seg_calls / n_prof,
        device_busy_share=dev_ms * fps / 1e3,
        top_kernels_ms_per_frame={k[:60]: v / 1e3 / n_prof for k, v in top},
    )


def main_path(torch, np, kernels, Droid, DroidConfig, init_params, seed: int, out_dir):
    """Phase 5: Droid.track at the bench configuration; returns the result
    and the Droid, which phase 6 terminates."""
    cfg = DroidConfig(**BENCH_CONFIG)
    droid = Droid(cfg, params=init_params(seed), device=torch.device("cuda"))
    frames, intr = bench_frames(torch, np, cfg, seed)
    n_timed = 30
    t, warm_s, elapsed, launches, dtype_launches = timed_tracking(
        torch, kernels, droid, frames, intr, cfg.warmup + 4, n_timed)

    poses, disps = droid.poses, droid.disps
    h, w = cfg.feat_size
    res = dict(
        frames=t, keyframes=droid.counter, fps=n_timed / elapsed, timed_s=elapsed,
        warmup_s=warm_s, launches=launches, dtype_launches=dtype_launches, n_edges=len(droid.edges),
        n_inactive=len(droid.inactive_edges),
        # probe on frames 1..warmup-1, 16 init iterations, then per frame
        # 1 probe + 4 + 2 iterations; 4 levels each
        expected_corr_launches=4 * ((cfg.warmup - 1) + 16 + 7 * (t - cfg.warmup)),
        # the probe, in f32 whatever the compute type, on every frame after the first
        expected_f32_launches=4 * (t - 1),
        finite=bool(torch.isfinite(poses).all() and torch.isfinite(disps).all()),
        shapes_ok=tuple(poses.shape) == (droid.counter, 7) and tuple(disps.shape) == (droid.counter, h, w),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    res["ok"] = bool(res["finite"] and res["shapes_ok"] and droid.counter == t
                     and launches["corr_level"] == res["expected_corr_launches"]
                     and dtype_launches.get("corr_level_f32") == res["expected_f32_launches"]
                     and dtype_launches.get("corr_level_bf16") == (res["expected_corr_launches"]
                                                                   - res["expected_f32_launches"]))
    log(f"  {res}")

    # device time by kernel over 5 more frames (after the counts were read)
    res["profile"] = profile_tracking(torch, droid, frames, intr, t, res["fps"], out_dir, "profile")
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
        launches.update(kernels.DTYPE_LAUNCHES)
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


WEIGHTS = ROOT / "weights" / "droid_synth.msgpack"
FIXTURE_WEIGHTS = ROOT / "weights" / "equivalence_fixture.msgpack"
# tests/test_accuracy.py::SEED_GATES (seed, compute dtype, bound on the
# scale-corrected ATE) for 48 rendered frames at 192x256, with its keyframe
# range [6, frames - 4] and fitted-scale band (0.25, 12)
SEED_GATES = [
    (7, "float32", 0.30),
    (11, "float32", 0.60),
    (23, "float32", 0.40),
    (5, "float32", 0.45),
    (42, "float32", 0.45),
    (11, "bfloat16", 0.45),
]
MONO_FRAMES, MONO_SIZE, MONO_KEYFRAMES, MONO_SCALE = 48, (192, 256), (6, 44), (0.25, 12.0)
# tests/test_accuracy.py:127-186: seed 7, 24 frames at 96x128, f32; bound on
# the unscaled ATE and the fitted-scale band per metric mode, keyframes in
# [6, frames - 2]
METRIC_GATES = {"rgbd": (0.15, (0.8, 1.25)), "stereo": (0.25, (0.7, 1.4))}
METRIC_FRAMES, METRIC_SIZE, METRIC_KEYFRAMES = 24, (96, 128), (6, 22)
# tests/test_engine_equivalence.py:149-195: the cull replay with the
# equivalence fixture's weights (wide decision margins)
CULL_FRAMES = 26
CULL_CONFIG = dict(
    image_size=(96, 128),
    buffer=32,
    warmup=8,
    max_factors=48,
    inactive_pad=64,
    window_pad=32,
    schur_pair_floor=1024,
    filter_thresh=-1.0,  # every frame appended: the culls are the decisions
    keyframe_thresh=2.0,
    frontend_window=16,
    frontend_thresh=16.0,
    compute_dtype="float32",
)


def protocol_rows():
    """Phase 7's rows 1-8: (mode, seed, compute dtype, ATE bound)."""
    cases = [("mono", seed, dtype, bound) for seed, dtype, bound in SEED_GATES]
    return cases + [(mode, 7, "float32", gate[0]) for mode, gate in METRIC_GATES.items()]


def protocol_row(torch, np, kernels, evaluate, DroidConfig, k: int, fused: bool = True):
    """Phase 7's row k (1-8) through run_slam with the fused engine, or with
    the host-driven one (phase 8c), with the launch counts reset before it
    and read after it. Returns (the row's result, the Droid, the fill
    stream)."""
    mode, seed, dtype, bound = protocol_rows()[k - 1]
    mono = mode == "mono"
    frames, size = (MONO_FRAMES, MONO_SIZE) if mono else (METRIC_FRAMES, METRIC_SIZE)
    track, fill, ref = evaluate.synthetic_streams(seed, frames, size, stereo=mode == "stereo",
                                                  rgbd=mode == "rgbd")
    config = DroidConfig(image_size=size, buffer=96 if mono else 64, warmup=8,
                         stereo=mode == "stereo", compute_dtype=dtype)
    torch.cuda.synchronize()
    kernels.reset_launches()
    traj, droid, walls = evaluate.run_slam(config, str(WEIGHTS), track, fill, device="cuda", fused=fused)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    dtype_launches = dict(kernels.DTYPE_LAUNCHES)  # by feature type
    tstamps = np.arange(frames, dtype=np.float64)
    scaled = evaluate.score(ref, tstamps, traj, correct_scale=True)
    # mono is scored scale-corrected; the metric modes unscaled, with the
    # fitted scale of the scale-corrected fit in its band
    ate = scaled if mono else evaluate.score(ref, tstamps, traj, correct_scale=False)
    kf_lo, kf_hi = MONO_KEYFRAMES if mono else METRIC_KEYFRAMES
    s_lo, s_hi = MONO_SCALE if mono else METRIC_GATES[mode][1]
    row = dict(row=k, engine="fused" if fused else "host", mode=mode, seed=seed, dtype=dtype, frames=frames,
               image_size=list(size),
               ate=ate["ate_rmse"], ate_bound=bound, scale_corrected=mono, scale=scaled["scale"],
               scale_band=[s_lo, s_hi], keyframes=droid.counter, keyframe_range=[kf_lo, kf_hi],
               track_s=walls["track_s"], terminate_s=walls["terminate_s"], launches=launches,
               dtype_launches=dtype_launches, finite=bool(np.isfinite(traj).all()))
    row["ok"] = bool(row["finite"] and ate["ate_rmse"] < bound and s_lo < scaled["scale"] < s_hi
                     and kf_lo <= droid.counter <= kf_hi and launches["corr_level"] > 0
                     and launches["corr_slab"] > 0 and launches["corr_window"] > 0)
    by_type = " ".join(f"{name} {n}" for name, n in sorted(dtype_launches.items()))
    log(f"  row {k} {row['engine']} {mode:6s} seed {seed:2d} {dtype:8s}: ATE {row['ate']:.4f} "
        f"({'scale-corrected' if mono else 'unscaled'}, bound {bound}), scale {row['scale']:.4f} "
        f"(band {s_lo}-{s_hi}), keyframes {droid.counter}/{frames}, tracking {walls['track_s']:.2f} s, "
        f"terminate {walls['terminate_s']:.2f} s, launches corr_level {launches['corr_level']} "
        f"corr_slab {launches['corr_slab']} corr_window {launches['corr_window']} ({by_type}): "
        f"{'ok' if row['ok'] else 'FAILED'}")
    return row, droid, fill


def profile_terminate(torch, droid, fill, wall_s: float, out_dir, name: str):
    """One more terminate(fill) of a phase 7 row's Droid under
    torch.profiler, recording device activity only: device ms and launches
    by kernel, summed from the profiler's raw events (an f32 terminate with
    TF32 off launches ~3e5 kernels, and building the profiler's own event
    tree for them, with host ops beside, takes over a minute), and the busy
    share of the profiled run. cost_s is what the profile adds to phase 7:
    the profiled terminate and the reading of its events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        droid.terminate(iter(fill))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us, calls = {}, {}
    for e in prof.profiler.kineto_results.events():
        # kernels, copies and sets (the profiler's own overhead is a host event)
        if e.device_type() == DeviceType.CUDA:
            key = e.name()
            us[key] = us.get(key, 0.0) + e.duration_ns() / 1e3
            calls[key] = calls.get(key, 0) + 1
    if not us:
        raise RuntimeError("torch.profiler recorded no device time")
    ranked = sorted(us, key=lambda k: -us[k])
    if out_dir is not None:
        lines = [f"{'device ms':>12}  {'calls':>8}  kernel"]
        lines += [f"{us[k] / 1e3:12.3f}  {calls[k]:8d}  {k}" for k in ranked[:40]]
        (out_dir / f"{name}.txt").write_text("\n".join(lines) + "\n")
    dev_ms = sum(us.values()) / 1e3

    def ms(needle):
        return sum(v for k, v in us.items() if needle in k) / 1e3

    return dict(
        profiled_wall_ms=wall * 1e3, device_ms=dev_ms, device_busy_share=dev_ms / (wall * 1e3),
        row_terminate_wall_ms=wall_s * 1e3, launches=sum(calls.values()),
        corr_slab_ms=ms("corr_slab"), corr_window_ms=ms("corr_window"), corr_sort_ms=ms("corr_sort"),
        top_kernels_ms={k[:60]: us[k] / 1e3 for k in ranked[:12]},
        cost_s=time.perf_counter() - t_start,
    )


def synthetic_protocol(torch, np, kernels, evaluate, DroidConfig, render_sequence, Droid, out_dir):
    """Phase 7: the synthetic protocol with the shipped weights, through
    apps/evaluate.py's run_slam, rows 1-6 monocular (SEED_GATES), rows 7-8
    RGB-D and stereo; the launch counts are reset before each row and read
    after it; row 1's terminate runs once more under torch.profiler. Row 9:
    the cull replay on the GPU and on the CPU, with the keyframe timestamps
    after every frame."""
    rows = []
    for k in range(1, len(protocol_rows()) + 1):
        row, droid, fill = protocol_row(torch, np, kernels, evaluate, DroidConfig, k)
        if k == 1:
            row["terminate_profile"] = profile_terminate(torch, droid, fill, row["terminate_s"], out_dir,
                                                         "profile_row1_terminate")
            log(f"  row 1 terminate profile: {row['terminate_profile']}")
        rows.append(row)
        del droid

    # row 9: the same cull decisions on the card and on the CPU
    seq = render_sequence(np.random.default_rng(7), n_frames=CULL_FRAMES, image_size=CULL_CONFIG["image_size"],
                          t_sigma=0.25, r_sigma=0.02)
    runs = {}
    for device in ("cuda", "cpu"):
        d = Droid(DroidConfig(**CULL_CONFIG), weights=str(FIXTURE_WEIGHTS), device=device)
        hist = []
        t0 = time.perf_counter()
        for t in range(CULL_FRAMES):
            d.track(t, seq["images"][t], intrinsics=seq["intrinsics"][t])
            hist.append(d.tstamps.tolist())
        runs[device] = dict(hist=hist, poses=d.poses.cpu().numpy(), wall_s=time.perf_counter() - t0)
    gpu, cpu = runs["cuda"], runs["cpu"]
    flip = next((t for t in range(CULL_FRAMES) if gpu["hist"][t] != cpu["hist"][t]), None)
    same = flip is None
    cull = dict(
        row=9, keyframes=len(gpu["hist"][-1]), keyframes_cpu=len(cpu["hist"][-1]),
        tstamps=gpu["hist"][-1], same_keyframes=same,
        # the first frame after which the devices hold different keyframes
        first_flip=None if same else dict(frame=flip, gpu=gpu["hist"][flip], cpu=cpu["hist"][flip]),
        pose_err=float(np.abs(gpu["poses"] - cpu["poses"]).max()) if same else None,
        gpu_wall_s=gpu["wall_s"], cpu_wall_s=cpu["wall_s"],
    )
    cull["ok"] = bool(same and cull["keyframes"] < CULL_FRAMES and cull["pose_err"] < 5e-3)
    log(f"  row 9 cull replay (fixture weights, {CULL_FRAMES} frames, 96x128): {cull}")
    return dict(rows=rows, cull=cull)


def host_engine_path(torch, np, kernels, Droid, DroidConfig, init_params, visualization, seed: int,
                     out_dir, fused_busy_share: float):
    """Phase 8a: Droid(fused=False) at the bench configuration over phase
    5's frames: the launch counts of the 42 tracked frames (every lookup of
    the host engine reads the f32 video features), 5 more frames under
    torch.profiler, one terminate() (the split pair), then export_map and
    the consistent point cloud of the terminated video on the card against
    the same on CPU copies."""
    import tempfile
    from types import SimpleNamespace

    cfg = DroidConfig(**BENCH_CONFIG)
    droid = Droid(cfg, params=init_params(seed), device=torch.device("cuda"), fused=False)
    frames, intr = bench_frames(torch, np, cfg, seed)
    n_timed = 30
    t, warm_s, elapsed, launches, dtype_launches = timed_tracking(
        torch, kernels, droid, frames, intr, cfg.warmup + 4, n_timed)
    # the probe on every frame after the first, 16 initialisation
    # iterations, 4 + 2 per keyframe after the warmup (no cull); 4 levels each
    lookups = (t - 1) + 16 + (cfg.frontend_iters1 + cfg.frontend_iters2) * (t - cfg.warmup)
    res = dict(
        frames=t, keyframes=droid.counter, fps=n_timed / elapsed, timed_s=elapsed, warmup_s=warm_s,
        launches=launches, dtype_launches=dtype_launches, n_edges=len(droid.edges),
        n_inactive=len(droid.inactive_edges), expected_f32_launches=4 * lookups,
        finite=bool(torch.isfinite(droid.poses).all() and torch.isfinite(droid.disps).all()),
    )
    res["tracking_ok"] = bool(res["finite"] and droid.counter == t
                              and launches["corr_level"] == res["expected_f32_launches"]
                              and dtype_launches.get("corr_level_f32") == res["expected_f32_launches"]
                              and "corr_level_bf16" not in dtype_launches)
    log(f"  tracking: {res}")
    res["profile"] = profile_tracking(torch, droid, frames, intr, t, res["fps"], out_dir, "profile_host")
    log(f"  profile: {res['profile']}; device busy share {res['profile']['device_busy_share']:.3f} "
        f"(fused engine, phase 5: {fused_busy_share:.3f})")

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = droid.terminate()
    torch.cuda.synchronize()
    steps_x_chunks = sum(steps * chunks for steps, (_, chunks) in zip((7, 12), droid.backend_runs))
    term = dict(wall_s=time.perf_counter() - t0, keyframes=droid.counter, backend_runs=droid.backend_runs,
                launches={**kernels.LAUNCHES, **kernels.DTYPE_LAUNCHES},
                expected_split_launches=4 * steps_x_chunks, finite=bool(np.isfinite(traj).all()))
    term["ok"] = bool(term["finite"] and traj.shape == (droid.counter, 7) and steps_x_chunks > 0
                      and term["launches"]["corr_slab"] == term["launches"]["corr_window"]
                      == term["expected_split_launches"])
    res["terminate"] = term
    log(f"  terminate: {term}")

    # the map: export, then the same point cloud from CPU copies of the video
    v = droid.video
    map_dir = Path(out_dir if out_dir is not None else tempfile.mkdtemp()) / "host_map"
    t0 = time.perf_counter()
    n_points = visualization.export_map(v, str(map_dir))
    export_s = time.perf_counter() - t0
    gp, gc, gm = visualization.consistent_points(v)
    cpu_video = SimpleNamespace(counter=v.counter, poses=v.poses.cpu(), disps=v.disps.cpu(),
                                intrinsics=v.intrinsics.cpu(), images=v.images.cpu())
    cp, cc, cm = visualization.consistent_points(cpu_video)
    shared = gm & cm
    # the kept points' scale (a pixel of tiny disparity back-projects far out)
    scale = float(np.abs(cp[shared]).max()) if shared.any() else 0.0
    vis = dict(points=n_points, export_s=export_s, pixels=int(gm.size), kept_gpu=int(gm.sum()),
               kept_cpu=int(cm.sum()), mask_agreement=float((gm == cm).mean()),
               point_err=float(np.abs(gp[shared] - cp[shared]).max()) if shared.any() else 0.0,
               point_tol=1e-4 * scale, colors_equal=bool(np.array_equal(gc, cc)),
               files=sorted(p.name for p in map_dir.iterdir()))
    vis["ok"] = bool(n_points == vis["kept_gpu"] and vis["mask_agreement"] >= 0.999
                     and vis["point_err"] <= vis["point_tol"] and vis["colors_equal"]
                     and vis["files"] == ["map.ply", "poses_c2w.npy"]
                     and np.load(map_dir / "poses_c2w.npy").shape == (v.counter, 7))
    res["map"] = vis
    log(f"  map: {vis}")
    res["ok"] = bool(res["tracking_ok"] and term["ok"] and vis["ok"])
    return res


def host_cull_replay(torch, np, Droid, DroidConfig, render_sequence):
    """Phase 8b: the cull replay of tests/test_engine_equivalence.py:149-195
    through the host engine on the card, the fused engine on the card and
    the host engine on the CPU: the same keyframes after every frame, at
    least one cull, poses within 5e-3 of the first run's."""
    seq = render_sequence(np.random.default_rng(7), n_frames=CULL_FRAMES, image_size=CULL_CONFIG["image_size"],
                          t_sigma=0.25, r_sigma=0.02)
    runs = {}
    for name, device, fused in (("host_gpu", "cuda", False), ("fused_gpu", "cuda", True),
                                ("host_cpu", "cpu", False)):
        d = Droid(DroidConfig(**CULL_CONFIG), weights=str(FIXTURE_WEIGHTS), device=device, fused=fused)
        hist = []
        t0 = time.perf_counter()
        for t in range(CULL_FRAMES):
            d.track(t, seq["images"][t], intrinsics=seq["intrinsics"][t])
            hist.append(d.tstamps.tolist())
        runs[name] = dict(hist=hist, poses=d.poses.cpu().numpy(), wall_s=time.perf_counter() - t0)
    ref = runs["host_gpu"]
    res = dict(keyframes=len(ref["hist"][-1]), tstamps=ref["hist"][-1],
               walls_s={k: r["wall_s"] for k, r in runs.items()}, first_flip={}, pose_err={})
    for name in ("fused_gpu", "host_cpu"):
        flip = next((t for t in range(CULL_FRAMES) if runs[name]["hist"][t] != ref["hist"][t]), None)
        res["first_flip"][name] = None if flip is None else dict(
            frame=flip, host_gpu=ref["hist"][flip], other=runs[name]["hist"][flip])
        if flip is None:
            res["pose_err"][name] = float(np.abs(runs[name]["poses"] - ref["poses"]).max())
    res["same_keyframes"] = all(f is None for f in res["first_flip"].values())
    res["ok"] = bool(res["same_keyframes"] and res["keyframes"] < CULL_FRAMES
                     and all(e < 5e-3 for e in res["pose_err"].values()))
    log(f"  cull replay (fixture weights, {CULL_FRAMES} frames, 96x128): {res}")
    return res


def host_engine(torch, np, kernels, Droid, DroidConfig, init_params, visualization, evaluate,
                render_sequence, seed: int, out_dir, fused_busy_share: float, row1_keyframes: int):
    """Phase 8: the host-driven engine. 8a at the bench configuration, 8b
    the cull replay, 8c phase 7's row 1 through the host engine."""
    log("phase 8a: host engine at the bench configuration")
    bench = host_engine_path(torch, np, kernels, Droid, DroidConfig, init_params, visualization, seed,
                             out_dir, fused_busy_share)
    log("phase 8b: cull replay, host engine (card, CPU) and fused engine (card)")
    cull = host_cull_replay(torch, np, Droid, DroidConfig, render_sequence)
    log("phase 8c: protocol row 1 through the host engine")
    row, droid, _ = protocol_row(torch, np, kernels, evaluate, DroidConfig, 1, fused=False)
    del droid
    log(f"  keyframes {row['keyframes']} (fused engine, phase 7 row 1: {row1_keyframes})")
    return dict(bench=bench, cull=cull, row1=row, ok=bench["ok"] and cull["ok"] and row["ok"])


# -----------------------------------------------------------------------------
# phase 9: training
# -----------------------------------------------------------------------------

# 9b, card against CPU after one grad pass (3 iterations of operator and BA,
# which amplify one-ulp differences, as in phase 4): the loss within 1e-4
# relative; each gradient tensor's largest difference within 1e-2 of the
# larger of its largest entry and 1e-3 of the model's largest entry (the
# biases ahead of fnet's instance norms have a zero true gradient, and both
# devices return rounding noise there)
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-2
# 9c: apps/train.py's defaults (fnet 128, cnet 256, GRU 128, 4 levels of
# radius 3, crop 384x512, 7 frames, 15 iterations, 24 random edges in 52
# slots, batch 4) for 3 optimizer steps; --seed 0 draws one restart pass (on
# step 2, a randomised graph) and both kinds of graph
TRAIN_ARGV = ["--synthetic", "--steps", "3", "--seed", "0", "--ckpt_every", "1000000"]
TRAIN_POOL = 4  # clips rendered ahead (the app's default, 256 at 384x512, renders for minutes)
# 9d-e: overfitting one clip (4 frames at 48x64, batch 2, 4 iterations,
# lr 1e-3 on a 60-step onecycle), the criterion of tests/test_training.py
LEARN_STEPS = 30
LEARN_RATIO = 0.5  # mean loss of the last 3 steps over the first 3
# 9e: the step after a restore against the uninterrupted one: the loss
# within 1e-6 relative, each gradient tensor within 1e-3 in 9b's form
# (cuDNN's backward may sum in its own order). The parameters after the
# update are reported, not held: AdamW's m/√v turns the rounding noise of
# a gradient that is zero in exact arithmetic (fnet's biases ahead of its
# instance norms) into steps of up to the learning rate
RESUME_LOSS_TOL = 1e-6
RESUME_GRAD_TOL = 1e-3


def corr_backward_cost(torch, f1, f2, coords, radius=3):
    """Bytes the backward must move (g, f1, f2 and coords read once, df1
    and df2 written once) and the operations these inputs need: 2·C for
    df1 and 2·C for df2 per in-map support cell, plus 8 per tap for the
    support gradient (4 corner products and sums)."""
    n, p, c = f1.shape
    rd = 2 * radius + 1
    nbytes = (n * p * rd * rd * 4 + coords.numel() * 4
              + 2 * (f1.numel() * f1.element_size() + f2.numel() * f2.element_size()))
    _, fwd_ops = corr_level_cost(torch, f1, f2, coords, radius)
    dots = (fwd_ops - 12 * n * p * rd * rd) // (2 * c)
    return nbytes, 4 * c * dots + 8 * n * p * rd * rd


def grid_sample_backward(torch, corr, f1, f2, coords, gout, radius=3):
    """The library yardstick of the backward: autograd's backward of one
    F.grid_sample call (bilinear, zeros padding, align_corners=False) that
    samples the same windows from the level's volume [N·P, 1, H2, W2]: tap
    (i, j) at x = c_x − r + i, y = c_y − r + j, pixel x at (2x + 1)/W2 − 1.
    Returns (device ms of the backward, max |forward − corr_level_ref|,
    max |corr_level_ref|)."""
    n, p, c = f1.shape
    h2, w2 = f2.shape[1:3]
    vol = torch.bmm(f1, f2.reshape(n, h2 * w2, c).transpose(1, 2)).reshape(n * p, 1, h2, w2)
    vol.requires_grad_()
    c0 = coords.reshape(n * p, 2) - radius
    off = torch.arange(2 * radius + 1, device=f1.device, dtype=torch.float32)
    x = c0[:, 0][:, None, None] + off[None, :, None]  # [N·P, 7(i), 1]
    y = c0[:, 1][:, None, None] + off[None, None, :]  # [N·P, 1, 7(j)]
    grid = torch.stack(torch.broadcast_tensors((2 * x + 1) / w2 - 1, (2 * y + 1) / h2 - 1), -1)
    out = grid_sample(torch, vol, grid.contiguous())
    with torch.no_grad():
        ref = corr.corr_level_ref(f1, f2, coords, radius)
        err = float((out.detach().reshape(n, p, -1) - ref).abs().max())
        scale = float(ref.abs().max())
    go = gout.reshape(n * p, 1, 2 * radius + 1, 2 * radius + 1)
    ms = device_ms(torch, lambda: torch.autograd.grad(out, vol, go, retain_graph=True), reps=3, warm=1)
    return ms, err, scale


def check_backward_kernel(torch, corr, pops, dev, seed: int, N: int = 208, h: int = 48, w: int = 64):
    """Phase 9a: corr_level_backward (csrc/corr_backward.cu, then df2 =
    dVᵀ·f1) against autograd through corr_level_ref at the training path's
    shapes (208 edges = batch 4 x 52 slots, 48x64 down to 6x8, C=128, f32)
    with iid (timed, with the plain version, the grid_sample yardstick and
    the bound), smooth and far-out coords; each case runs twice and must
    repeat bitwise."""
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    C = 128
    fmap1 = torch.randn((N, h, w, C), generator=g, device=dev)
    fmap2 = torch.randn((N, h, w, C), generator=g, device=dev)
    cases = []
    for kind in ("iid", "smooth", "far"):
        coords = make_coords(torch, pops, kind, N, h, w, g, dev)
        for lvl, (f1, f2, c) in enumerate(corr.lookup_levels(fmap1, fmap2, coords)):
            gout = torch.randn((N, f1.shape[1], 49), generator=g, device=dev)
            refs = corr.corr_level_backward_ref(gout, f1, f2, c)
            outs = corr.corr_level_backward(gout, f1, f2, c)
            outs2 = corr.corr_level_backward(gout, f1, f2, c)
            torch.cuda.synchronize()
            res = {name: compare(torch, o, o2, r) for name, o, o2, r in zip(("df1", "df2"), outs, outs2, refs)}
            del refs, outs, outs2
            case = dict(kind=kind, level=lvl, N=N, P=f1.shape[1], H2=f2.shape[1], W2=f2.shape[2], C=C,
                        max_abs_err={k: r[0] for k, r in res.items()},
                        max_abs_ref={k: r[1] for k, r in res.items()},
                        bitwise_repeat=all(r[3] for r in res.values()),
                        launches=-(-N // corr.backward_chunk_edges(f1.shape[1], f2.shape[1], f2.shape[2])))
            case["ok"] = all(r[2] and r[3] and r[0] <= KERNEL_TOL * r[1] for r in res.values())
            msg = (f"  corr_backward {kind:6s} L{lvl} [{N},{f1.shape[1]},{C}]x[{f2.shape[1]}x{f2.shape[2]}]: "
                   + ", ".join(f"{k} max_err {r[0]:.3e} (tol {KERNEL_TOL * r[1]:.3e})" for k, r in res.items())
                   + f", {case['launches']} launches, repeat {'bitwise' if case['bitwise_repeat'] else 'DIFFERS'}")
            if kind == "iid":
                case["ms"] = device_ms(torch, lambda: corr.corr_level_backward(gout, f1, f2, c), reps=5)
                case["plain_ms"] = device_ms(torch, lambda: corr.corr_level_backward_ref(gout, f1, f2, c),
                                             reps=2, warm=1)
                case["library_ms"], case["grid_sample_err"], scale = grid_sample_backward(
                    torch, corr, f1, f2, c, gout)
                case["grid_sample_ok"] = case["grid_sample_err"] <= KERNEL_TOL * scale
                nbytes, ops = corr_backward_cost(torch, f1, f2, c)
                case.update(bytes=nbytes, ops=ops)
                case["bound_ms"], case["bound_by"] = bound(nbytes, ops, "float32")
                msg += (f" kernel {case['ms']:.4f} ms plain "
                        f"{case['plain_ms']:.4f} ms bound "
                        f"{case['bound_ms']:.4f} ms ({case['bound_by']}), grid_sample backward "
                        f"{case['library_ms']:.4f} ms (forward max_err {case['grid_sample_err']:.2e})")
            cases.append(case)
            log(msg)
            torch.cuda.empty_cache()
    return cases


def _grads_against(torch, got, want):
    """(worst ratio, tensor name): max |got − want| of each gradient tensor
    over the larger of its largest |want| and 1e-3 of the model's largest."""
    G = max(float(v.abs().max()) for v in want.values())
    worst = max(((float((got[k].to(v.device) - v).abs().max()) / max(float(v.abs().max()), 1e-3 * G), k)
                 for k, v in want.items()), default=(0.0, None))
    return worst


def train_card_vs_cpu(torch, np, port, seed: int):
    """Phase 9b: one grad pass of the trainer on the same seeded batch and
    weights on the card (the kernels) and on the CPU (the plain versions):
    a rendered clip, batch 2, 4 frames at 64x96, 3 iterations, a padded
    randomised graph, per-frame distinct initial poses (as a restart pass
    starts; with two frames at one pose the flow encoder's first ReLU gates
    on rounding noise)."""
    F, H, W, B, iters = 4, 64, 96, 2, 3
    clip = next(port.SyntheticDataset(n_frames=F, image_size=(H, W), seed=seed, pool=0).clips(B))
    Ps = port.lie.inv(torch.from_numpy(clip["poses"]))
    Gs0 = Ps.clone()
    Gs0[:, 1:] = Ps[:, 1:2]
    tw = 0.02 * np.random.default_rng(seed).standard_normal((B, F, 6)).astype(np.float32)
    Gs0 = port.lie.retr(Gs0, torch.from_numpy(tw))
    bi, bj = port.train_app.neighbour_graph(F)
    ii, jj, valid = port.train_app.pad_graph(bi[::2], bj[::2], len(bi[::2]) + 2)
    batch = dict(images=clip["images"], poses=Ps.numpy(), disps=clip["disps"], intrinsics=clip["intrinsics"],
                 poses_init=Gs0.numpy(), disps_init=np.ones((B, F, H // 8, W // 8), np.float32),
                 ii=ii, jj=jj, edge_valid=valid)
    step = port.trainer.make_train_step(port.trainer.TrainConfig(n_frames=F, num_iters=iters), bi, bj)
    runs = {}
    for device in ("cuda", "cpu"):
        model = port.DroidNet()
        model.load_state_dict(port.init_params(seed))
        model.to(torch.device(device))
        port.kernels.reset_launches()
        t0 = time.perf_counter()
        grads, metrics, _ = step.grad(model, batch)
        torch.cuda.synchronize()
        runs[device] = dict(grads={k: v.cpu() for k, v in grads.items()},
                            metrics={k: float(v) for k, v in metrics.items()}, wall_s=time.perf_counter() - t0,
                            launches=dict(port.kernels.DTYPE_LAUNCHES))
    gpu, cpu = runs["cuda"], runs["cpu"]
    loss_err = abs(gpu["metrics"]["loss"] - cpu["metrics"]["loss"]) / abs(cpu["metrics"]["loss"])
    worst, name = _grads_against(torch, gpu["grads"], cpu["grads"])
    res = dict(loss_gpu=gpu["metrics"]["loss"], loss_cpu=cpu["metrics"]["loss"], loss_rel_err=loss_err,
               loss_tol=TRAIN_LOSS_TOL, worst_grad=worst, worst_grad_tensor=name, grad_tol=TRAIN_GRAD_TOL,
               metric_errs={k: abs(gpu["metrics"][k] - v) for k, v in cpu["metrics"].items()},
               walls_s={k: r["wall_s"] for k, r in runs.items()}, launches_gpu=gpu["launches"],
               launches_cpu=cpu["launches"],
               finite=all(bool(torch.isfinite(v).all()) for r in runs.values() for v in r["grads"].values()))
    res["ok"] = bool(res["finite"] and loss_err <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL
                     and gpu["launches"].get("corr_backward_f32", 0) > 0 and not cpu["launches"])
    log(f"  card vs CPU: {res}")
    return res


def profile_events(torch, prof, out_dir, name: str):
    """Device ms and launches by kernel from a device-only torch.profiler
    run (the raw events, as profile_terminate reads them)."""
    from torch.autograd import DeviceType

    us, calls = {}, {}
    events = prof.profiler.kineto_results.events()
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            us[e.name()] = us.get(e.name(), 0.0) + e.duration_ns() / 1e3
            calls[e.name()] = calls.get(e.name(), 0) + 1
    if not us:
        raise RuntimeError("torch.profiler recorded no device time")
    records, launches = launch_records((e.name(), e.device_type() == DeviceType.CUDA, 1) for e in events)
    ranked = sorted(us, key=lambda k: -us[k])
    if out_dir is not None:
        lines = [f"{'device ms':>12}  {'calls':>8}  kernel"]
        lines += [f"{us[k] / 1e3:12.3f}  {calls[k]:8d}  {k}" for k in ranked[:40]]
        (out_dir / f"{name}.txt").write_text("\n".join(lines) + "\n")

    def ms(*needles):
        return sum(v for k, v in us.items() if any(s in k for s in needles)) / 1e3

    # a profile short of kernel records (dropped) reads too little device time
    return dict(device_ms=sum(us.values()) / 1e3, launches=sum(calls.values()),
                kernel_records=records, kernel_launches=launches, complete=records >= launches > 0,
                corr_level_ms=ms("corr_level_f32"), corr_sort_ms=ms("corr_sort"),
                corr_backward_ms=ms("corr_backward"), gemm_ms=ms("gemm", "sgemm"),
                fft_conv_ms=ms("cf32cf32", "fft"), conv_ms=ms("conv", "implicit", "wgrad", "dgrad"),
                top_kernels_ms={k[:60]: us[k] / 1e3 for k in ranked[:12]})


def train_at_defaults(torch, np, port, seed: int, out_dir):
    """Phase 9c: apps/train.py's train loop at its defaults (TRAIN_ARGV) for
    3 optimizer steps on a SyntheticDataset with a pool of TRAIN_POOL clips:
    every loss and gradient finite, the launches of corr_level_f32 (4 levels
    x 15 iterations x passes) and of the backward kernel (15 iterations x
    passes x its chunks over the 4 levels); the checkpointed operator and
    BA recompute no lookup. Step walls, the last step's device time under
    torch.profiler (device activity only), held against two CUDA events
    around that step (it cannot exceed their span), its busy share against
    that span and against the warm unprofiled steps' wall per pass (the
    profiler slows the host), and the peak of allocated memory."""
    from torch.profiler import ProfilerActivity, profile

    args = port.train_app.parser().parse_args(TRAIN_ARGV)
    t0 = time.perf_counter()
    db = port.SyntheticDataset(n_frames=args.n_frames, image_size=tuple(args.crop), seed=seed,
                               pool=TRAIN_POOL, varied_frac=args.varied_frac)
    clips = db.clips(args.batch)
    first = next(clips)  # renders the pool
    render_s = time.perf_counter() - t0

    class Clips:
        def clips(self, batch):
            yield first
            yield from clips

    prof = profile(activities=[ProfilerActivity.CUDA])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    @contextlib.contextmanager
    def profiled(step):
        if step < args.steps:
            yield
            return
        torch.cuda.synchronize()
        with prof:
            start.record()
            yield
            end.record()
            end.synchronize()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    port.kernels.reset_launches()
    t0 = time.perf_counter()
    hist = port.train_app._train(args, Clips(), torch.device("cuda"), log=log, step_context=profiled)
    wall = time.perf_counter() - t0
    launches = dict(port.kernels.DTYPE_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    passes = sum(h["passes"] for h in hist)
    h, w = args.crop[0] // 8, args.crop[1] // 8
    n_slots = args.batch * max(len(port.train_app.neighbour_graph(args.n_frames)[0]),
                               args.edges + 4 * args.n_frames)
    chunks = sum(-(-n_slots // port.corr.backward_chunk_edges(h * w, h >> l, w >> l)) for l in range(4))
    res = dict(steps=len(hist), passes=passes, render_s=render_s, wall_s=wall,
               step_walls_s=[x["wall_s"] for x in hist], losses=[x["metrics"]["loss"] for x in hist],
               n_valid_edges=[x["n_valid_edges"] for x in hist], launches=launches,
               expected_corr_level_f32=4 * args.iters * passes,
               expected_corr_backward=args.iters * passes * chunks, backward_chunks_per_lookup=chunks,
               peak_allocated_gb=peak_gb, tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                                                    cudnn=torch.backends.cudnn.allow_tf32))
    pr = res["profile"] = profile_events(torch, prof, out_dir, "profile_train_step")
    pr["profiled_step_wall_ms"] = hist[-1]["wall_s"] * 1e3
    pr["profiled_step_events_ms"] = start.elapsed_time(end)
    pr["device_busy_share"] = pr["device_ms"] / pr["profiled_step_events_ms"]
    # steps 2 .. n-1: warm (cuDNN's first calls are in step 1) and unprofiled
    warm = hist[1:-1]
    pr["warm_pass_wall_ms"] = pr["device_busy_share_warm"] = None
    if warm:
        pr["warm_pass_wall_ms"] = 1e3 * sum(x["wall_s"] for x in warm) / sum(x["passes"] for x in warm)
        pr["device_busy_share_warm"] = pr["device_ms"] / hist[-1]["passes"] / pr["warm_pass_wall_ms"]
    res["finite"] = all(x["grads_finite"] and np.isfinite(list(x["metrics"].values())).all() for x in hist)
    res["ok"] = bool(res["finite"] and len(hist) == args.steps and passes > len(hist)
                     and pr["device_ms"] <= pr["profiled_step_events_ms"]
                     and launches.get("corr_level_f32") == res["expected_corr_level_f32"]
                     and launches.get("corr_backward_f32") == res["expected_corr_backward"]
                     and not launches.get("corr_level_bf16"))
    log(f"  defaults: {res}")
    return res


def train_learns_and_resumes(torch, np, port, seed: int, out_dir):
    """Phase 9d: LEARN_STEPS steps overfitting one rendered clip must cut
    the loss by LEARN_RATIO (mean of the last 3 against the first 3);
    9e: the train state saved before the last step, restored into a fresh
    model and optimizer, is the saved one bit for bit, and its step's loss
    and gradients match the uninterrupted step's within RESUME_LOSS_TOL and
    RESUME_GRAD_TOL."""
    import tempfile

    F, H, W, B = 4, 48, 64, 2
    clip = next(port.SyntheticDataset(n_frames=F, image_size=(H, W), seed=3, pool=0).clips(B))
    Ps = port.lie.inv(torch.from_numpy(clip["poses"])).numpy()
    Gs0 = Ps.copy()
    Gs0[:, 1:] = Ps[:, 1:2]
    batch = dict(images=clip["images"], poses=Ps, disps=clip["disps"], intrinsics=clip["intrinsics"],
                 poses_init=Gs0, disps_init=np.ones((B, F, H // 8, W // 8), np.float32))
    cfg = port.trainer.TrainConfig(lr=1e-3, steps=2 * LEARN_STEPS, n_frames=F, num_iters=4, pct_start=0.2)
    ii, jj = port.train_app.neighbour_graph(F)
    step = port.trainer.make_train_step(cfg, ii, jj)

    def fresh():
        model = port.DroidNet()
        model.load_state_dict(port.init_params(seed))
        return port.trainer.init_state(model.to(torch.device("cuda")), cfg)

    state, losses = fresh(), []
    t0 = time.perf_counter()
    for _ in range(LEARN_STEPS - 1):
        state, m, _ = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    tmp = Path(tempfile.mkdtemp()) if out_dir is None else out_dir
    path = str(tmp / "train_state.pt")
    port.checkpoints.save_train_state(path, state)
    lr = state["optimizer"].schedule(state["optimizer"].count)
    restored = port.checkpoints.restore_train_state(path, fresh())
    params = [(a, b) for a, b in zip(state["model"].state_dict().values(), restored["model"].state_dict().values())]
    same_params = all(torch.equal(a, b) for a, b in params)
    sa, sb = state["optimizer"].state_dict(), restored["optimizer"].state_dict()
    same_opt = sa["count"] == sb["count"] and all(
        torch.equal(sa["adamw"]["state"][k][n], sb["adamw"]["state"][k][n])
        for k in sa["adamw"]["state"] for n in ("exp_avg", "exp_avg_sq", "step"))
    grads_a, m_a, _ = step.grad(state["model"], batch)
    grads_b, m_b, _ = step.grad(restored["model"], batch)
    worst, name = _grads_against(torch, grads_b, grads_a)
    bitwise_grads = all(torch.equal(grads_a[k], grads_b[k]) for k in grads_a)
    before = [a.clone() for a, _ in params]
    step.apply(state, grads_a)
    step.apply(restored, grads_b)
    losses.append(float(m_a["loss"]))
    moved = max(float((a - p0).abs().max()) for (a, _), p0 in zip(params, before))
    param_diff = max(float((a - b).abs().max()) for a, b in params)
    learn = dict(losses=losses, learn_s=learn_s, ratio=float(np.mean(losses[-3:]) / np.mean(losses[:3])),
                 criterion=LEARN_RATIO)
    learn["ok"] = bool(np.isfinite(losses).all() and learn["ratio"] <= LEARN_RATIO)
    resume = dict(same_params=same_params, same_optimizer_state=same_opt, same_step=restored["step"] == state["step"],
                  loss_a=float(m_a["loss"]), loss_b=float(m_b["loss"]),
                  loss_rel_err=abs(float(m_a["loss"]) - float(m_b["loss"])) / abs(float(m_a["loss"])),
                  worst_grad=worst, worst_grad_tensor=name, grad_tol=RESUME_GRAD_TOL, bitwise_grads=bitwise_grads,
                  lr=lr, largest_update=moved, param_diff_after_update=param_diff,
                  param_diff_in_lr=param_diff / lr)
    resume["ok"] = bool(same_params and same_opt and resume["same_step"]
                        and resume["loss_rel_err"] <= RESUME_LOSS_TOL and worst <= RESUME_GRAD_TOL)
    log(f"  learns: ratio {learn['ratio']:.4f} (criterion <= {LEARN_RATIO}) in {learn_s:.1f} s; "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"  resume: {resume}")
    return learn, resume


def training(torch, np, port, seed: int, out_dir):
    """Phase 9: the training path (9b-9e; 9a runs beside the other kernel
    checks, before phase 4)."""
    log("phase 9b: one grad pass, card vs CPU")
    vs_cpu = train_card_vs_cpu(torch, np, port, seed)
    log("phase 9c: apps/train.py at its defaults, 3 optimizer steps")
    defaults = train_at_defaults(torch, np, port, seed, out_dir)
    log(f"phase 9d-e: {LEARN_STEPS} steps on one clip, then a save, restore and step")
    learn, resume = train_learns_and_resumes(torch, np, port, seed, out_dir)
    return dict(card_vs_cpu=vs_cpu, defaults=defaults, learns=learn, resume=resume)


def main(argv=None) -> int:
    global LOG_PATH
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
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        LOG_PATH = args.out / "chip_smoke.log"
        LOG_PATH.write_text("")
    sys.path.insert(0, str(ROOT))
    from types import SimpleNamespace

    from droid_slam_tpu_torch.apps import evaluate
    from droid_slam_tpu_torch.apps import train as train_app
    from droid_slam_tpu_torch.data.synthetic import SyntheticDataset, render_sequence
    from droid_slam_tpu_torch.models.droid_net import DroidNet, init_params
    from droid_slam_tpu_torch.ops import corr, kernels, lie, segment
    from droid_slam_tpu_torch.ops import projective as pops
    from droid_slam_tpu_torch.runtime import Droid, DroidConfig
    from droid_slam_tpu_torch.train import checkpoints, trainer
    from droid_slam_tpu_torch.utils import visualization

    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    log("phase 1: TF32 off")
    tf32_defaults = dict(matmul=torch.backends.cuda.matmul.allow_tf32, cudnn=torch.backends.cudnn.allow_tf32)
    log(f"  PyTorch's defaults: matmul.allow_tf32={tf32_defaults['matmul']} "
        f"cudnn.allow_tf32={tf32_defaults['cudnn']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    log("phase 2: build kernels")
    t0 = time.perf_counter()
    build_logs = kernels.build()
    build_s = time.perf_counter() - t0
    for name, text in build_logs.items():
        func = ""
        for line in text.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                func = line.split()[-1].strip("'")
            elif "registers" in line or "spill" in line or "smem" in line:
                # the f32 functions by name (the bf16 ones as before, by line)
                tag = f" {func}" if is_f32_function(func) or "corr_backward" in func else ""
                log(f"  {name}:{tag} {line.strip()}")
    log(f"  built {sorted(build_logs) or 'nothing (cached)'} in {build_s:.1f} s")
    sass = kernels.sass_counts()
    for func, counts in sorted(sass.items()):
        log(f"  sass {func}: " + ", ".join(f"{op} {k}" for op, k in counts.items()))
    # the bf16 instantiations must run on the tensor cores, the f32 ones
    # (and their sort) on the CUDA cores only
    tile_mma = {f: sum(c.values()) for f, c in sass.items() if "tile_kernel" in f}
    f32_mma = {f: sum(c.values()) for f, c in sass.items() if is_f32_function(f)}

    log("phase 3: kernels vs plain versions at main-path shapes")
    cases = check_kernels(torch, corr, pops, dev, args.seed)

    log("phase 3b: split pair vs plain versions at backend shapes")
    split_cases = check_split_kernels(torch, corr, pops, dev, args.seed)

    log("phase 3c: order-fixed segment sums vs index_add_ at the paths' shapes")
    seg_cases = check_segment_sum(torch, segment, dev, args.seed)

    # with the other kernel checks: late in the run torch.profiler has come
    # back with some or none of the device events of these launches
    log("phase 9a: corr_backward vs autograd through corr_level_ref at the training path's shapes")
    t0 = time.perf_counter()
    bwd_cases = check_backward_kernel(torch, corr, pops, dev, args.seed)
    bwd_wall = time.perf_counter() - t0

    log("phase 4: small replay + terminate, GPU port vs CPU port")
    small = small_replay(torch, np, Droid, DroidConfig, init_params, args.seed)

    log("phase 5: main path, Droid.track at the bench configuration")
    main_res, droid = main_path(torch, np, kernels, Droid, DroidConfig, init_params, args.seed, args.out)

    log("phase 6: terminate path, Droid.terminate() at the bench configuration")
    term_res = terminate_path(torch, np, kernels, droid, args.out)
    del droid

    log("phase 7: synthetic protocol with the shipped weights")
    t0 = time.perf_counter()
    proto = synthetic_protocol(torch, np, kernels, evaluate, DroidConfig, render_sequence, Droid, args.out)
    proto["wall_s"] = time.perf_counter() - t0

    log("phase 8: host-driven engine, Droid(fused=False)")
    t0 = time.perf_counter()
    host = host_engine(torch, np, kernels, Droid, DroidConfig, init_params, visualization, evaluate,
                       render_sequence, args.seed, args.out, main_res["profile"]["device_busy_share"],
                       proto["rows"][0]["keyframes"])
    host["wall_s"] = time.perf_counter() - t0

    log("phase 9: training")
    t0 = time.perf_counter()
    port = SimpleNamespace(corr=corr, pops=pops, kernels=kernels, lie=lie, trainer=trainer,
                           checkpoints=checkpoints, train_app=train_app, SyntheticDataset=SyntheticDataset,
                           DroidNet=DroidNet, init_params=init_params)
    train = training(torch, np, port, args.seed, args.out)
    train["wall_s"] = time.perf_counter() - t0 + bwd_wall
    train["backward_cases"] = bwd_cases
    log(f"  phase 9 wall: {train['wall_s']:.1f} s (9a {bwd_wall:.1f} s)")

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
    # the f32 tiles: corr_level at N=48 and corr_slab at N=256, iid, 4
    # levels, with phase 7 row 1's f32 launches (an f32 row of the protocol)
    row1 = proto["rows"][0]
    f32_level = [c for c in cases if c["dtype"] == "float32" and c["kind"] == "iid"]
    f32_split = [c for c in split_cases if c["dtype"] == "float32" and c["kind"] == "iid"]
    f32_sets = (
        ("corr_level_f32", "corr_level.cu", 80, f32_level, lambda c: c["bytes"], lambda c: c["ops"],
         lambda c: c["ms"], lambda c: c["plain_ms"], lambda c: c["bound_ms"],
         max(c["max_abs_err"] for c in cases if c["dtype"] == "float32")),
        ("corr_slab_f32", "corr_split.cu", 170, f32_split,
         lambda c: c["kernels"]["corr_slab"]["bytes"], lambda c: c["kernels"]["corr_slab"]["ops"],
         lambda c: c["ms"]["corr_slab"], lambda c: c["plain_ms"]["corr_slab"],
         lambda c: c["kernels"]["corr_slab"]["bound_ms"],
         max(c["max_abs_err"]["corr_slab"] for c in split_cases if c["dtype"] == "float32")),
    )
    for name, source, line, sel, nbytes, ops, ms, plain, bnd, err in f32_sets:
        k_bytes = sum(nbytes(c) / MEM_BYTES_PER_S for c in sel)
        k_ops = sum(ops(c) / PEAK_OPS_PER_S["float32"] for c in sel)
        kernel_rows.append(share(dict(
            name=name,
            route="cuda",
            source=f"droid_slam_tpu_torch/csrc/{source}",
            replaces=f"droid_slam_tpu/ops/pallas_corr.py:{line}",
            launches=row1["dtype_launches"].get(name, 0),
            max_abs_err=err,
            ms=sum(ms(c) for c in sel),
            plain_ms=sum(plain(c) for c in sel),
            bound_ms=sum(bnd(c) for c in sel),
            bound_by="bytes" if k_bytes >= k_ops else "operations",
            library_ms=None,
        )))
    # the backward of the lookup: one training-path lookup's backward, the 4
    # levels at 208 edges, iid, f32, with phase 9c's launches
    bwd_iid = [c for c in train["backward_cases"] if c["kind"] == "iid"]
    b_bytes = sum(c["bytes"] / MEM_BYTES_PER_S for c in bwd_iid)
    b_ops = sum(c["ops"] / PEAK_OPS_PER_S["float32"] for c in bwd_iid)
    kernel_rows.append(share(dict(
        name="corr_backward",
        route="cuda",
        source="droid_slam_tpu_torch/csrc/corr_backward.cu",
        replaces="droid_slam_tpu/ops/corr.py:135 (no Pallas counterpart: XLA autodiff of corr_index)",
        launches=train["defaults"]["launches"].get("corr_backward_f32", 0),
        max_abs_err=max(max(c["max_abs_err"].values()) for c in train["backward_cases"]),
        ms=sum(c["ms"] for c in bwd_iid),
        plain_ms=sum(c["plain_ms"] for c in bwd_iid),
        bound_ms=sum(c["bound_ms"] for c in bwd_iid),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        library_ms=sum(c["library_ms"] for c in bwd_iid),
    )))
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(dict(
            device=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__,
            tf32_defaults=tf32_defaults,
            build_s=build_s, sass=sass, cases=cases, split_cases=split_cases, segment_cases=seg_cases,
            small_replay=small,
            main_path=main_res, terminate_path=term_res, synthetic_protocol=proto, host_engine=host,
            training=train, kernels=kernel_rows,
        ), indent=1))

    failed = [f"{f}: no tensor-core instructions" for f, k in tile_mma.items() if k == 0]
    # 2 kernels x C in (32, 64, 128, 256) x 1, 2, 4 or 8 n8 tiles per chunk
    if len(tile_mma) != 32:
        failed.append(f"expected 32 bf16 tile instantiations in the SASS, found {len(tile_mma)}")
    failed += [f"{f}: {k} tensor-core instructions in an f32 function" for f, k in f32_mma.items() if k]
    # 2 kernels x C in (32, 64, 128, 256), and the sort (one name in both libraries)
    n_f32 = sum("f32_kernel" in f for f in f32_mma)
    if n_f32 != 8 or len(f32_mma) != 9:
        failed.append(f"expected 8 f32 tile instantiations and the sort in the SASS, found {sorted(f32_mma)}")
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
    for name in ("corr_level_f32", "corr_slab_f32"):
        row = next(r for r in kernel_rows if r["name"] == name)
        if row["launches"] == 0:
            failed.append(f"{name}: no launch in phase 7 row 1")
    slab32 = next(r for r in kernel_rows if r["name"] == "corr_slab_f32")
    if slab32["ms"] > slab32["plain_ms"]:
        failed.append(f"corr_slab_f32 {slab32['ms']:.4f} ms is slower than its plain version "
                      f"{slab32['plain_ms']:.4f} ms (iid, N=256, 4 levels)")
    failed += [f"segment_sum {c['name']}" for c in seg_cases if not c["ok"]]
    if not main_res["ok"]:
        failed.append("main path")
    if not term_res["ok"]:
        failed.append("terminate path")
    failed += [f"synthetic row {r['row']} {r['mode']} seed {r['seed']} {r['dtype']}"
               for r in proto["rows"] if not r["ok"]]
    if not proto["cull"]["ok"]:
        failed.append(f"synthetic row 9 cull replay: {proto['cull']}")
    failed += [f"host engine {part}" for part, ok in (
        ("8a tracking", host["bench"]["tracking_ok"]), ("8a terminate", host["bench"]["terminate"]["ok"]),
        ("8a map", host["bench"]["map"]["ok"]), ("8b cull replay", host["cull"]["ok"]),
        ("8c row 1", host["row1"]["ok"])) if not ok]
    failed += [f"corr_backward {c['kind']} L{c['level']}" for c in train["backward_cases"] if not c["ok"]]
    failed += [f"grid_sample backward yardstick L{c['level']}: forward max_err {c['grid_sample_err']:.3e}"
               for c in bwd_iid if not c["grid_sample_ok"]]
    failed += [f"corr_backward_kernel: {k} tensor-core instructions" for f, k in
               ((f, sum(c.values())) for f, c in sass.items() if "corr_backward_kernel" in f) if k]
    if not any("corr_backward_kernel" in f for f in sass):
        failed.append("corr_backward_kernel missing from the SASS")
    failed += [f"training {part}" for part in ("card_vs_cpu", "defaults", "learns", "resume")
               if not train[part]["ok"]]
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
    log(f"synthetic protocol: {len(proto['rows'])} rows and the cull replay passed in "
        f"{proto['wall_s']:.1f} s; ATE " + ", ".join(f"{r['mode']} {r['seed']} {r['dtype']} {r['ate']:.4f}"
                                                   for r in proto["rows"]))
    for row in kernel_rows:
        if row["name"] in FIRST_DESIGN_MS:
            log(f"{row['name']}: {row['ms']:.4f} ms in this run (profiler); first design "
                f"{FIRST_DESIGN_MS[row['name']]} ms (a constant from earlier runs)")
    log(f"f32 launches of phase 7 row 1 (mono seed 7, f32): {row1['dtype_launches']}; "
        f"phase 5 (bf16 tracking, f32 probe): {main_res['dtype_launches']}")
    hb, hterm, hrow = host["bench"], host["bench"]["terminate"], host["row1"]
    log(f"host engine (phase 8, {host['wall_s']:.1f} s): {hb['fps']:.2f} frames/s (fused {main_res['fps']:.2f}), "
        f"device busy {hb['profile']['device_busy_share']:.3f} (fused "
        f"{main_res['profile']['device_busy_share']:.3f}), corr_level_f32 launches "
        f"{hb['dtype_launches'].get('corr_level_f32')}; terminate {hterm['wall_s']:.3f} s, corr_slab/corr_window "
        f"{hterm['launches']['corr_slab']}/{hterm['launches']['corr_window']}; map {hb['map']['points']} points, "
        f"masks agree {hb['map']['mask_agreement']:.5f}; cull replay {host['cull']['keyframes']} keyframes "
        f"on all three runs; row 1 ATE {hrow['ate']:.4f}, keyframes {hrow['keyframes']} "
        f"(fused {row1['keyframes']})")
    td, tl = train["defaults"], train["learns"]
    log(f"training (phase 9, {train['wall_s']:.1f} s): corr_backward {kernel_rows[-1]['ms']:.4f} ms per "
        f"4-level backward at 208 edges (plain {kernel_rows[-1]['plain_ms']:.4f}, bound "
        f"{kernel_rows[-1]['bound_ms']:.4f}, grid_sample backward {kernel_rows[-1]['library_ms']:.4f}); "
        f"card vs CPU loss rel err {train['card_vs_cpu']['loss_rel_err']:.2e}, worst gradient "
        f"{train['card_vs_cpu']['worst_grad']:.2e}; defaults: {td['passes']} passes in {td['steps']} steps, "
        f"step walls {', '.join(f'{x:.2f}' for x in td['step_walls_s'])} s, profiled step "
        f"{td['profile']['device_ms']:.0f} ms of device time in {td['profile']['profiled_step_events_ms']:.0f} ms "
        f"of CUDA events (busy {td['profile']['device_busy_share']:.3f}; "
        f"{td['profile']['device_busy_share_warm'] or float('nan'):.3f} of a warm unprofiled pass; "
        f"{td['profile']['kernel_records']} kernel records for {td['profile']['kernel_launches']} launches), "
        f"peak {td['peak_allocated_gb']:.2f} GB, launches corr_level_f32 "
        f"{td['launches'].get('corr_level_f32')} corr_backward {td['launches'].get('corr_backward_f32')}; "
        f"learns: loss {tl['losses'][0]:.3f} -> {tl['losses'][-1]:.3f} (ratio {tl['ratio']:.3f}); "
        f"resume: bitwise state, step loss rel err {train['resume']['loss_rel_err']:.1e}")
    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
