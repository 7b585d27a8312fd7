#!/usr/bin/env python3
"""Smoke run of the PyTorch port (droid_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out DIR]

Phases, each of which fails the run:
  1. float32 matmuls and convolutions without TF32;
  2. build every hand-written CUDA kernel from droid_slam_tpu_torch/csrc;
  3. hold corr_level against its plain PyTorch version at the tracking
     path's shapes (48 edges, 30x40 features, C=128, all 4 pyramid levels,
     bf16 and f32 inputs, plus the single-edge f32 probe), and time both;
  3b. hold the split pair (corr_slab, corr_window) against its plain
     versions at the backend's shapes (one chunk of 256 edges, same
     widths, all 4 levels, bf16 and f32), and time both, with corr_level's
     time on the same inputs beside them (the fused-vs-split A/B);
  4. track 8 seeded 64x64 RGB-D frames on the GPU and on the CPU (plain
     versions) with the same seeded weights, then terminate() and
     terminate(stream) on both: same keyframes and edge sets, poses within
     5e-3 and disparities within 1e-2 after tracking, trajectories within
     5e-3 after terminate (with random weights a monocular replay can flip
     a per-pixel depth-validity mask on one-ulp differences, and CUDA's
     atomic sums vary at that level run to run; the depth prior keeps the
     pixels off those thresholds);
  5. drive the tracking path, Droid.track, at the bench configuration
     (240x320, buffer 64, 48 edge slots, every frame a keyframe, bfloat16
     compute): warmup+4 frames, then 30 timed frames; the kernel launch
     counts of this phase show the path went through corr_level. Then 5
     more frames under torch.profiler give device time per frame by kernel;
  6. drive the terminate path, Droid.terminate(), on phase 5's Droid (47
     keyframes) twice, as bench.py does; the launch counts of each show it
     went through the split pair, 4 levels x 19 global-BA steps x the
     update-operator chunks. Then one more terminate under torch.profiler.

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
    """Mean device time of fn over reps back-to-back calls (CUDA events)."""
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


def check_kernels(torch, corr, pops, dev, seed: int):
    """Phase 3: corr_level against corr_level_ref at the main-path shapes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    N, h, w, C = 48, 30, 40, 128
    fmap1 = torch.randn((N, h, w, C), generator=g, device=dev)
    fmap2 = torch.randn((N, h, w, C), generator=g, device=dev)
    # reprojected coords: the pixel grid plus motion, some off the map
    coords = pops.coords_grid(h, w, device=dev) + 3.0 * torch.randn((N, h, w, 2), generator=g, device=dev)
    cases = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        levels = corr.lookup_levels(fmap1.to(dt), fmap2.to(dt), coords)
        for lvl, (f1, f2, c) in enumerate(levels):
            ref = corr.corr_level_ref(f1, f2, c)
            out = corr.corr_level(f1, f2, c)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            err = float((out - ref).abs().max())
            finite = bool(torch.isfinite(out).all())
            ms = cuda_ms(torch, lambda: corr.corr_level(f1, f2, c), reps=50)
            plain_ms = cuda_ms(torch, lambda: corr.corr_level_ref(f1, f2, c), reps=5, warm=1)
            nbytes, ops = corr_level_cost(torch, f1, f2, c)
            t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
            cases.append(dict(
                dtype=dtype, level=lvl, N=N, P=h * w, H2=f2.shape[1], W2=f2.shape[2], C=C,
                max_abs_err=err, max_abs_ref=scale, tol=KERNEL_TOL * scale,
                ok=finite and err <= KERNEL_TOL * scale,
                ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            ))
            log(f"  corr_level {dtype:8s} L{lvl} [{N},{h * w},{C}]x[{f2.shape[1]}x{f2.shape[2]}]: "
                f"max_err {err:.3e} (tol {KERNEL_TOL * scale:.3e}) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms bound {max(t_bytes, t_ops):.4f} ms")
    # the motion-filter probe: one edge, f32 features, identity coords
    probe1 = torch.randn((1, h, w, C), generator=g, device=dev)
    probe2 = torch.randn((1, h, w, C), generator=g, device=dev)
    for lvl, (f1, f2, c) in enumerate(corr.lookup_levels(probe1, probe2, pops.coords_grid(h, w, device=dev)[None])):
        ref = corr.corr_level_ref(f1, f2, c)
        out = corr.corr_level(f1, f2, c)
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        ok = bool(torch.isfinite(out).all()) and err <= KERNEL_TOL * scale
        cases.append(dict(dtype="float32", level=lvl, N=1, P=h * w, probe=True,
                          max_abs_err=err, tol=KERNEL_TOL * scale, ok=ok))
        log(f"  corr_level probe    L{lvl}: max_err {err:.3e} (tol {KERNEL_TOL * scale:.3e})")
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


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_split_kernels(torch, corr, pops, dev, seed: int):
    """Phase 3b: corr_slab + corr_window against their plain versions at the
    backend's chunk shapes; corr_level timed on the same inputs."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    N, h, w, C = 256, 30, 40, 128
    fmap1 = torch.randn((N, h, w, C), generator=g, device=dev)
    fmap2 = torch.randn((N, h, w, C), generator=g, device=dev)
    coords = pops.coords_grid(h, w, device=dev) + 3.0 * torch.randn((N, h, w, 2), generator=g, device=dev)
    cases = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for lvl, (f1, f2, c) in enumerate(corr.lookup_levels(fmap1.to(dt), fmap2.to(dt), coords)):
            slab_ref = corr.corr_slab_ref(f1, f2, c)
            ref = corr.corr_window_ref(slab_ref, c)
            slab = corr.corr_slab(f1, f2, c)
            win = corr.corr_window(slab_ref, c)
            out = corr.corr_level_split(f1, f2, c)
            torch.cuda.synchronize()
            errs = dict(
                corr_slab=float((slab - slab_ref).abs().max()),
                corr_window=float((win - ref).abs().max()),
                split=float((out - ref).abs().max()),
            )
            scales = dict(corr_slab=float(slab_ref.abs().max()), corr_window=float(ref.abs().max()),
                          split=float(ref.abs().max()))
            finite = all(bool(torch.isfinite(t).all()) for t in (slab, win, out))
            ok = finite and all(errs[k] <= KERNEL_TOL * scales[k] for k in errs)
            del slab, win, out
            ms = dict(
                corr_slab=cuda_ms(torch, lambda: corr.corr_slab(f1, f2, c), reps=20),
                corr_window=cuda_ms(torch, lambda: corr.corr_window(slab_ref, c), reps=20),
            )
            plain_ms = dict(
                corr_slab=cuda_ms(torch, lambda: corr.corr_slab_ref(f1, f2, c), reps=3, warm=1),
                corr_window=cuda_ms(torch, lambda: corr.corr_window_ref(slab_ref, c), reps=3, warm=1),
            )
            fused_ms = cuda_ms(torch, lambda: corr.corr_level(f1, f2, c), reps=20)
            fused_bound, _ = bound(*corr_level_cost(torch, f1, f2, c), dtype)
            costs = split_cost(torch, f1, f2, c)
            case = dict(dtype=dtype, level=lvl, N=N, P=h * w, H2=f2.shape[1], W2=f2.shape[2], C=C,
                        max_abs_err=errs, max_abs_ref=scales, tol=KERNEL_TOL * scales["split"], ok=ok,
                        ms=ms, plain_ms=plain_ms, corr_level_ms=fused_ms,
                        corr_level_bound_ms=fused_bound, kernels={})
            for name, (nbytes, ops) in costs.items():
                b_ms, b_by = bound(nbytes, ops, dtype if name == "corr_slab" else "float32")
                case["kernels"][name] = dict(bytes=nbytes, ops=ops, bound_ms=b_ms, bound_by=b_by)
            cases.append(case)
            split_bound = sum(k["bound_ms"] for k in case["kernels"].values())
            log(f"  split {dtype:8s} L{lvl} [{N},{h * w},{C}]x[{f2.shape[1]}x{f2.shape[2]}]: "
                f"max_err slab {errs['corr_slab']:.3e} window {errs['corr_window']:.3e} "
                f"pair {errs['split']:.3e} (tol {KERNEL_TOL * scales['split']:.3e}) "
                f"slab {ms['corr_slab']:.4f} + window {ms['corr_window']:.4f} ms "
                f"(plain {plain_ms['corr_slab']:.4f} + {plain_ms['corr_window']:.4f} ms, "
                f"bound {split_bound:.4f} ms); corr_level {fused_ms:.4f} ms (bound {fused_bound:.4f} ms)")
            del slab_ref, ref
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
                     and launches["corr_level"] > 0)
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
    res["profile"] = dict(
        frames=n_prof,
        profiled_wall_ms_per_frame=wall * 1e3 / n_prof,
        device_ms_per_frame=dev_ms,
        corr_level_ms_per_frame=sum(v for k, v in kernel_us.items() if "corr_level_kernel" in k) / 1e3 / n_prof,
        # against the unprofiled frame time of the timed window
        device_busy_share=dev_ms * res["fps"] / 1e3,
        top_kernels_ms_per_frame={k[:60]: v / 1e3 / n_prof for k, v in top},
    )
    log(f"  profile: {res['profile']}")
    return res, droid


def kernel_ms(events, DeviceType, needle: str) -> float:
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and needle in e.key) / 1e3


def terminate_path(torch, np, kernels, droid, out_dir):
    """Phase 6: Droid.terminate() twice on phase 5's Droid, then once more
    under torch.profiler."""
    runs = []
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
    profile_res = dict(
        profiled_wall_ms=wall * 1e3, device_ms=dev_ms,
        corr_slab_ms=kernel_ms(events, DeviceType, "corr_slab_kernel"),
        corr_window_ms=kernel_ms(events, DeviceType, "corr_window_kernel"),
        device_busy_share=dev_ms / (runs[-1]["wall_s"] * 1e3),
        top_kernels_ms={k[:60]: v / 1e3 for k, v in top},
    )
    log(f"  profile: {profile_res}")
    return dict(runs=runs, profile=profile_res, keyframes=droid.counter,
                ok=all(r["ok"] for r in runs))


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
    from droid_slam_tpu_torch.ops import corr, kernels
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

    log("phase 3: kernels vs plain versions at main-path shapes")
    cases = check_kernels(torch, corr, pops, dev, args.seed)

    log("phase 3b: split pair vs plain versions at backend shapes")
    split_cases = check_split_kernels(torch, corr, pops, dev, args.seed)

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

    main_cases = [c for c in cases if c["dtype"] == "bfloat16" and not c.get("probe")]
    bound_bytes = sum(c["bytes"] / MEM_BYTES_PER_S for c in main_cases)
    bound_ops = sum(c["ops"] / PEAK_OPS_PER_S["bfloat16"] for c in main_cases)
    kernel_rows = [dict(
        name="corr_level",
        route="cuda",
        source="droid_slam_tpu_torch/csrc/corr_level.cu",
        replaces="droid_slam_tpu/ops/pallas_corr.py:80",
        launches=main_res["launches"]["corr_level"],
        max_abs_err=max(c["max_abs_err"] for c in cases),
        # one main-path lookup: the 4 levels at N=48, bf16 features
        ms=sum(c["ms"] for c in main_cases),
        plain_ms=sum(c["plain_ms"] for c in main_cases),
        bound_ms=sum(c["bound_ms"] for c in main_cases),
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        library_ms=None,
    )]
    # the split pair: one backend chunk lookup, the 4 levels at N=256, bf16
    split_bf16 = [c for c in split_cases if c["dtype"] == "bfloat16"]
    for name, line in (("corr_slab", 170), ("corr_window", 212)):
        k_bytes = sum(c["kernels"][name]["bytes"] / MEM_BYTES_PER_S for c in split_bf16)
        k_ops = sum(c["kernels"][name]["ops"] / PEAK_OPS_PER_S["bfloat16" if name == "corr_slab" else "float32"]
                    for c in split_bf16)
        kernel_rows.append(dict(
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
            library_ms=None,
        ))

    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(dict(
            device=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__,
            build_s=build_s, cases=cases, split_cases=split_cases, small_replay=small,
            main_path=main_res, terminate_path=term_res, kernels=kernel_rows,
        ), indent=1))

    failed = [f"corr_level {c['dtype']} L{c['level']} N={c['N']}" for c in cases if not c["ok"]]
    if not small["ok"]:
        failed.append("small replay")
    failed += [f"split pair {c['dtype']} L{c['level']}" for c in split_cases if not c["ok"]]
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
        f"corr_slab/corr_window launches {first['corr_slab']}/{first['corr_window']}")
    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
