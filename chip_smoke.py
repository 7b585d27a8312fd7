#!/usr/bin/env python3
"""Smoke run of the PyTorch port (droid_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out DIR]

Phases, each of which fails the run:
  1. float32 matmuls and convolutions without TF32;
  2. build every hand-written CUDA kernel from droid_slam_tpu_torch/csrc;
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes (48 edges, 30x40 features, C=128, all 4 pyramid levels, bf16 and
     f32 inputs, plus the single-edge f32 probe), and time both;
  4. track 8 seeded 64x64 RGB-D frames on the GPU and on the CPU (plain
     versions) with the same seeded weights: same keyframes and edge sets,
     poses within 5e-3 and disparities within 1e-2 (with random weights a
     monocular replay can flip a per-pixel depth-validity mask on one-ulp
     differences, and CUDA's atomic sums vary at that level run to run;
     the depth prior keeps the pixels off those thresholds);
  5. drive the main path, Droid.track, at the bench configuration (240x320,
     buffer 64, 48 edge slots, every frame a keyframe, bfloat16 compute):
     warmup+4 frames, then 30 timed frames; the kernel launch counts of
     this phase show the path went through the kernels. Then 5 more frames
     under torch.profiler give device time per frame by kernel.

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
    runs = {}
    for device in ("cuda", "cpu"):
        d = Droid(DroidConfig(**SMALL_CONFIG), params=params, device=device)
        for t, (img, depth) in enumerate(frames):
            d.track(t, img, depth=depth, intrinsics=intr)
        runs[device] = d
    gpu, cpu = runs["cuda"], runs["cpu"]
    dp = float((gpu.poses.cpu() - cpu.poses).abs().max())
    dd = float((gpu.disps.cpu() - cpu.disps).abs().max())
    res = dict(
        keyframes=gpu.counter, same_keyframes=gpu.counter == cpu.counter,
        same_edges=gpu.edges == cpu.edges and gpu.inactive_edges == cpu.inactive_edges,
        n_edges=len(gpu.edges), n_inactive=len(gpu.inactive_edges),
        pose_err=dp, disp_err=dd,
    )
    res["ok"] = bool(res["same_keyframes"] and res["same_edges"] and dp < 5e-3 and dd < 1e-2)
    log(f"  {res}")
    return res


def main_path(torch, np, kernels, Droid, DroidConfig, init_params, seed: int, out_dir):
    """Phase 5: Droid.track at the bench configuration."""
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
                     and all(n > 0 for n in launches.values()))
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
    return res


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

    log("phase 4: small replay, GPU port vs CPU port")
    small = small_replay(torch, np, Droid, DroidConfig, init_params, args.seed)

    log("phase 5: main path, Droid.track at the bench configuration")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    main_res = main_path(torch, np, kernels, Droid, DroidConfig, init_params, args.seed, args.out)

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

    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(dict(
            device=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__,
            build_s=build_s, cases=cases, small_replay=small, main_path=main_res,
            kernels=kernel_rows,
        ), indent=1))

    failed = [f"corr_level {c['dtype']} L{c['level']} N={c['N']}" for c in cases if not c["ok"]]
    if not small["ok"]:
        failed.append("small replay")
    if not main_res["ok"]:
        failed.append("main path")
    if failed:
        print("chip_smoke: FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1

    log(f"main path: {main_res['fps']:.2f} frames/s, {main_res['keyframes']} keyframes, "
        f"corr_level launches {main_res['launches']['corr_level']}")
    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
