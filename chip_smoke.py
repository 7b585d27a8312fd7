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
  3d. hold the tracking step's flight-recorder kernels (trace_begin,
     trace_stamp, trace_count in csrc/graph_cond.cu) against their plain
     versions (utils/profiling.py's CPU path) on a [64, 53] ring with a
     48-slot mask: cursor, rows, tstamp bits and count exactly equal,
     stamps non-decreasing; then the 50 recorder launches of one step
     captured and replayed (a row per replay), each kernel timed;
  3e. hold the tracking step's depth Schur complement over the occupied
     cells (csrc/schur_window.cu, ops/ba.py::window_schur) against its
     plain dense version at the tracking shapes (144 edges, Pw 64, Ka 72,
     30x40): a window drawn like the allkf cell's in bf16 and in f32
     storage, a stereo window with self edges, and one depth frame that
     touches all 64 poses: Ad, rhs and dz (from the same dx) within 1e-4
     of each one's max, the occupied cells equal, bitwise over repeated
     launches, the device time beside its byte bound and the plain
     version's;
  3f. hold the tracking step's linearisation and its pose and depth
     systems (csrc/ba_window.cu, ops/ba.py::linearize_window) against the
     plain stages (build_edge_blocks and the block scatters) at the cells'
     shapes (146 edge rows, Pw 64, Ka 72, a buffer of 96 frames): a window
     drawn like the allkf cell's at 30x40, the same with an RGB-D prior, a
     stereo window at 40x64 with self edges, 64 live poses, the depth window
     at the buffer's end and the init's whole store, each with invalid rows
     and rows outside the window: every output within 1e-4 of its max,
     bitwise over repeated launches, the device time at the two cells'
     shapes beside its byte bound and the plain stages';
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
     compute) on the captured engine: the frames up to the init run
     eagerly, the first frame after it captures the step into one CUDA
     graph (its branches IF nodes, csrc/graph_cond.cu), every later frame
     is one replay; warmup+4 frames, then 30 timed frames (host clock and
     CUDA events); the launch counts show the path went through
     corr_level, in bf16 (the operator's lookups) and in f32 (the motion
     probe), and through graph_cond: a wrapper counts a captured launch
     once, so the gate holds the wrappers' counts to the eager frames, the
     warm-up and the capture, and the card's launches to those plus
     replays x the launches captured outside the cull branch (every frame
     here a keyframe, none culled); one graph launch per frame. Then 5 more
     frames under torch.profiler give device time per frame by kernel,
     graph and kernel launches by the host per frame and corr_level's
     kernel records per frame;
  5b. the captured step against capture=False: graph_cond's IF nodes
     against eager cond on a toy state (every predicate pair, nested,
     replayed under sync debug mode "error", timed per node); then phase
     5's 47 frames and phase 7's rows 1 (mono f32, culls and skipped
     frames), 7 (RGB-D) and 8 (stereo; 7 and 8 at 48 frames, so the init
     is not their last keyframe) on the card, each through both engines:
     the keyframe counts after every frame, the keyframes' timestamps,
     poses and disparities and the edge sets bit for bit, the captured
     engine's frames after its capture under sync debug mode "error" (a
     host read raises); the bench case timed over phase 5's window (the
     eager engine's frames/s) and held against phase 5's own Droid; and
     whether a host frame's upload waits for the card;
  6. drive the terminate path, Droid.terminate(), on phase 5's Droid (47
     keyframes) twice, as bench.py does, each global-BA pass an eager
     step, a capture into one CUDA graph and replays; the launch counts of
     each show it went through the split pair, 4 levels x 19 global-BA
     steps x the update-operator chunks on the card (the wrappers' counts
     less the captures' plus the replays': a wrapper counts a captured
     launch once), and the two must repeat: the same backend edge counts
     and chunks, trajectories within 1e-6. Then one more terminate under
     torch.profiler;
  6b. terminate() and terminate(stream) (phase 5's frames) of the same
     tracked state with capture=False and with capture: the trajectories,
     the terminated poses and disparities and each pass's edges and chunks
     bit for bit, every replay under sync debug mode "error", the walls
     side by side;
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
  8. the host-driven engine, Droid(fused=False), its factor graph's
     operator steps captured: (a) phase 5's frames at the bench
     configuration, whose lookups all read the f32 video features:
     corr_level_f32 launches on the card equal to 4 x (probes + 16
     initialisation iterations + 6 per later keyframe), none in bf16; the
     tracking walls, 5 profiled frames (busy share beside phase 5's), one
     terminate() running the split pair 4 x (7 + 12) x chunks times; the
     same frames and terminate() with capture=False, timed over the same
     window and held bit for bit (keyframes, edges, poses, disparities,
     trajectory); then export_map into DIR/host_map and the consistent
     point cloud of the terminated video against the same from CPU copies
     (masks agreeing on >= 99.9% of the pixels, shared points within 1e-4
     of their largest |p|); (b) the cull replay through the host engine on
     the card (its replays under sync debug mode "error"), the same with
     capture=False (bit for bit), the fused engine on the card and the
     host engine on the CPU: the same keyframes after every frame, at
     least one cull, poses within 5e-3; (c) phase 7's row 1 through the
     host engine, inside the same gates;
  9. training: (a) run before phase 4, beside the other kernel checks
     (late in a run torch.profiler has dropped device events):
     corr_backward, the backward of the lookup (csrc/corr_backward.cu:
     three launches per level, sort, df1 and df2), against autograd
     through corr_level_ref at the training path's shapes (208 edges,
     48x64 down to 6x8, C=128, f32) with iid (timed, each launch too, with
     the plain version, its bound and autograd's backward of one
     F.grid_sample call over the same windows; the 4 levels within
     BACKWARD_LIMIT_MS), smooth and far-out coords, and iid and far at
     16 edges on 44x60 (no width a multiple of 8), bitwise on a second
     run, the allocator's peak of a level-0 backward within 5% of its
     outputs and scratch, no spills and no tensor-core instruction in its
     SASS; (b) one grad pass on a small seeded batch,
     card against CPU: the loss and every parameter's gradient within
     TRAIN_LOSS_TOL and TRAIN_GRAD_TOL; (c) apps/train.py's train loop at
     its defaults (384x512, 7 frames, 15 iterations, 52 edge slots, batch
     4) for 3 optimizer steps with a restart pass: finite losses and
     gradients, corr_level_f32 and corr_backward launches equal to their
     counts per pass, step walls, the last step's device time, busy share
     and the peak of allocated memory; (d) LEARN_STEPS steps on one clip
     cut the loss by LEARN_RATIO; (e) a saved train state restores bit for
     bit and its next step's loss and gradients match the uninterrupted
     step's;
  10. the distributed paths on this card as 1-rank groups (NCCL at a free
     port on 127.0.0.1, and a gloo group for CPU tensors), destroyed at
     the end of the phase: (a) phase 4's replay with each Droid's global
     BA sharded over its device's group (Droid(ba_mesh=)), held to phase
     4's bounds, each terminate within 1e-4 of the same Droid's
     single-device one (its terminate(stream) within 5e-3);
     phase 5's frames at the bench configuration tracked by
     Droid(ba_mesh=), warm_terminate(), then terminate() twice: the split
     pair launched 4 x 19 x chunks times each, the two within 1e-6 with
     the same backend edge counts, and the poses and disparities against
     phase 6's single-device terminate within SHARDED_VS_SINGLE_TOL (bf16:
     relative, the single-device BA stores the Schur blocks in bf16, the
     sharded one in f32), and against the same Droid's single-device
     terminate with the Schur blocks in f32 within SHARDED_VS_F32_TOL;
     (b) one optimizer step of apps/train.py's train() at 9b's shapes
     through the group against the same step without one, in
     deterministic mode: the parameters bit for bit equal; and the flat
     gradient all-reduce of every DroidNet parameter timed with CUDA
     events;
  11. the file-based data layer and its apps: (0) whether png.h and
     jpeglib.h are on the compiler's include path (with both, the native
     loader, built from native/droid_native.cc, must build), whether it
     built and why not, whether cv2 imports; (a) 40 frames rendered at
     480x640 with TartanAir's intrinsics, written (PNG by zlib here) as a
     TartanAir scene and a demo folder in a temporary directory; where
     this machine decodes PNG, (b) apps/demo.py's main on the folder at
     the 384x512 area with the shipped weights and a reconstruction, and
     (c) apps/evaluate.py --dataset tartanair with --gt pose_left.txt,
     each trajectory held bit for bit against the same frames fed in
     memory (a gap within FILE_TOL is recorded); (d) apps/train.py
     --datapath at the trainer's defaults for 2 optimizer steps (TF32
     off): finite gradients, corr_level_f32 and corr_backward_f32
     launched (without a decoder the reader loads each frame's .npy twin
     and says so);
  12. the reference-scale entry points of droid_slam_tpu_torch/tools: (a)
     the 240-frame courtyard loop (seed 7) rendered at 384x512 and at
     192x256 and cached in a temporary directory, both renders timed; (b)
     tools/longloop.py's run() at 384x512 in bf16 with the shipped
     weights: 240 finite filled poses, keyframes in LOOP_KEYFRAMES, the
     keyframes and the ATE after terminate those of LOOP_REFERENCE (within
     LOOP_ATE_TOL), each global-BA pass's corr_slab and corr_window
     launches on the card equal to 4 x steps x chunks and its edges at
     most 16 per keyframe, corr_level launched in bf16 and in f32 while
     tracking; the captured steps' graphs, replays, capture seconds and
     pools; the walls, the ATE and
     scale before and after terminate, the peaks of allocated and
     reserved memory by stage and each pass's edges and chunks printed,
     not gated, and the terminate once more under torch.profiler, device
     activity only (device ms by kernel, busy share), then with
     capture=False and with capture from an emptied allocator cache
     (walls, peaks of allocated and reserved memory); (c) the quarter-loop
     gate of tests/test_longloop.py: the first 60 frames at 192x256, f32,
     buffer 96: keyframes, ATE and scale within its bounds; (d)
     tools/backend_probe.py at 200 keyframes and 240x320: its edges equal
     to the distinct pairs of the same draws counted on the host, the
     timed steps replays of the step the warm call captured (its capture
     seconds and pool printed), the split pair run 4 x steps x chunks
     times in them, one
     more step profiled through device_ms (device ms by kernel, the busy
     share against an unprofiled step), the peak of allocated memory; (e)
     tools/eval_sweep.py with the shipped weights over seed 7 in f32 and
     seed 11 in bf16 at phase 7's sizes: each row's keyframes and ATE bit
     for bit phase 7's row of the same seed and dtype, with every kernel
     of the lookup launched.

It starts with the card's PyTorch and CUDA versions, the GPU driver's
CUDA version and whether torch.cuda.CUDAGraph has PyTorch's own IF-node
methods. Phases 7-12 print their walls, and the run its whole wall. It
prints a `kernels` JSON line (corr_level, corr_slab and corr_window in
bf16, corr_level_f32, corr_slab_f32, corr_backward, graph_cond,
schur_window and ba_window; each
with `launches`, the wrapper's count, and `replayed_launches`, those the
card ran again in graph replays), the card's name and power limit, and as
its last line {"ok": true, "device": {...}}.
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
from typing import Optional

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
# corr_backward: the lookup's backward at 208 edges, 48x64 down to 6x8,
# C=128, iid, 4 levels (a dense volume gradient and a cuBLAS product).
# Printed on a log line of their own beside this run's profiler times.
FIRST_DESIGN_MS = {"corr_level": 0.7206, "corr_slab": 10.6588, "corr_window": 0.3870,
                   "corr_level_f32": 0.5711, "corr_slab_f32": 19.56, "corr_backward": 34.59}
# the most the 4-level backward may take at 208 edges, iid (a 3x cut of
# the first design's 34.59 ms); grid_sample's backward is the target, not
# a gate
BACKWARD_LIMIT_MS = 11.5
# the most the allocator's peak during one level-0 backward may exceed its
# outputs and scratch (df1, df2, perm, the bins' starts, dPatch) by
BACKWARD_MEMORY_SLACK = 0.05
PROFILE_TRIES = 5  # profiles of one device_ms call before the run fails
TIMED_RANGE = "chip_smoke.timed_calls"  # the torch.profiler range around device_ms's timed calls

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


def device_ms(torch, fn, reps: int, warm: int = 3, by_kernel=None) -> float:
    """Mean device time of fn per call, by torch.profiler: one untimed call
    (the profile's first records can be lost), then reps timed calls inside
    the range TIMED_RANGE, and the sum of the device records (kernels,
    memsets, copies) of the runtime calls the host made in that range,
    matched by correlation id, over reps. A profile must hold a kernel
    record for each kernel launch of the timed calls (the profiler drops
    records now and then); and where the host queued the timed calls in
    under half of the span of two CUDA events around them, the device was
    the bottleneck and busy the whole span, so the records must cover at
    least 0.7 of it. A profile that fails is taken again, up to
    PROFILE_TRIES in all; then the run fails. A dict passed as by_kernel
    receives each kernel's mean device ms per call, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function(TIMED_RANGE):
                start.record()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                queued_ms = (time.perf_counter() - t0) * 1e3
                end.record()
                torch.cuda.synchronize()
        span_ms = start.elapsed_time(end)
        device_ns, launches, missing = timed_records(
            (e.name(), event_side(e, DeviceType), e.correlation_id(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events())
        ms = sum(device_ns.values()) / 1e6 / reps
        if ms > 0 and not missing and (queued_ms >= 0.5 * span_ms or ms * reps >= 0.7 * span_ms):
            if by_kernel is not None:
                by_kernel.update({k: v / 1e6 / reps for k, v in device_ns.items()})
            return ms
        log(f"  torch.profiler: no kernel record for {len(missing)} of the timed calls' {launches} launches "
            f"(at {missing[:6]}), {ms * reps:.4f} ms of device time against {span_ms:.4f} ms of CUDA events "
            f"(calls queued in {queued_ms:.4f} ms); profiling again")
    raise RuntimeError(f"torch.profiler failed its checks {PROFILE_TRIES} times (no kernel record for "
                       f"{len(missing)} of {launches} launches, {ms * reps:.4f} ms against {span_ms:.4f} ms "
                       "of CUDA events)")


def event_side(e, DeviceType) -> str:
    """"host" for a profiler event of the CPU, "device" for a record of the
    card (a kernel, memset or copy), "" for the card's copy of a range."""
    if e.device_type() == DeviceType.CPU:
        return "host"
    return "" if e.is_user_annotation() else "device"


def timed_records(events, range_name: str = TIMED_RANGE):
    """(device ns by name, kernel launches, missing) of the calls in the
    host range range_name, from (name, side, correlation id, start ns,
    end ns) profiler events, side as event_side gives it: the host's
    runtime and driver calls (cu*) that start inside the range, the device
    records (kernels, memsets, copies) with their correlation ids, and the
    positions, in host order, of the kernel launches (cudaLaunchKernel,
    cuLaunchKernelEx and the like) that have no kernel record."""
    events = list(events)
    lo, hi = next(((s, e) for name, side, _, s, e in events if side == "host" and name == range_name), (0, -1))
    calls = sorted((s, name, cid) for name, side, cid, s, _ in events
                   if side == "host" and name.startswith("cu") and lo <= s <= hi)
    ids = {cid for _, _, cid in calls}
    device_ns, kernel_ids = {}, set()
    for name, side, cid, s, e in events:
        if side == "device" and cid in ids:
            device_ns[name] = device_ns.get(name, 0) + (e - s)
            if not name.startswith(("Memset", "Memcpy")):
                kernel_ids.add(cid)
    launches = [cid for _, name, cid in calls if "LaunchKernel" in name]
    missing = [k for k, cid in enumerate(launches) if cid not in kernel_ids]
    return device_ns, len(launches), missing


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


# the tracking step's flight recorder at the bench configuration: RING_ROWS
# rows x the columns of runtime/fused.py::trace_slots, a mask of its
# max_factors valid-edge slots, and the recorder launches captured into one
# step: trace_begin once, trace_stamp at 37 columns, trace_count at 12 (each
# iteration's valid edges and occupied Schur cells)
TRACE_RING = (64, 53)
TRACE_MASK = 48
TRACE_STEP_LAUNCHES = {"trace_begin": 1, "trace_stamp": 37, "trace_count": 12}


def check_trace_kernels(torch, profiling, graph, dev, seed: int):
    """Phase 3d: the flight recorder's kernels (csrc/graph_cond.cu:
    trace_begin, trace_stamp, trace_count) against their plain versions,
    utils/profiling.py's CPU path, on the same ring [TRACE_RING] of random
    values, with the cursor on the last row (the wrap) and on a middle one:
    the cursor, every other row, the emptied row, the tstamp's bits and the
    count of a TRACE_MASK-slot mask equal exactly; the stamped columns are
    the same and their times non-decreasing. Then the step's recorder
    launches (TRACE_STEP_LAUNCHES) captured into one graph and replayed:
    one row per replay, each in order. Timed: each kernel launched eagerly
    (CUDA events over 200 launches) and per launch inside the replayed
    graph."""
    g = torch.Generator().manual_seed(seed + 3)
    rows, cols = TRACE_RING
    stamped = list(range(2, cols - 1, 3))
    cases = []
    for cursor in (rows - 1, rows // 2):
        ring = torch.randint(0, 2**40, (rows, cols), generator=g, dtype=torch.int64)
        row = torch.tensor(cursor, dtype=torch.int64)
        tstamp = torch.tensor(float(torch.randint(0, 10**6, (), generator=g)) + 0.25)
        mask = torch.rand(TRACE_MASK, generator=g) < 0.6
        sides = {}
        for side, d in (("plain", torch.device("cpu")), ("card", dev)):
            r, w = ring.to(d, copy=True), row.to(d, copy=True)
            profiling.ring_begin(r, w, tstamp.to(d))
            for c in stamped:
                profiling.stamp(r, w, c)
            profiling.count(r, w, cols - 1, mask.to(d))
            sides[side] = (r.cpu(), int(w))
        (want, want_row), (got, got_row) = sides["plain"], sides["card"]
        times = [1] + stamped
        values = [c for c in range(cols) if c not in times]
        others = torch.arange(rows) != want_row
        stamps = got[got_row, times]
        case = dict(cursor=cursor, row=got_row, same_cursor=got_row == want_row == (cursor + 1) % rows,
                    same_other_rows=bool(torch.equal(got[others], want[others])),
                    same_columns=bool(torch.equal(got[got_row] == profiling.EMPTY,
                                                  want[want_row] == profiling.EMPTY)),
                    same_values=bool(torch.equal(got[got_row, values], want[want_row, values])),
                    count=int(got[got_row, cols - 1]), plain_count=int(want[want_row, cols - 1]),
                    stamps_ordered=bool((stamps > 0).all() and (stamps[1:] >= stamps[:-1]).all()))
        case["ok"] = all(case[k] for k in ("same_cursor", "same_other_rows", "same_columns", "same_values",
                                            "stamps_ordered"))
        cases.append(case)

    # the step's recorder launches as one captured graph
    ring = torch.full(TRACE_RING, profiling.EMPTY, dtype=torch.int64, device=dev)
    row = torch.full((), rows - 1, dtype=torch.int64, device=dev)
    tstamp = torch.full((), 7.5, device=dev)
    valid = (torch.rand(TRACE_MASK, generator=g) < 0.6).to(dev)
    n_valid = int(valid.sum())
    stamp_cols = list(range(2, 2 + TRACE_STEP_LAUNCHES["trace_stamp"]))
    count_cols = list(range(cols - TRACE_STEP_LAUNCHES["trace_count"], cols))

    def step_recorder():
        profiling.ring_begin(ring, row, tstamp)
        for c in stamp_cols:
            profiling.stamp(ring, row, c)
        for c in count_cols:
            profiling.count(ring, row, c, valid)

    step_recorder()
    cap = graph.Captured(step_recorder, dev)
    replays = 5
    for _ in range(replays):
        cap.replay()
    torch.cuda.synchronize()
    got = ring.cpu()
    replayed_rows = [k % rows for k in range(1, replays + 1)]  # row 0 is the eager run's
    times = [1] + stamp_cols
    in_order = all(bool((got[r, times][1:] >= got[r, times][:-1]).all()) for r in replayed_rows)
    counted = all(int(got[r, c]) == n_valid for r in replayed_rows for c in count_cols)
    captured = dict(launches=cap.launches, replays=replays, cursor=int(row), rows_in_order=in_order,
                    counts_ok=counted, tstamps_ok=all(got[r, 0:1].view(torch.float64).item() == 7.5
                                                      for r in replayed_rows))
    captured["ok"] = bool(captured["cursor"] == replays and in_order and counted and captured["tstamps_ok"]
                          and all(cap.launches.get(k) == n for k, n in TRACE_STEP_LAUNCHES.items()))
    per_step = sum(TRACE_STEP_LAUNCHES.values())
    timing = dict(
        trace_begin_ms=cuda_ms(torch, lambda: profiling.ring_begin(ring, row, tstamp), reps=200),
        trace_stamp_ms=cuda_ms(torch, lambda: profiling.stamp(ring, row, 2), reps=200),
        trace_count_ms=cuda_ms(torch, lambda: profiling.count(ring, row, cols - 1, valid), reps=200),
        step_ms=cuda_ms(torch, cap.replay, reps=100))
    timing["per_launch_in_graph_ms"] = timing["step_ms"] / per_step
    res = dict(cases=cases, captured=captured, timing=timing,
               ok=all(c["ok"] for c in cases) and captured["ok"])
    for c in cases:
        log(f"  trace kernels, cursor {c['cursor']} -> {c['row']}: cursor, other rows, emptied row, tstamp bits "
            f"and count ({c['count']} = plain {c['plain_count']}) "
            f"{'equal' if c['ok'] else 'DIFFER'}; stamps {'ordered' if c['stamps_ordered'] else 'OUT OF ORDER'}; "
            f"{c}")
    log(f"  trace kernels captured ({per_step} launches per step: {TRACE_STEP_LAUNCHES}), {replays} replays: "
        f"{captured}; eager launch trace_begin {timing['trace_begin_ms']:.5f} ms, trace_stamp "
        f"{timing['trace_stamp_ms']:.5f} ms, trace_count {timing['trace_count_ms']:.5f} ms; the step's "
        f"{per_step} in one graph {timing['step_ms']:.5f} ms ({timing['per_launch_in_graph_ms']:.5f} ms each): "
        f"{'ok' if res['ok'] else 'FAILED'}")
    return res


# the tracking step's dense-window GN step at the benchmark's configuration
# (slam_bench/configs/tum_mono_240x320.json): 96 inactive + 48 active edge
# slots, window_pad 64 poses, 64 + 8 depth frames, 30x40 features
SCHUR_SHAPE = dict(N=144, Pw=64, Ka=72, hw=30 * 40)
SCHUR_CASES = (("allkf", "bfloat16"), ("allkf", "float32"), ("stereo", "bfloat16"), ("worst", "bfloat16"))
SCHUR_REPEATS = 3


def schur_window_case(torch, kind: str, dtype: str, dev, seed: int, N: int, Pw: int, Ka: int, hw: int):
    """Inputs of ops/ba.py::window_schur drawn on the CPU from ``seed`` and
    moved to ``dev``: ``allkf``, a window like the all-keyframe tracking
    cell's (t1 = 70, t0 = 45, kf0 = 40; the last third of the edges active
    among the newest 8 frames, the rest inactive over [kf0, t1 - 4), a
    fifth of those invalid, |ii - jj| <= 3); ``stereo``, the same with every
    eighth edge a self edge (ii = jj, its rows zero, as build_edge_blocks
    makes them); ``worst``, 64 live poses and a depth frame whose edges
    touch all of them. Pw must be 64 or more for ``worst``. Returns a dict
    of the arguments (with ``dx6``, a fixed update the test's solve
    returns) and ``sd``, the storage dtype."""
    g = torch.Generator().manual_seed(seed)
    if kind == "worst":
        t0, t1, kf0 = 10, 74, 8
    else:
        t0, t1, kf0 = 45, 70, 40
    n_act = N // 3
    ii = torch.randint(kf0, t1 - 4, (N,), generator=g)
    ii[N - n_act:] = torch.randint(t1 - 8, t1, (n_act,), generator=g)
    step = torch.randint(1, 4, (N,), generator=g) * (1 - 2 * torch.randint(0, 2, (N,), generator=g))
    jj = (ii + step).clamp(kf0, t1 - 1)
    jj = torch.where(jj == ii, ii - step, jj)
    valid = torch.ones(N, dtype=torch.bool)
    valid[: N - n_act] = torch.rand(N - n_act, generator=g) >= 0.2
    if kind == "worst":
        ii[:64] = kf0 + 12
        jj[:64] = t0 + torch.arange(64)
        valid[:64] = True
    Ei = torch.randn((N, 6, hw), generator=g)
    Ej = torch.randn((N, 6, hw), generator=g)
    if kind == "stereo":
        jj[::8] = ii[::8]
        Ei[::8] = 0.0
        Ej[::8] = 0.0
    Q = 1.0 / (0.5 + torch.rand((Ka, hw), generator=g))
    Q[torch.rand(Ka, generator=g) < 0.1] = 0.0  # frames outside the depth window
    w = torch.randn((Ka, hw), generator=g)
    live = (torch.arange(Pw) < t1 - t0).float()
    live6 = live.repeat_interleave(6)
    B = torch.randn((Pw * 6, Pw * 6), generator=g) / (Pw * 6) ** 0.5
    Hm = (B @ B.T + torch.eye(Pw * 6)) * live6[:, None] * live6[None, :] + torch.diag(1.0 - live6)
    v = torch.randn((Pw, 6), generator=g) * live[:, None]
    dx6 = 1e-2 * torch.randn(Pw * 6, generator=g) * live6
    scalar = lambda x: torch.tensor(x, dtype=torch.int64)
    args = dict(Ei=Ei, Ej=Ej, ii=ii, jj=jj, edge_valid=valid, t0=scalar(t0), t1=scalar(t1), kf0=scalar(kf0),
                Q=Q, w_rhs=w, Hm=Hm, v=v, dx6=dx6)
    out = {k: t.to(dev) for k, t in args.items()}
    out["sd"] = getattr(torch, dtype)
    return out


def schur_window_run(ba, case, fn=None, record=True):
    """One call of ``fn`` (ops/ba.py::window_schur or its plain version) on
    a :func:`schur_window_case`, with a solve that returns the case's fixed
    dx6: {Ad, rhs, dz, cells} (Ad and rhs as the solve saw them, with
    ``record``)."""
    fn = fn or ba.window_schur
    got = {}

    def solve(Ad, rhs):
        if record:
            got["Ad"], got["rhs"] = Ad.clone(), rhs.clone()
        return case["dx6"]

    _, got["dz"], got["cells"] = fn(case["Ei"], case["Ej"], case["ii"], case["jj"], case["edge_valid"], case["t0"],
                                    case["t1"], case["kf0"], case["Q"], case["w_rhs"], case["Hm"], case["v"], solve,
                                    1e-4, 0.1, case["sd"])
    return got


def schur_window_bytes(case) -> int:
    """The bytes window_schur needs at a case: the coupling rows that land
    in a cell read once (f32), Q and w read and dz written once, Hm read and
    Ad written, v read and rhs written, the edges (ii, jj, mask) read."""
    Ka, hw = case["Q"].shape
    P6 = case["Hm"].shape[0]
    ii, jj, t0, kf0 = (case[k].cpu() for k in ("ii", "jj", "t0", "kf0"))
    live = min(P6 // 6, int(case["t1"]) - int(t0))
    k = ii - kf0
    in_k = case["edge_valid"].cpu() & (k >= 0) & (k < Ka)
    rows = sum(int((in_k & (p >= 0) & (p < live)).sum()) for p in (ii - t0, jj - t0))
    return rows * 6 * hw * 4 + 3 * Ka * hw * 4 + 2 * P6 * P6 * 4 + 2 * P6 * 4 + ii.numel() * 17


def check_schur_window(torch, ba, kernels, dev, seed: int):
    """Phase 3e: ops/ba.py::window_schur's kernels (csrc/schur_window.cu)
    against the plain dense version at the tracking shapes
    (SCHUR_SHAPE), each of SCHUR_CASES: Ad, rhs and dz within KERNEL_TOL of
    each one's max |plain|, the occupied cells equal, SCHUR_REPEATS runs
    bitwise equal; the device time (profiler) beside the byte bound and the
    plain version's time; the launches per call."""
    cases = []
    for n, (kind, dtype) in enumerate(SCHUR_CASES):
        case = schur_window_case(torch, kind, dtype, dev, seed + 31 * n, **SCHUR_SHAPE)
        before = kernels.launch_counts()
        runs = [schur_window_run(ba, case) for _ in range(SCHUR_REPEATS)]
        launched = kernels.launches_since(before)
        plain = schur_window_run(ba, case, ba.window_schur_ref)
        torch.cuda.synchronize()
        got = runs[0]
        errs = {k: float((got[k] - plain[k]).abs().max()) for k in ("Ad", "rhs", "dz")}
        scales = {k: float(plain[k].abs().max()) for k in ("Ad", "rhs", "dz")}
        bitwise = all(torch.equal(r[k], got[k]) for r in runs[1:] for k in got)
        cells = int(got["cells"].sum())
        n_cells = got["cells"].sum(dim=1)
        pairs = int((n_cells * (n_cells + 1) // 2).sum())
        by_kernel = {}
        ms = device_ms(torch, lambda: schur_window_run(ba, case, record=False), reps=50, by_kernel=by_kernel)
        plain_ms = device_ms(torch, lambda: schur_window_run(ba, case, ba.window_schur_ref, record=False), reps=10)
        nbytes = schur_window_bytes(case)
        ops = 2 * 36 * SCHUR_SHAPE["hw"] * int((n_cells * n_cells).sum())  # S over each frame's ordered pairs
        bound_ms = 1e3 * max(nbytes / MEM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"])
        c = dict(kind=kind, dtype=dtype, cells=cells, pairs=pairs, max_abs_err=errs, max_abs_ref=scales,
                 cells_equal=bool(torch.equal(got["cells"], plain["cells"])), bitwise_repeat=bitwise,
                 launches=launched, ms=ms, by_kernel=by_kernel, plain_ms=plain_ms, bytes=nbytes, ops=ops,
                 bound_ms=bound_ms,
                 finite=all(bool(torch.isfinite(got[k]).all()) for k in errs))
        c["ok"] = bool(c["finite"] and c["cells_equal"] and bitwise
                       and all(errs[k] <= KERNEL_TOL * scales[k] for k in errs)
                       and launched.get("schur_window") == launched.get("schur_backsub") == SCHUR_REPEATS)
        cases.append(c)
        log(f"  schur_window {kind} {dtype}: {cells} cells, {pairs} pairs; max_err "
            + ", ".join(f"{k} {errs[k]:.3e} (tol {KERNEL_TOL * scales[k]:.3e})" for k in errs)
            + f"; cells {'equal' if c['cells_equal'] else 'DIFFER'}; repeat {'bitwise' if bitwise else 'DIFFERS'}; "
            f"{ms:.4f} ms (bound {bound_ms:.5f} ms, {nbytes / 1e6:.2f} MB), plain {plain_ms:.4f} ms; "
            f"launches {launched}: {'ok' if c['ok'] else 'FAILED'}")
        names = {k: next((part.split("(")[0] for part in k.split("::") if "_kernel" in part), k[:40]) for k in by_kernel}
        log("    by kernel (ms per call): " + ", ".join(f"{names[k]} {v:.4f}" for k, v in by_kernel.items()))
    return cases


# the tracking step's linearisation at the cells' shapes: 96 inactive + 50
# view edge rows, window_pad 64 poses, 64 + 8 depth frames, a buffer of 96
# frames; 30x40 features (tum_mono_240x320) and 40x64 (euroc_stereo_320x512)
BA_WINDOW_SHAPE = dict(N=96 + 50, Pw=64, Ka=72, F=96)
BA_WINDOW_CASES = (("mono", 30, 40), ("rgbd", 30, 40), ("stereo", 40, 64), ("full", 30, 40), ("end", 30, 40),
                   ("init", 30, 40))
BA_WINDOW_TIMED = ("mono", "stereo")  # the two cells' shapes
BA_WINDOW_REPEATS = 3


def ba_window_case(torch, ba, kind: str, dev, seed: int, N: int, Pw: int, Ka: int, F: int, h: int, w: int):
    """Keyword arguments of ops/ba.py::linearize_window drawn on the CPU
    from ``seed`` and moved to ``dev``: F frames of independent small poses,
    disparities in [0.5, 1.5), targets the reprojections plus noise, weights
    in [0, 1). ``mono``, a window like the allkf cell's (t0 45, t1 70, kf0
    40; the last third of the rows among the newest 8 frames, a fifth of the
    others invalid, |ii - jj| <= 3), with valid rows outside it: ii below
    kf0 (out of the depth system, its pose fixed) and jj past t1 (a dead
    pose); ``rgbd``, mono with a sensor depth on frames 44-60 (a tenth of
    its pixels 0); ``stereo``, mono with every eighth row a self edge;
    ``full``, 64 live poses (t0 10, t1 74, kf0 8) and a frame whose edges
    touch all of them; ``end``, kf0 80 at the buffer's end (frames kf0 + k
    past F for k >= 16), t0 82, t1 96; ``init``, the init's whole store (t0
    1, t1 12, kf0 0; valid edges among the first 12 frames in the first 40
    rows only)."""
    g = torch.Generator().manual_seed(seed)
    t0, t1, kf0 = dict(full=(10, 74, 8), end=(82, 96, 80), init=(1, 12, 0)).get(kind, (45, 70, 40))
    n_act = N // 3
    ii = torch.randint(kf0, t1 - 4, (N,), generator=g)
    ii[N - n_act:] = torch.randint(t1 - 8, t1, (n_act,), generator=g)
    step = torch.randint(1, 4, (N,), generator=g) * (1 - 2 * torch.randint(0, 2, (N,), generator=g))
    jj = (ii + step).clamp(kf0, t1 - 1)
    jj = torch.where(jj == ii, ii - step, jj)
    valid = torch.ones(N, dtype=torch.bool)
    valid[: N - n_act] = torch.rand(N - n_act, generator=g) >= 0.2
    if kind in ("mono", "rgbd", "stereo"):
        ii[:3], jj[:3] = kf0 - 2, t0 + 2
        ii[3:6], jj[3:6] = t1 - 2, t1 + 2
        valid[:6] = True
    if kind == "stereo":
        jj[::8] = ii[::8]
    if kind == "full":
        ii[:64] = kf0 + 13
        jj[:64] = t0 + torch.arange(64)
        valid[:64] = True
    if kind == "init":
        valid = torch.arange(N) < 40
    xi = torch.cat([0.05 * torch.randn((F, 3), generator=g), 0.02 * torch.randn((F, 3), generator=g)], -1)
    poses = ba.lie.exp(xi)
    disps = 0.5 + torch.rand((F, h, w), generator=g)
    intr = torch.tensor([w * 0.9, w * 0.9, w / 2, h / 2])
    coords, _ = ba.pops.projective_transform(poses, disps, intr.expand(F, 4), ii, jj)
    sens = torch.zeros(F, h, w)
    if kind == "rgbd":
        sens[44:61] = (0.5 + torch.rand((17, h, w), generator=g)) * (torch.rand((17, h, w), generator=g) >= 0.1)
    scalar = lambda x: torch.tensor(x, dtype=torch.int64)
    args = dict(poses=poses, disps=disps, intrinsics=intr, disps_sens=sens,
                target=coords + 0.5 * torch.randn(coords.shape, generator=g),
                weight=torch.rand(coords.shape, generator=g), eta=1e-3 + 1e-2 * torch.rand((F, h, w), generator=g),
                ii=ii, jj=jj, edge_valid=valid, t0=scalar(t0), t1=scalar(t1), kf0=scalar(kf0))
    return {**{k: t.to(dev) for k, t in args.items()}, "window": Pw, "kwin": Ka}


def ba_window_run(ba, case, fn=None) -> dict:
    """One call of ``fn`` (ops/ba.py::linearize_window or its plain version)
    on a :func:`ba_window_case`: its outputs by name."""
    return (fn or ba.linearize_window)(**case)._asdict()


def ba_window_bytes(case) -> int:
    """The bytes linearize_window needs at a case: the valid rows' targets
    and weights and the source frames' disparities read once, E_i and E_j
    of every row written, the depth window's prior, disparities and damping
    read and Q and w written, Hm, v and live6 written (f32); the edges."""
    N, hw = case["ii"].numel(), case["disps"][0].numel()
    Ka, P6 = case["kwin"], 6 * case["window"]
    valid = case["edge_valid"].cpu()
    frames = case["ii"].cpu()[valid].unique().numel()
    return (int(valid.sum()) * 16 + frames * 4 + N * 48 + Ka * 20) * hw + (P6 * P6 + 2 * P6) * 4 + N * 17


def check_ba_window(torch, ba, kernels, dev, seed: int):
    """Phase 3f: ops/ba.py::linearize_window's kernels (csrc/ba_window.cu)
    against the plain stages (linearize_window_ref: build_edge_blocks and
    the block scatters) at the cells' shapes, each of BA_WINDOW_CASES:
    every output within KERNEL_TOL of its max |plain| (live6 equal),
    BA_WINDOW_REPEATS runs bitwise equal, one launch per call; at the
    BA_WINDOW_TIMED shapes the device time (profiler) beside the byte bound
    and the plain stages' time."""
    cases = []
    for n, (kind, h, w) in enumerate(BA_WINDOW_CASES):
        case = ba_window_case(torch, ba, kind, dev, seed + 37 * n, h=h, w=w, **BA_WINDOW_SHAPE)
        before = kernels.launch_counts()
        runs = [ba_window_run(ba, case) for _ in range(BA_WINDOW_REPEATS)]
        launched = kernels.launches_since(before)
        plain = ba_window_run(ba, case, ba.linearize_window_ref)
        torch.cuda.synchronize()
        got = runs[0]
        errs = {k: float((got[k] - plain[k]).abs().max()) for k in got}
        scales = {k: float(plain[k].abs().max()) for k in got}
        bitwise = all(torch.equal(r[k], got[k]) for r in runs[1:] for k in got)
        c = dict(kind=kind, shape=[h, w], rows=int(case["edge_valid"].sum()),
                 self_rows=int((case["edge_valid"] & (case["ii"] == case["jj"])).sum()), max_abs_err=errs,
                 max_abs_ref=scales, bitwise_repeat=bitwise, launches=launched,
                 finite=all(bool(torch.isfinite(got[k]).all()) for k in got))
        c["ok"] = bool(c["finite"] and bitwise and torch.equal(got["live6"], plain["live6"])
                       and all(errs[k] <= KERNEL_TOL * scales[k] for k in got)
                       and launched == {"ba_window": BA_WINDOW_REPEATS})
        timing = ""
        if kind in BA_WINDOW_TIMED:
            by_kernel = {}
            c["ms"] = device_ms(torch, lambda: ba_window_run(ba, case), reps=50, by_kernel=by_kernel)
            c["plain_ms"] = device_ms(torch, lambda: ba_window_run(ba, case, ba.linearize_window_ref), reps=10)
            c["by_kernel"] = by_kernel
            c["bytes"] = ba_window_bytes(case)
            c["bound_ms"] = 1e3 * c["bytes"] / MEM_BYTES_PER_S
            names = {k: next((p.split("(")[0] for p in k.split("::") if "_kernel" in p), k[:40]) for k in by_kernel}
            timing = (f"; {c['ms']:.4f} ms (bound {c['bound_ms']:.5f} ms, {c['bytes'] / 1e6:.2f} MB), plain "
                      f"{c['plain_ms']:.4f} ms; by kernel " + ", ".join(f"{names[k]} {v:.4f}" for k, v in by_kernel.items()))
        cases.append(c)
        log(f"  ba_window {kind} {h}x{w}: {c['rows']} valid rows ({c['self_rows']} self); max_err "
            + ", ".join(f"{k} {errs[k]:.3e} (tol {KERNEL_TOL * scales[k]:.3e})" for k in errs)
            + f"; repeat {'bitwise' if bitwise else 'DIFFERS'}{timing}; launches {launched}: "
            f"{'ok' if c['ok'] else 'FAILED'}")
    return cases


def small_replay(torch, np, Droid, DroidConfig, init_params, seed: int, meshes=None):
    """Phase 4: the same 8 RGB-D frames through the GPU port and the CPU port.
    With ``meshes`` ({"cuda": group, "cpu": group}), each Droid's global BA
    runs sharded over its device's process group (phase 10a), and each
    Droid terminates its tracked state once more without the group: the
    largest differences of the two terminate() and terminate(stream)
    trajectories by device (``vs_single_device``)."""
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
    runs, trajs, vs_single = {}, {}, {}
    for device in ("cuda", "cpu"):
        d = Droid(DroidConfig(**SMALL_CONFIG), params=params, device=device,
                  ba_mesh=None if meshes is None else meshes[device])
        for t, (img, depth) in enumerate(frames):
            d.track(t, img, depth=depth, intrinsics=intr)
        runs[device] = d
        trajs[device] = (d.terminate(), d.terminate(iter(stream)))
        if meshes is not None:
            d.ba_mesh = None
            single = (d.terminate(), d.terminate(iter(stream)))
            vs_single[device] = [float(np.abs(a - b).max()) for a, b in zip(trajs[device], single)]
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
    if meshes is not None:
        res["vs_single_device"] = vs_single
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
    reset before; returns (frames tracked, warm-up s, timed s, ms of CUDA
    events around the timed frames, launches by kernel, launches by kernel
    and feature type)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = 0
    t0 = time.perf_counter()
    for _ in range(n_warm):
        droid.track(t, frames[t % len(frames)], intrinsics=intr)
        t += 1
    droid.sync()
    warm_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_timed):
        droid.track(t, frames[t % len(frames)], intrinsics=intr)
        t += 1
    end.record()
    droid.sync()
    elapsed = time.perf_counter() - t0
    return t, warm_s, elapsed, start.elapsed_time(end), dict(kernels.LAUNCHES), dict(kernels.DTYPE_LAUNCHES)


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
    host_calls = {e.key: e.count for e in events if e.device_type == DeviceType.CPU}
    return dict(
        frames=n_prof,
        profiled_wall_ms_per_frame=wall * 1e3 / n_prof,
        device_ms_per_frame=dev_ms,
        # what the host issued per frame, and the corr_level kernels the card ran
        graph_launches_per_frame=host_calls.get("cudaGraphLaunch", 0) / n_prof,
        kernel_launches_per_frame=host_calls.get("cudaLaunchKernel", 0) / n_prof,
        corr_level_records_per_frame=sum(e.count for e in events if e.device_type == DeviceType.CUDA
                                         and "corr_level" in e.key) / n_prof,
        corr_level_ms_per_frame=sum(v for k, v in kernel_us.items() if "corr_level" in k) / 1e3 / n_prof,
        segment_sum_ms_per_frame=seg_ms / n_prof,
        segment_sum_calls_per_frame=seg_calls / n_prof,
        device_busy_share=dev_ms * fps / 1e3,
        top_kernels_ms_per_frame={k[:60]: v / 1e3 / n_prof for k, v in top},
    )


GRAPH_IF_API = ("get_currently_capturing_graph", "begin_capture_to_if_node", "end_capture_to_conditional_node")
GRAPH_COND_NODES = 32  # IF nodes of graph_cond's timed chain
# IF nodes of the captured step, all in the graph itself: keyframe, update
# up to the cull test, update and cull, update and keep, the rest of update
GRAPH_IF_NODES = 5


def driver_cuda_version() -> str:
    """The CUDA version of the installed driver (cuDriverGetVersion)."""
    import ctypes

    v = ctypes.c_int()
    ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(v))
    return f"{v.value // 1000}.{v.value % 1000 // 10}"


def graph_launches(g, wrapper, steady_frames: int):
    """The launches of a tracking run whose frames after init replay the
    captured step ``g``, every replay on the keyframe-and-keep path (phase
    5's frames: every frame a keyframe, none culled). A wrapper counts a
    launch when it queues its kernel, once per capture for a captured one;
    the card runs it on every replay that takes its branch. So the device's
    launches are the wrappers' counts less those of the capture, plus
    replays x those of the capture outside the cull branch."""
    per_replay = {k: n - g.branch_launches.get("cull", {}).get(k, 0) for k, n in g.launches.items()}
    device = {k: wrapper.get(k, 0) - g.launches.get(k, 0) + g.replays * per_replay.get(k, 0)
              for k in set(wrapper) | set(per_replay)}
    return dict(launches=dict(wrapper), device_launches=device, replays=g.replays,
                replayed_launches={k: g.replays * n for k, n in per_replay.items()},
                captured_launches=g.launches, branch_launches=g.branch_launches,
                graph_launches_per_frame=g.replays / steady_frames, capture_s=g.capture_s,
                pool_bytes=g.pool_bytes)


def check_graph_cond(torch, graph, dev):
    """The IF node (csrc/graph_cond.cu) against its plain version, cond
    run eagerly: a toy state x [4] and fn = cond(p, a, b) with a nested
    cond(q, ...) in a, then x += 0.5, captured once and replayed for every
    (p, q) under sync debug mode "error", each against the eager fn on the
    same state. Then a chain of GRAPH_COND_NODES conds, each adding 1 to
    one element where its predicate holds, timed per cond (CUDA events
    over 50 replays) against the eager chain (a host read per cond)."""
    import itertools

    x = torch.zeros(4, device=dev)
    p, q = (torch.zeros((), dtype=torch.bool, device=dev) for _ in range(2))

    def inner(s):
        s.mul_(10.0)

    def a(s):
        s.add_(1.0)
        graph.cond(q, inner, None, s)

    def b(s):
        s.sub_(1.0)

    def fn():
        graph.cond(p, a, b, x)
        x.add_(0.5)

    with graph._warming(dev):
        fn()
    cap = graph.Captured(fn, dev)
    err, got_all, want_all = 0.0, [], []
    for pv, qv in itertools.product((True, False), repeat=2):
        p.fill_(pv)
        q.fill_(qv)
        x.zero_()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cap.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = x.clone()
        x.zero_()
        fn()  # eager: reads p and q on the host
        err = max(err, float((got - x).abs().max()))
        got_all.append(got.tolist())
        want_all.append(x.tolist())

    y = torch.zeros(GRAPH_COND_NODES, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    bodies = [lambda s, i=i: s[i].add_(1.0) for i in range(GRAPH_COND_NODES)]

    def chain():
        for body in bodies:
            graph.cond(yes, body, None, y)

    with graph._warming(dev):
        chain()
    chained = graph.Captured(chain, dev)
    ms = cuda_ms(torch, chained.replay, reps=50) / GRAPH_COND_NODES
    plain_ms = cuda_ms(torch, chain, reps=10) / GRAPH_COND_NODES
    # per cond: the predicate's byte and one f32 read and written
    bound_ms, bound_by = bound(1 + 8, 1, "float32")
    # every element: the warm-up, 3 + 50 replays, 3 + 10 eager chains
    runs = 1 + (3 + 50) + (3 + 10)
    res = dict(name="graph_cond", max_abs_err=err, replayed=got_all, eager=want_all, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, capture_s=cap.capture_s, chain_capture_s=chained.capture_s,
               chain_ok=float(y.min()) == float(y.max()) == runs)
    res["ok"] = bool(err == 0.0 and res["chain_ok"])
    log(f"  graph_cond: replays vs eager cond max err {err:.1e} over (p, q) in TT, TF, FT, FF "
        f"{got_all}; per IF node {ms:.5f} ms replayed, {plain_ms:.5f} ms eager (a host read each), bound "
        f"{res['bound_ms']:.2e} ms; capture {cap.capture_s:.3f} s: {'ok' if res['ok'] else 'FAILED'}")
    return res


def compare_engines(torch, np, make, stream, timed=None, per_frame: bool = True):
    """Track ``stream`` ((t, image, depth or None, intrinsics), all on the
    card) with ``make(capture=False)`` and ``make(capture=True)``. The
    captured Droid's frames after its capture run under sync debug mode
    "error": a host read there raises. Holds the two bit for bit: the
    keyframe count after every frame (``per_frame``; else at the end), the
    keyframe timestamps, poses and disparities, the active and inactive
    edges. ``timed`` = (first frame, frames): host seconds over that window
    of each run, ended by a synchronise."""
    runs = {}
    for capture in (False, True):
        droid = make(capture)
        hist, checked, wall = [], 0, None
        torch.cuda.synchronize()
        for t, image, depth, intr in stream:
            if timed is not None and t == timed[0]:
                droid.sync()
                t0 = time.perf_counter()
            steady = droid.graph is not None
            if steady:
                torch.cuda.set_sync_debug_mode("error")
            try:
                droid.track(t, image, depth=depth, intrinsics=intr)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            checked += steady
            if timed is not None and t == timed[0] + timed[1] - 1:
                droid.sync()
                wall = time.perf_counter() - t0
            if per_frame:
                hist.append(droid.counter)
        droid.sync()
        runs[capture] = dict(droid=droid, hist=hist if per_frame else [droid.counter], checked=checked,
                             fps=None if wall is None else timed[1] / wall)
    eager, captured = runs[False]["droid"], runs[True]["droid"]
    g = captured.graph
    same = dict(
        keyframes=runs[False]["hist"] == runs[True]["hist"],
        tstamps=torch.equal(eager.tstamps, captured.tstamps),
        poses=torch.equal(eager.poses, captured.poses),
        disps=torch.equal(eager.disps, captured.disps),
        edges=eager.edges == captured.edges,
        inactive_edges=eager.inactive_edges == captured.inactive_edges,
    )
    res = dict(frames=len(stream), keyframes=captured.counter, same=same,
               sync_checked_frames=runs[True]["checked"], eager_fps=runs[False]["fps"],
               captured_fps=runs[True]["fps"], replays=None if g is None else g.replays,
               capture_s=None if g is None else g.capture_s, pool_bytes=None if g is None else g.pool_bytes,
               branch_launches=None if g is None else g.branch_launches)
    res["ok"] = bool(all(same.values()) and g is not None and res["sync_checked_frames"] == g.replays - 1 > 0)
    return res, captured


def host_upload_syncs(torch, np, shape) -> bool:
    """Whether uploading a host frame (what Droid.track does with a numpy
    image) waits for the card: the copy under sync debug mode "warn"."""
    import warnings

    img = np.zeros(shape, np.uint8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.as_tensor(img, device="cuda")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return any("synchroniz" in str(w.message) for w in caught)


# phase 7's rows held captured against eager: mono f32 (culls, skips), RGB-D
# and stereo, with their frames; rows 7 and 8 take 48, not their 24: at 24
# their 8th keyframe, and with it the init, comes last, and no frame would
# run the captured step
CAPTURE_ROWS = {1: None, 7: 48, 8: 48}


def captured_vs_eager(torch, np, Droid, DroidConfig, init_params, evaluate, graph, seed: int, phase5):
    """Phase 5b: the IF node against eager cond (check_graph_cond); then
    phase 5's 47 frames and phase 7's rows 1, 7 and 8 (their track streams
    uploaded to the card first) through compare_engines: the captured
    engine bit for bit the eager one, its frames after the capture free of
    host reads. The bench case is timed over phase 5's window and also held
    against phase 5's own Droid; whether a host frame's upload waits for
    the card is read too."""
    dev = torch.device("cuda")
    res = dict(graph_cond=check_graph_cond(torch, graph, dev))
    cfg = DroidConfig(**BENCH_CONFIG)
    frames, intr = bench_frames(torch, np, cfg, seed)
    stream = [(t, frames[t % len(frames)], None, intr) for t in range(phase5["droid"].counter)]
    bench, droid = compare_engines(torch, np, lambda capture: Droid(cfg, params=init_params(seed), device=dev,
                                                                    capture=capture),
                                   stream, timed=(cfg.warmup + 4, 30), per_frame=False)
    ref = phase5["droid"]
    bench["vs_phase5"] = bool(torch.equal(droid.poses, ref.poses) and torch.equal(droid.disps, ref.disps))
    bench["ok"] = bench["ok"] and bench["vs_phase5"]
    log(f"  bench (phase 5's {len(stream)} frames): {bench}")
    res["cases"] = {"bench": bench}
    for k, n_frames in CAPTURE_ROWS.items():
        config, track, _, _ = protocol_inputs(evaluate, DroidConfig, k, n_frames)

        def on_card(x):
            return None if x is None else torch.as_tensor(np.asarray(x), device=dev)

        stream = [(item[0], on_card(item[1]), on_card(item[2]) if len(item) == 4 else None, on_card(item[-1]))
                  for item in track]
        case, _ = compare_engines(torch, np, lambda capture: Droid(config, weights=str(WEIGHTS), device=dev,
                                                                   capture=capture), stream)
        log(f"  row {k} ({protocol_rows()[k - 1][0]}, {config.compute_dtype}, {len(stream)} frames): {case}")
        res["cases"][f"row {k}"] = case
    res["host_upload_syncs"] = host_upload_syncs(torch, np, (*BENCH_CONFIG["image_size"], 3))
    log(f"  a host frame's upload waits for the card: {res['host_upload_syncs']}")
    res["ok"] = bool(res["graph_cond"]["ok"] and all(c["ok"] for c in res["cases"].values()))
    return res


def main_path(torch, np, kernels, Droid, DroidConfig, init_params, seed: int, out_dir):
    """Phase 5: Droid.track at the bench configuration; returns the result
    and the Droid, which phase 6 terminates."""
    cfg = DroidConfig(**BENCH_CONFIG)
    droid = Droid(cfg, params=init_params(seed), device=torch.device("cuda"))
    frames, intr = bench_frames(torch, np, cfg, seed)
    n_timed = 30
    t, warm_s, elapsed, event_ms, launches, dtype_launches = timed_tracking(
        torch, kernels, droid, frames, intr, cfg.warmup + 4, n_timed)

    poses, disps = droid.poses, droid.disps
    h, w = cfg.feat_size
    res = dict(
        frames=t, keyframes=droid.counter, fps=n_timed / elapsed, timed_s=elapsed,
        event_ms_per_frame=event_ms / n_timed, warmup_s=warm_s, n_edges=len(droid.edges),
        n_inactive=len(droid.inactive_edges),
        finite=bool(torch.isfinite(poses).all() and torch.isfinite(disps).all()),
        shapes_ok=tuple(poses.shape) == (droid.counter, 7) and tuple(disps.shape) == (droid.counter, h, w),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    res.update(graph_launches(droid.graph, {**launches, **dtype_launches}, t - cfg.warmup))
    # frames 0..warmup-1 run eagerly: the probe on frames 1..warmup-1 and the
    # 16 init iterations; the warm-up before the capture runs each side of
    # every branch once (1 probe + 4 + 2 iterations, the cull has no
    # lookup), and the capture records them once more; then every replay
    # runs 1 probe + 4 + 2 iterations. 4 levels each; the probe in f32
    # whatever the compute type.
    # Each update iteration runs two GN steps: a ba_window, a schur_window
    # and a schur_backsub launch each.
    eager = (cfg.warmup - 1) + 16 + 7
    gn_queued, gn_device = 2 * (16 + 6 + 6), 2 * (16 + 6 + 6 * res["replays"])
    gn_kernels = ("ba_window", "schur_window", "schur_backsub")
    res.update(
        expected_launches={"corr_level": 4 * (eager + 7), "corr_level_f32": 4 * (cfg.warmup - 1 + 2),
                           "graph_cond": GRAPH_IF_NODES, **dict.fromkeys(gn_kernels, gn_queued)},
        expected_device_launches={"corr_level": 4 * (eager + 7 * res["replays"]), "corr_level_f32": 4 * t,
                                  "graph_cond": GRAPH_IF_NODES * res["replays"],
                                  **dict.fromkeys(gn_kernels, gn_device)},
    )
    got = {k: res["launches"].get(k) for k in res["expected_launches"]}
    got_device = {k: res["device_launches"].get(k) for k in res["expected_device_launches"]}
    res["ok"] = bool(res["finite"] and res["shapes_ok"] and droid.counter == t
                     and got == res["expected_launches"] and got_device == res["expected_device_launches"]
                     and res["launches"].get("corr_level_bf16") == got["corr_level"] - got["corr_level_f32"]
                     and res["replays"] == t - cfg.warmup and res["graph_launches_per_frame"] == 1.0)
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


def capture_record(stats) -> dict:
    """What a run's captured factor-graph steps cost (runtime/factor_graph.py
    CaptureStats): graphs captured, the most held at once, replays, capture
    seconds and pool bytes."""
    return {k: getattr(stats, k) for k in ("graphs", "held_max", "replays", "capture_s", "pool_bytes")}


def split_launches_ok(launches, expected: int) -> bool:
    return expected > 0 and launches.get("corr_slab") == launches.get("corr_window") == expected


def timed_terminate(torch, np, kernels, droid):
    """One Droid.terminate() with the launch counts set to 0 before it and
    read after it: (the run's record, the trajectory). The split pair must
    run 4 levels x (7 + 12) global-BA steps x the update-operator chunks
    times on the card. A wrapper counts a launch when it queues it, so a
    captured step's launches once, while the card runs them on every
    replay: the card's launches are the wrappers' counts less the captures'
    plus the replays' (Droid.terminate_stats)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = droid.terminate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    launches.update(kernels.DTYPE_LAUNCHES)
    stats = droid.terminate_stats
    steps_x_chunks = sum(steps * chunks for steps, (_, chunks) in zip((7, 12), droid.backend_runs))
    run = dict(
        wall_s=wall, launches=launches, device_launches=stats.device_launches(launches),
        replayed_launches=dict(stats.replayed_launches), capture=capture_record(stats),
        backend_runs=droid.backend_runs, expected_split_launches=4 * steps_x_chunks,
        finite=bool(np.isfinite(traj).all()),
        shape_ok=traj.shape == (droid.counter, 7),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    run["ok"] = bool(run["finite"] and run["shape_ok"]
                     and split_launches_ok(run["device_launches"], run["expected_split_launches"]))
    log(f"  terminate: {run}")
    return run, traj


@contextlib.contextmanager
def sync_checked_replays(torch, graph):
    """Every CUDA graph replay (runtime/graph.py Captured.replay) inside
    runs under sync debug mode "error": a host read there raises. Yields a
    list that holds one entry per replay."""
    real = graph.Captured.replay
    checked = []

    def replay(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(self)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked.append(1)

    graph.Captured.replay = replay
    try:
        yield checked
    finally:
        graph.Captured.replay = real


def terminate_capture_vs_eager(torch, np, graph, droid, stream):
    """Phase 6b: terminate() and terminate(stream) of phase 5's tracked
    state with capture=False and with capture (Droid.capture, which each
    terminate reads), in turns (eager, captured, captured, eager): the
    trajectories, the terminated poses and disparities and each pass's
    edges and chunks bit for bit, every replay under sync debug mode
    "error"; then one terminate() of each under torch.profiler (device
    activity only): each side's device time, and its busy share of that
    side's mean terminate() wall."""
    kept = droid.capture
    runs = {"terminate": [], "terminate_stream": []}
    try:
        for name, arg in (("terminate", None), ("terminate_stream", stream)):
            for capture in (False, True, True, False):
                droid.capture = capture
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with sync_checked_replays(torch, graph) as checked:
                    traj = droid.terminate() if arg is None else droid.terminate(iter(arg))
                torch.cuda.synchronize()
                v = droid.video
                runs[name].append(dict(capture=capture, wall_s=time.perf_counter() - t0, traj=traj,
                                       poses=v.poses[: v.counter].clone(), disps=v.disps[: v.counter].clone(),
                                       backend_runs=droid.backend_runs, stats=capture_record(droid.terminate_stats),
                                       sync_checked_replays=len(checked)))
        device_ms = {}
        for capture in (False, True):
            droid.capture = capture
            device_ms["captured" if capture else "eager"] = profile_terminate(
                torch, droid.terminate, None, None, "")["device_ms"]
    finally:
        droid.capture = kept
    res = dict(cases={}, device_ms=device_ms)
    for name, rs in runs.items():
        first = rs[0]
        same = dict(trajectory=all(np.array_equal(r["traj"], first["traj"]) for r in rs),
                    poses=all(torch.equal(r["poses"], first["poses"]) for r in rs),
                    disps=all(torch.equal(r["disps"], first["disps"]) for r in rs),
                    backend_runs=all(r["backend_runs"] == first["backend_runs"] for r in rs))
        walls = {side: [r["wall_s"] for r in rs if r["capture"] == (side == "captured")]
                 for side in ("eager", "captured")}
        captured = [r for r in rs if r["capture"]]
        case = dict(same=same, walls_s=walls, capture=captured[0]["stats"],
                    sync_checked_replays=[r["sync_checked_replays"] for r in captured])
        # every replay checked, and nothing captured with capture=False
        case["ok"] = bool(all(same.values()) and all(r["stats"]["replays"] > 0 for r in captured)
                          and all(r["sync_checked_replays"] == r["stats"]["replays"] for r in captured)
                          and all(r["stats"]["graphs"] == 0 for r in rs if not r["capture"]))
        res["cases"][name] = case
        log(f"  {name}: walls (eager, captured, captured, eager) "
            + ", ".join(f"{r['wall_s']:.3f}" for r in rs) + f" s, {same}, captured steps {case['capture']}, "
            f"replays under sync debug 'error' {case['sync_checked_replays']}: {'ok' if case['ok'] else 'FAILED'}")
    t = res["cases"]["terminate"]["walls_s"]
    res["busy_share"] = {side: res["device_ms"][side] / (1e3 * sum(t[side]) / len(t[side]))
                         for side in ("eager", "captured")}
    res["ok"] = all(c["ok"] for c in res["cases"].values())
    log(f"  terminate() device ms {res['device_ms']}, busy share of the mean walls {res['busy_share']}")
    return res


def repeat_of(np, runs, trajs):
    """Two terminates of one tracked state must repeat: the same backend
    edge counts and chunks, trajectories within 1e-6."""
    repeat = dict(
        same_backend_runs=runs[0]["backend_runs"] == runs[1]["backend_runs"],
        trajectory_max_diff=float(np.abs(trajs[0] - trajs[1]).max()),
    )
    repeat["ok"] = bool(repeat["same_backend_runs"] and repeat["trajectory_max_diff"] <= 1e-6)
    log(f"  repeat: {repeat}")
    return repeat


def terminate_path(torch, np, kernels, graph, droid, seed: int, out_dir):
    """Phase 6: Droid.terminate() twice on phase 5's Droid, which must
    repeat (the same backend edge counts and chunks, trajectories within
    1e-6), then once more under torch.profiler; then phase 6b, the
    captured terminate against capture=False, with phase 5's frames as the
    fill stream. Also returns, apart from the record, what phase 10a
    compares its sharded terminate with: the tracked poses, and the
    trajectory, poses and disparities after the first terminate, on the
    host."""
    tracked = droid.poses.cpu()
    runs, trajs = [], []
    for k in range(2):
        run, traj = timed_terminate(torch, np, kernels, droid)
        runs.append(run)
        trajs.append(traj)
        if k == 0:
            v = droid.video
            ref = dict(frames=droid.counter, tracked_poses=tracked, traj=traj,
                       poses=v.poses[: v.counter].cpu(), disps=v.disps[: v.counter].cpu())
    repeat = repeat_of(np, runs, trajs)

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

    log("phase 6b: the captured terminate vs capture=False, bit for bit, no host read in a replay")
    cfg = droid.config
    frames, intr = bench_frames(torch, np, cfg, seed)
    stream = [(t, frames[t % len(frames)].cpu().numpy(), intr.cpu().numpy()) for t in range(droid.counter)]
    versus = terminate_capture_vs_eager(torch, np, graph, droid, stream)
    return dict(runs=runs, repeat=repeat, profile=profile_res, keyframes=droid.counter, capture_vs_eager=versus,
                ok=all(r["ok"] for r in runs) and repeat["ok"] and versus["ok"]), ref


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


def protocol_inputs(evaluate, DroidConfig, k: int, frames: Optional[int] = None):
    """Phase 7's row k (1-8): its DroidConfig and its track, fill and
    reference streams (``frames`` of them, default the row's)."""
    mode, seed, dtype, _ = protocol_rows()[k - 1]
    mono = mode == "mono"
    n, size = (MONO_FRAMES, MONO_SIZE) if mono else (METRIC_FRAMES, METRIC_SIZE)
    frames = frames or n
    track, fill, ref = evaluate.synthetic_streams(seed, frames, size, stereo=mode == "stereo",
                                                  rgbd=mode == "rgbd")
    config = DroidConfig(image_size=size, buffer=96 if mono else 64, warmup=8,
                         stereo=mode == "stereo", compute_dtype=dtype)
    return config, track, fill, ref


def protocol_row(torch, np, kernels, evaluate, DroidConfig, k: int, fused: bool = True):
    """Phase 7's row k (1-8) through run_slam with the fused engine, or with
    the host-driven one (phase 8c), with the launch counts reset before it
    and read after it. Returns (the row's result, the Droid, the fill
    stream)."""
    mode, seed, dtype, bound = protocol_rows()[k - 1]
    mono = mode == "mono"
    frames, size = (MONO_FRAMES, MONO_SIZE) if mono else (METRIC_FRAMES, METRIC_SIZE)
    config, track, fill, ref = protocol_inputs(evaluate, DroidConfig, k)
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


def profile_terminate(torch, terminate, wall_s: float, out_dir, name: str):
    """One more terminate of a Droid (``terminate()``: phase 7's row's
    terminate(fill), phase 12b's long loop's) under
    torch.profiler, recording device activity only: device ms and launches
    by kernel, summed from the profiler's raw events (an f32 terminate with
    TF32 off launches ~3e5 kernels, and building the profiler's own event
    tree for them, with host ops beside, takes over a minute), and the busy
    share of the profiled run. cost_s is what the profile adds to its
    phase: the profiled terminate and the reading of its events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        terminate()
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
        row_terminate_wall_ms=None if wall_s is None else wall_s * 1e3, launches=sum(calls.values()),
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
            row["terminate_profile"] = profile_terminate(torch, lambda: droid.terminate(iter(fill)),
                                                         row["terminate_s"], out_dir,
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
    5's frames, with its factor graph's steps captured: the launch counts
    of the 42 tracked frames (every lookup of the host engine reads the
    f32 video features; on the card, the wrappers' counts less the
    captures' plus the replays'), 5 more frames under torch.profiler, one
    terminate() (the split pair); the same 47 frames and terminate() through
    Droid(fused=False, capture=False), timed over the same window and held
    bit for bit (keyframes, edges, poses, disparities, the trajectory);
    then export_map and the consistent point cloud of the terminated video
    on the card against the same on CPU copies."""
    import tempfile
    from types import SimpleNamespace

    cfg = DroidConfig(**BENCH_CONFIG)
    frames, intr = bench_frames(torch, np, cfg, seed)
    n_timed = 30
    droid = Droid(cfg, params=init_params(seed), device=torch.device("cuda"), fused=False)
    t, warm_s, elapsed, _, launches, dtype_launches = timed_tracking(
        torch, kernels, droid, frames, intr, cfg.warmup + 4, n_timed)
    stats = droid.frontend.graph.stats
    # the probe on every frame after the first, 16 initialisation
    # iterations, 4 + 2 per keyframe after the warmup (no cull); 4 levels each
    lookups = (t - 1) + 16 + (cfg.frontend_iters1 + cfg.frontend_iters2) * (t - cfg.warmup)
    device = stats.device_launches({**launches, **dtype_launches})
    res = dict(
        frames=t, keyframes=droid.counter, fps=n_timed / elapsed, timed_s=elapsed, warmup_s=warm_s,
        launches=launches, dtype_launches=dtype_launches, device_launches=device, capture=capture_record(stats),
        n_edges=len(droid.edges), n_inactive=len(droid.inactive_edges), expected_f32_launches=4 * lookups,
        finite=bool(torch.isfinite(droid.poses).all() and torch.isfinite(droid.disps).all()),
    )
    res["tracking_ok"] = bool(res["finite"] and droid.counter == t and stats.replays > 0
                              and device["corr_level"] == res["expected_f32_launches"]
                              and device.get("corr_level_f32") == res["expected_f32_launches"]
                              and "corr_level_bf16" not in dtype_launches)
    log(f"  tracking: {res}")
    res["profile"] = profile_tracking(torch, droid, frames, intr, t, res["fps"], out_dir, "profile_host")
    log(f"  profile: {res['profile']}; device busy share {res['profile']['device_busy_share']:.3f} "
        f"(fused engine, phase 5: {fused_busy_share:.3f})")

    # the same frames (the timed window, then the profiled ones) eagerly
    eager = Droid(cfg, params=init_params(seed), device=torch.device("cuda"), fused=False, capture=False)
    _, _, elapsed, *_ = timed_tracking(torch, kernels, eager, frames, intr, cfg.warmup + 4, n_timed)
    for k in range(t, t + 5):
        eager.track(k, frames[k % len(frames)], intrinsics=intr)
    eager.sync()
    res["eager_fps"] = n_timed / elapsed
    same = dict(keyframes=eager.counter == droid.counter, tstamps=torch.equal(eager.tstamps, droid.tstamps),
                poses=torch.equal(eager.poses, droid.poses), disps=torch.equal(eager.disps, droid.disps),
                edges=eager.edges == droid.edges, inactive_edges=eager.inactive_edges == droid.inactive_edges)

    term, trajs = {}, {}
    for name, d in (("captured", droid), ("eager", eager)):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        trajs[name] = d.terminate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        queued = {**kernels.LAUNCHES, **kernels.DTYPE_LAUNCHES}
        steps_x_chunks = sum(steps * chunks for steps, (_, chunks) in zip((7, 12), d.backend_runs))
        term[name] = dict(wall_s=wall, keyframes=d.counter, backend_runs=d.backend_runs, launches=queued,
                          device_launches=d.terminate_stats.device_launches(queued),
                          capture=capture_record(d.terminate_stats),
                          expected_split_launches=4 * steps_x_chunks, finite=bool(np.isfinite(trajs[name]).all()))
        term[name]["ok"] = bool(term[name]["finite"] and trajs[name].shape == (d.counter, 7)
                                and split_launches_ok(term[name]["device_launches"],
                                                      term[name]["expected_split_launches"]))
        log(f"  terminate ({name}): {term[name]}")
    same["trajectory"] = bool(np.array_equal(trajs["captured"], trajs["eager"]))
    same["terminated_poses"] = torch.equal(droid.video.poses, eager.video.poses)
    term = dict(term["captured"], eager=term["eager"])
    term["ok"] = bool(term["ok"] and term["eager"]["ok"])
    res["terminate"] = term
    res["capture_vs_eager"] = dict(same=same, ok=all(same.values()))
    log(f"  captured vs capture=False: {same}; {res['fps']:.2f} vs {res['eager_fps']:.2f} frames/s; terminate "
        f"{term['wall_s']:.3f} vs {term['eager']['wall_s']:.3f} s")

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
    res["ok"] = bool(res["tracking_ok"] and term["ok"] and vis["ok"] and res["capture_vs_eager"]["ok"])
    return res


def host_cull_replay(torch, np, Droid, DroidConfig, render_sequence, graph):
    """Phase 8b: the cull replay of tests/test_engine_equivalence.py:149-195
    through the host engine on the card (its factor graph's steps captured,
    every replay under sync debug mode "error"), the host engine on the
    card with capture=False, the fused engine on the card and the host
    engine on the CPU: the same keyframes after every frame, at least one
    cull, poses within 5e-3 of the first run's; the two host engines on the
    card bit for bit (keyframes, edges, poses, disparities)."""
    seq = render_sequence(np.random.default_rng(7), n_frames=CULL_FRAMES, image_size=CULL_CONFIG["image_size"],
                          t_sigma=0.25, r_sigma=0.02)
    runs, droids = {}, {}
    for name, device, fused, capture in (("host_gpu", "cuda", False, True), ("host_gpu_eager", "cuda", False, False),
                                         ("fused_gpu", "cuda", True, True), ("host_cpu", "cpu", False, True)):
        d = droids[name] = Droid(DroidConfig(**CULL_CONFIG), weights=str(FIXTURE_WEIGHTS), device=device,
                                 fused=fused, capture=capture)
        hist = []
        t0 = time.perf_counter()
        with sync_checked_replays(torch, graph) if name == "host_gpu" else contextlib.nullcontext([]) as checked:
            for t in range(CULL_FRAMES):
                d.track(t, seq["images"][t], intrinsics=seq["intrinsics"][t])
                hist.append(d.tstamps.tolist())
        runs[name] = dict(hist=hist, poses=d.poses.cpu().numpy(), wall_s=time.perf_counter() - t0,
                          sync_checked_replays=len(checked))
    ref = runs["host_gpu"]
    host, eager = droids["host_gpu"], droids["host_gpu_eager"]
    stats = host.frontend.graph.stats
    res = dict(keyframes=len(ref["hist"][-1]), tstamps=ref["hist"][-1],
               walls_s={k: r["wall_s"] for k, r in runs.items()}, first_flip={}, pose_err={},
               capture=capture_record(stats), sync_checked_replays=ref["sync_checked_replays"],
               capture_vs_eager=dict(hist=runs["host_gpu_eager"]["hist"] == ref["hist"],
                                     poses=torch.equal(host.poses, eager.poses),
                                     disps=torch.equal(host.disps, eager.disps),
                                     edges=host.edges == eager.edges,
                                     inactive_edges=host.inactive_edges == eager.inactive_edges))
    for name in ("fused_gpu", "host_cpu"):
        flip = next((t for t in range(CULL_FRAMES) if runs[name]["hist"][t] != ref["hist"][t]), None)
        res["first_flip"][name] = None if flip is None else dict(
            frame=flip, host_gpu=ref["hist"][flip], other=runs[name]["hist"][flip])
        if flip is None:
            res["pose_err"][name] = float(np.abs(runs[name]["poses"] - ref["poses"]).max())
    res["same_keyframes"] = all(f is None for f in res["first_flip"].values())
    res["ok"] = bool(res["same_keyframes"] and res["keyframes"] < CULL_FRAMES
                     and all(e < 5e-3 for e in res["pose_err"].values())
                     and all(res["capture_vs_eager"].values())
                     and 0 < stats.replays == res["sync_checked_replays"])
    log(f"  cull replay (fixture weights, {CULL_FRAMES} frames, 96x128): {res}")
    return res


def host_engine(torch, np, kernels, Droid, DroidConfig, init_params, visualization, evaluate,
                render_sequence, graph, seed: int, out_dir, fused_busy_share: float, row1_keyframes: int):
    """Phase 8: the host-driven engine. 8a at the bench configuration, 8b
    the cull replay, 8c phase 7's row 1 through the host engine."""
    log("phase 8a: host engine at the bench configuration")
    bench = host_engine_path(torch, np, kernels, Droid, DroidConfig, init_params, visualization, seed,
                             out_dir, fused_busy_share)
    log("phase 8b: cull replay, host engine (card, CPU) and fused engine (card)")
    cull = host_cull_replay(torch, np, Droid, DroidConfig, render_sequence, graph)
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


def check_backward_kernel(torch, corr, pops, dev, seed: int, N: int = 208, h: int = 48, w: int = 64,
                          kinds=("iid", "smooth", "far"), timed: bool = True):
    """Phase 9a: corr_level_backward (csrc/corr_backward.cu: the sort, df1
    and df2 launches of corr_backward_plan) against autograd through
    corr_level_ref at the training path's shapes (208 edges = batch 4 x 52
    slots, 48x64 down to 6x8, C=128, f32) with iid (timed if `timed`, each
    launch by name too, with the plain version, the grid_sample yardstick
    and the bound), smooth and far-out coords; each case runs twice and
    must repeat bitwise. At level 0 of each kind the allocator's peak
    during one backward must stay within BACKWARD_MEMORY_SLACK of its
    outputs and scratch: no dense volume gradient."""
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    C = 128
    fmap1 = torch.randn((N, h, w, C), generator=g, device=dev)
    fmap2 = torch.randn((N, h, w, C), generator=g, device=dev)
    cases = []
    for kind in kinds:
        coords = make_coords(torch, pops, kind, N, h, w, g, dev)
        for lvl, (f1, f2, c) in enumerate(corr.lookup_levels(fmap1, fmap2, coords)):
            gout = torch.randn((N, f1.shape[1], 49), generator=g, device=dev)
            refs = corr.corr_level_backward_ref(gout, f1, f2, c)
            plan = corr.corr_backward_plan(N, f1.shape[1], f2.shape[1], f2.shape[2], C)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs = corr.corr_level_backward(gout, f1, f2, c)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            # df1, df2, dPatch [N, P, 64] f32, perm [N, P] and starts [N, bins + 1] int32
            need = 4 * (f1.numel() + f2.numel() + N * f1.shape[1] * 64 + N * f1.shape[1] + N * (plan.bins + 1))
            outs2 = corr.corr_level_backward(gout, f1, f2, c)
            torch.cuda.synchronize()
            res = {name: compare(torch, o, o2, r) for name, o, o2, r in zip(("df1", "df2"), outs, outs2, refs)}
            del refs, outs, outs2
            case = dict(kind=kind, level=lvl, N=N, P=f1.shape[1], H2=f2.shape[1], W2=f2.shape[2], C=C,
                        max_abs_err={k: r[0] for k, r in res.items()},
                        max_abs_ref={k: r[1] for k, r in res.items()},
                        bitwise_repeat=all(r[3] for r in res.values()),
                        launches=len(plan.grids), grids=list(plan.grids), peak_bytes=peak, need_bytes=need)
            case["memory_ok"] = lvl > 0 or peak <= (1 + BACKWARD_MEMORY_SLACK) * need
            case["ok"] = case["memory_ok"] and all(r[2] and r[3] and r[0] <= KERNEL_TOL * r[1]
                                                   for r in res.values())
            msg = (f"  corr_backward {kind:6s} L{lvl} [{N},{f1.shape[1]},{C}]x[{f2.shape[1]}x{f2.shape[2]}]: "
                   + ", ".join(f"{k} max_err {r[0]:.3e} (tol {KERNEL_TOL * r[1]:.3e})" for k, r in res.items())
                   + f", {case['launches']} launches (blocks {case['grids']}), repeat "
                   f"{'bitwise' if case['bitwise_repeat'] else 'DIFFERS'}")
            if lvl == 0:
                msg += (f", peak {peak / 1e6:.1f} MB for {need / 1e6:.1f} MB of outputs and scratch "
                        f"({'ok' if case['memory_ok'] else 'OVER'})")
            if timed and kind == "iid":
                per = {}
                case["ms"] = device_ms(torch, lambda: corr.corr_level_backward(gout, f1, f2, c), reps=5,
                                       by_kernel=per)
                case["launch_ms"] = {stage: sum(v for k, v in per.items() if tag in k) for stage, tag in
                                     zip(corr.BACKWARD_STAGES, ("corr_sort_kernel", "df1_kernel", "df2_kernel"))}
                case["plain_ms"] = device_ms(torch, lambda: corr.corr_level_backward_ref(gout, f1, f2, c),
                                             reps=2, warm=1)
                case["library_ms"], case["grid_sample_err"], scale = grid_sample_backward(
                    torch, corr, f1, f2, c, gout)
                case["grid_sample_ok"] = case["grid_sample_err"] <= KERNEL_TOL * scale
                nbytes, ops = corr_backward_cost(torch, f1, f2, c)
                case.update(bytes=nbytes, ops=ops)
                case["bound_ms"], case["bound_by"] = bound(nbytes, ops, "float32")
                msg += (f" kernel {case['ms']:.4f} ms ("
                        + ", ".join(f"{k} {v:.4f}" for k, v in case["launch_ms"].items()) + ") plain "
                        f"{case['plain_ms']:.4f} ms bound "
                        f"{case['bound_ms']:.4f} ms ({case['bound_by']}), grid_sample backward "
                        f"{case['library_ms']:.4f} ms (forward max_err {case['grid_sample_err']:.2e})")
            cases.append(case)
            log(msg)
            torch.cuda.empty_cache()
    if not timed:
        return cases
    iid = [c for c in cases if c["kind"] == "iid"]
    log(f"  corr_backward iid, 4 levels at {N} edges: {sum(c['ms'] for c in iid):.4f} ms ("
        + ", ".join(f"{k} {sum(c['launch_ms'][k] for c in iid):.4f}" for k in corr.BACKWARD_STAGES)
        + f"), plain {sum(c['plain_ms'] for c in iid):.4f} ms, bound {sum(c['bound_ms'] for c in iid):.4f} ms, "
        f"grid_sample backward {sum(c['library_ms'] for c in iid):.4f} ms; launches per level "
        f"{[c['launches'] for c in iid]}")
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

    def ms(*needles, skip=()):
        return sum(v for k, v in us.items()
                   if any(s in k for s in needles) and not any(s in k for s in skip)) / 1e3

    # cuDNN's FFT convolution: its FFT kernels, its pointwise complex
    # products and the complex (cf32) GEMMs it calls; gemm_ms the real GEMMs
    fft_conv = ms("cf32cf32", "fft", "_complex")
    total = sum(us.values()) / 1e3
    # a profile short of kernel records (dropped) reads too little device time
    return dict(device_ms=total, launches=sum(calls.values()),
                kernel_records=records, kernel_launches=launches, complete=records >= launches > 0,
                corr_level_ms=ms("corr_level_f32"), corr_sort_ms=ms("corr_sort"),
                corr_backward_ms=ms("corr_backward"), gemm_ms=ms("gemm", skip=("cf32cf32",)),
                fft_conv_ms=fft_conv, fft_conv_share=fft_conv / total,
                conv_ms=ms("conv", "implicit", "wgrad", "dgrad", skip=("cf32cf32", "fft", "_complex")),
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
    per_lookup = sum(len(port.corr.corr_backward_plan(n_slots, h * w, h >> l, w >> l, 128).grids)
                     for l in range(4))
    res = dict(steps=len(hist), passes=passes, render_s=render_s, wall_s=wall,
               step_walls_s=[x["wall_s"] for x in hist], losses=[x["metrics"]["loss"] for x in hist],
               n_valid_edges=[x["n_valid_edges"] for x in hist], launches=launches,
               expected_corr_level_f32=4 * args.iters * passes,
               expected_corr_backward=args.iters * passes * per_lookup, backward_launches_per_lookup=per_lookup,
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


# -----------------------------------------------------------------------------
# phase 10: the distributed paths as 1-rank groups
# -----------------------------------------------------------------------------

# 10a: the sharded terminate against the single-device one, within the
# bounds that tests/test_torch_droid_mesh.py sets for the same comparison at
# the same compute dtype (copied: this script imports nothing of the tests).
# SHARDED_VS_SINGLE_TOL: the small replay's (f32) terminate against the same
# Droid's single-device terminate, absolute (its terminate(stream) within
# phase 4's 5e-3, as the filler amplifies); the bench configuration's (bf16,
# where the single-device BA stores the Schur blocks E in bf16 and the
# sharded one in f32) against phase 6's, relative to the largest |pose| and
# |disparity| of phase 6's run. SHARDED_VS_F32_TOL: the bench sharded
# terminate against the same Droid's single-device terminate with E stored
# in f32, absolute
SHARDED_VS_SINGLE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.02, 0.02)}  # (poses, disps)
SHARDED_VS_F32_TOL = 1e-4
STREAM_TOL = 5e-3
# 10b: one optimizer step of apps/train.py at phase 9b's shapes (batch 2, 4
# frames at 64x96, 3 iterations); --seed 0 draws the default graph and one
# pass, and the checkpoint of step 1 holds the parameters
DP_ARGV = ["--synthetic", "--steps", "1", "--batch", "2", "--n_frames", "4", "--iters", "3", "--crop", "64", "96",
           "--pool", "0", "--seed", "0", "--ckpt_every", "1", "--name", "dp"]
ALLREDUCE_REPS = 20


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_rank_groups(torch):
    """The default process group, NCCL on this card, world size 1, at a free
    port on 127.0.0.1, and a gloo group of the same rank for CPU tensors:
    {"cuda": group, "cpu": group}."""
    import datetime

    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120), device_id=dev)
    return {"cuda": dist.group.WORLD, "cpu": dist.new_group(backend="gloo")}


def sharded_terminate(torch, np, kernels, Droid, DroidConfig, init_params, seed: int, groups, ref):
    """Phase 10a: phase 4's replay with each Droid's BA sharded over its
    device's group (held to phase 4's bounds, and each device's terminate
    to the same Droid's single-device one within the f32
    SHARDED_VS_SINGLE_TOL, its terminate(stream) within STREAM_TOL); then
    phase 5's frames at the bench configuration tracked by Droid(ba_mesh=)
    on the card, warm_terminate(), and terminate() twice: the two must
    repeat, launch the split pair 4 x 19 x chunks times each, agree with
    phase 6's single-device terminate within the bf16
    SHARDED_VS_SINGLE_TOL, and with the same Droid's single-device
    terminate with the Schur blocks E stored in f32, as the sharded BA
    stores them, within SHARDED_VS_F32_TOL."""
    from droid_slam_tpu_torch.ops import ba as ba_ops

    t0 = time.perf_counter()
    small = small_replay(torch, np, Droid, DroidConfig, init_params, seed, meshes=groups)
    small_s = time.perf_counter() - t0
    tol32 = SHARDED_VS_SINGLE_TOL[SMALL_CONFIG["compute_dtype"]][0]
    small["vs_single_ok"] = all(term <= tol32 and fill <= STREAM_TOL
                                for term, fill in small["vs_single_device"].values())

    cfg = DroidConfig(**BENCH_CONFIG)
    droid = Droid(cfg, params=init_params(seed), device=torch.device("cuda"), ba_mesh=groups["cuda"])
    frames, intr = bench_frames(torch, np, cfg, seed)
    t0 = time.perf_counter()
    for t in range(ref["frames"]):
        droid.track(t, frames[t % len(frames)], intrinsics=intr)
    droid.sync()
    track_s = time.perf_counter() - t0
    tracked_diff = float((droid.poses.cpu() - ref["tracked_poses"]).abs().max()) \
        if droid.counter == ref["frames"] else float("inf")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    droid.warm_terminate()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    runs, trajs = [], []
    for k in range(2):
        run, traj = timed_terminate(torch, np, kernels, droid)
        runs.append(run)
        trajs.append(traj)
        if k == 0:
            v = droid.video
            poses, disps = v.poses[: v.counter].cpu(), v.disps[: v.counter].cpu()
    repeat = repeat_of(np, runs, trajs)
    rel_p, rel_d = SHARDED_VS_SINGLE_TOL[cfg.compute_dtype]
    same_shape = poses.shape == ref["poses"].shape
    vs = dict(
        keyframes=droid.counter, tracked_pose_diff=tracked_diff,
        same_backend_runs=runs[0]["backend_runs"] == ref["backend_runs"],
        pose_diff=float((poses - ref["poses"]).abs().max()) if same_shape else float("inf"),
        disp_diff=float((disps - ref["disps"]).abs().max()) if same_shape else float("inf"),
        trajectory_diff=float(np.abs(trajs[0] - ref["traj"]).max()) if same_shape else float("inf"),
        pose_max=float(ref["poses"].abs().max()), disp_max=float(ref["disps"].abs().max()),
    )
    vs["tol"] = dict(poses=rel_p * vs["pose_max"], disps=rel_d * vs["disp_max"], relative=(rel_p, rel_d),
                     compute_dtype=cfg.compute_dtype)
    vs["ok"] = bool(vs["pose_diff"] <= vs["tol"]["poses"] and vs["disp_diff"] <= vs["tol"]["disps"])

    solve = ba_ops.ba_solve
    droid.ba_mesh, mesh = None, droid.ba_mesh
    ba_ops.ba_solve = lambda *a, schur_dtype=None, **k: solve(*a, **k)  # E in f32
    try:
        traj_f32 = droid.terminate()
    finally:
        ba_ops.ba_solve, droid.ba_mesh = solve, mesh
    v = droid.video
    pin = dict(pose_diff=float((poses - v.poses[: v.counter].cpu()).abs().max()),
               disp_diff=float((disps - v.disps[: v.counter].cpu()).abs().max()),
               trajectory_diff=float(np.abs(trajs[0] - traj_f32).max()),
               same_backend_runs=droid.backend_runs == runs[0]["backend_runs"], tol=SHARDED_VS_F32_TOL)
    pin["ok"] = bool(pin["same_backend_runs"] and max(pin["pose_diff"], pin["disp_diff"]) <= SHARDED_VS_F32_TOL)
    log(f"  small replay, sharded (card NCCL, CPU gloo): {small['ok']} in {small_s:.1f} s; terminate and "
        f"terminate(stream) vs the same Droid's single-device ones {small['vs_single_device']} (bounds {tol32}, "
        f"{STREAM_TOL})")
    log(f"  bench: {droid.counter} keyframes tracked in {track_s:.1f} s (tracked poses vs phase 5: "
        f"{tracked_diff:.3e}); warm_terminate {warm_s:.3f} s; terminate walls "
        + ", ".join(f"{r['wall_s']:.3f}" for r in runs) + " s")
    log(f"  vs phase 6's single-device terminate: {vs}")
    log(f"  vs the single-device terminate with E in f32: {pin}")
    return dict(small_replay=small, small_s=small_s, track_s=track_s, warm_terminate_s=warm_s, runs=runs,
                repeat=repeat, vs_single_device=vs, vs_single_device_f32=pin,
                ok=bool(small["ok"] and small["vs_single_ok"] and all(r["ok"] for r in runs) and repeat["ok"]
                        and vs["ok"] and pin["ok"]))


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (warn only: the warnings name the operations that have no
    deterministic implementation), the previous settings restored after."""
    import warnings

    import torch.utils.deterministic as tud

    prev = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, tud.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    tud.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[2], prev[3]
        tud.fill_uninitialized_memory = prev[4]


def data_parallel_training(torch, np, port, seed: int, groups):
    """Phase 10b: one optimizer step of apps/train.py's train() at phase
    9b's shapes through the 1-rank NCCL group against the same step without
    a group, in deterministic mode: the parameters must be bit for bit
    equal (a 1-rank all-reduce and a division by 1 change nothing), and the
    group's step must launch corr_level_f32 and the backward. Then the flat
    gradient all-reduce at full width (every DroidNet parameter), timed
    with CUDA events."""
    import tempfile

    args = port.train_app.parser().parse_args(DP_ARGV)
    dev = torch.device("cuda")

    def step(group):
        db = port.SyntheticDataset(n_frames=args.n_frames, image_size=tuple(args.crop), seed=seed, pool=0)
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            port.kernels.reset_launches()
            t0 = time.perf_counter()
            hist = port.train_app.train(args, db, dev, log=lambda msg: None, group=group)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(port.kernels.DTYPE_LAUNCHES)
            params = port.checkpoints.load_params("checkpoints/dp_000001.pth")
        return hist, launches, params, wall

    with deterministic(torch) as caught:
        plain = step(None)
        grouped = step(groups["cuda"])
    notes = sorted({str(w.message).split("\n")[0][:160] for w in caught})
    differ = [k for k in plain[2] if not torch.equal(plain[2][k], grouped[2][k])]
    res = dict(
        passes=[h["passes"] for h in grouped[0]], losses=dict(plain=plain[0][0]["metrics"]["loss"],
                                                             group=grouped[0][0]["metrics"]["loss"]),
        walls_s=dict(plain=plain[3], group=grouped[3]), launches_group=grouped[1], launches_plain=plain[1],
        params=len(plain[2]), params_differing=differ, nondeterministic_warnings=notes,
    )

    model = port.DroidNet().to(dev)
    grads = {n: torch.randn_like(p) for n, p in model.named_parameters()}
    n_values = sum(g.numel() for g in grads.values())
    reduced = port.trainer.allreduce_gradients(grads, groups["cuda"])
    ms = cuda_ms(torch, lambda: port.trainer.allreduce_gradients(grads, groups["cuda"]), reps=ALLREDUCE_REPS)
    res["allreduce"] = dict(tensors=len(grads), values=n_values, mb=4 * n_values / 1e6, ms=ms,
                            bitwise=all(torch.equal(reduced[k], g) for k, g in grads.items()))
    res["ok"] = bool(not differ and res["allreduce"]["bitwise"] and res["losses"]["plain"] == res["losses"]["group"]
                     and grouped[1].get("corr_level_f32", 0) > 0 and grouped[1].get("corr_backward_f32", 0) > 0
                     and grouped[1] == plain[1])
    log(f"  data-parallel step (1 rank) vs plain: {res}")
    return res


def distributed_paths(torch, np, kernels, Droid, DroidConfig, init_params, port, seed: int, ref):
    """Phase 10: the 1-rank groups, 10a and 10b, and the groups destroyed
    after, so no process group outlives the phase."""
    import torch.distributed as dist

    groups = one_rank_groups(torch)
    try:
        log("phase 10a: sharded terminate, Droid(ba_mesh=) on a 1-rank NCCL group")
        terminate = sharded_terminate(torch, np, kernels, Droid, DroidConfig, init_params, seed, groups, ref)
        log("phase 10b: data-parallel training step on the 1-rank NCCL group")
        training = data_parallel_training(torch, np, port, seed, groups)
    finally:
        dist.destroy_process_group()
    return dict(terminate=terminate, training=training, ok=terminate["ok"] and training["ok"])


# -----------------------------------------------------------------------------
# phase 11: the file-based data layer and its apps
# -----------------------------------------------------------------------------

# the fixtures: one rendered sequence at TartanAir's frame size, whose focal
# gives TartanAir's fixed intrinsics (320, 320, 320, 240) (the reader's
# calib_read), with the synthetic protocol's motion: the flow between
# consecutive frames spans ~12-140 px at 480x640 (median ~46), so most
# pairs pass the reader's fmin 8 < flow < fmax 96 filter
FILE_SIZE = (480, 640)
FILE_FOCAL = 320.0
FILE_FRAMES = 40
FILE_MOTION = dict(t_sigma=0.25, r_sigma=0.02)
DEMO_SIZE = (384, 512)  # apps/demo.py's default working area, H x W
TARTAN_SIZE = (384, 512)  # tartanair_stream's frames
# pose_left.txt holds TartanAir's NED columns, which the reader permutes with
# [1, 2, 0, 4, 5, 3, 6]; this is the inverse. Translations and depths are
# stored x DEPTH_SCALE, which the reader divides out
TARTAN_FROM_CAMERA = [2, 0, 1, 5, 3, 4, 6]
TARTAN_DEPTH_SCALE = 5.0
# 11d: apps/train.py --datapath at the JAX trainer's defaults (384x512 crops,
# 7 frames, 15 iterations, batch 4, 24 edges), 2 optimizer steps from the
# shipped weights; --seed 0 draws the default graph, then a randomised one
TARTAN_TRAIN_ARGV = ["--steps", "2", "--seed", "0", "--ckpt_every", "1000000", "--name", "tartan"]
# 11b-c: the apps' trajectories against the same frames fed in memory: bit
# for bit; a gap (two f32 Droids in one process once differed by 2e-6,
# cuDNN's first calls being the suspect) is recorded and held to phase 4's
# bound
FILE_TOL = 5e-3
RECONSTRUCTION_FILES = ("tstamps", "images", "disps", "poses", "intrinsics")


def png_bytes(rgb) -> bytes:
    """An 8-bit RGB PNG of ``rgb`` [H, W, 3] uint8: filter 0 on every row,
    one zlib IDAT, and IHDR/IDAT/IEND with their CRCs."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in rgb)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_file_fixtures(np, render_sequence, root: Path, seed: int, size=FILE_SIZE, frames: int = FILE_FRAMES,
                        focal: float = FILE_FOCAL):
    """Phase 11a: render one sequence and write it twice under ``root``:
    a TartanAir scene, tartan/env/env/Easy/P000/ with image_left/NNNNNN_left.png
    (and each frame's .npy twin), depth_left/NNNNNN_left_depth.npy and
    pose_left.txt; and a demo folder, demo/images/NNNNNN.png with
    demo/calib.txt in calib/tartan.txt's format. Returns the paths and the
    rendered sequence."""
    seq = render_sequence(np.random.default_rng(seed), n_frames=frames, image_size=tuple(size), focal=focal,
                          **FILE_MOTION)
    scene = root / "tartan" / "env" / "env" / "Easy" / "P000"
    imagedir = root / "demo" / "images"
    for d in (scene / "image_left", scene / "depth_left", imagedir):
        d.mkdir(parents=True, exist_ok=True)
    for k in range(frames):
        png = png_bytes(np.ascontiguousarray(seq["images"][k]))
        (scene / "image_left" / f"{k:06d}_left.png").write_bytes(png)
        (imagedir / f"{k:06d}.png").write_bytes(png)
        np.save(scene / "image_left" / f"{k:06d}_left.npy", seq["images"][k])
        np.save(scene / "depth_left" / f"{k:06d}_left_depth.npy", seq["depths"][k] * TARTAN_DEPTH_SCALE)
    poses = seq["poses"].astype(np.float64)
    poses[:, :3] *= TARTAN_DEPTH_SCALE
    np.savetxt(scene / "pose_left.txt", poses[:, TARTAN_FROM_CAMERA], delimiter=" ")
    calib = root / "demo" / "calib.txt"
    calib.write_text(" ".join(str(float(x)) for x in seq["intrinsics"][0]) + "\n")
    return dict(seq=seq, tartan_root=root / "tartan", scene=scene, imagedir=imagedir, calib=calib)


def decoder_finding(native_loader):
    """Phase 11-0: what this machine decodes. The headers decide, before any
    build: with png.h and jpeglib.h on the compiler's include path the
    native library must build. Then whether it built (the compiler's error
    where it did not) and whether cv2 imports."""
    headers = native_loader.decoder_headers()
    native = native_loader.available()
    try:
        import cv2

        cv2_version = cv2.__version__
    except ImportError:
        cv2_version = None
    error = native_loader.build_error() or ""
    errors = [line.strip() for line in error.splitlines() if "error" in line]
    res = dict(headers=headers, native=native, build_error=error, cv2=cv2_version,
               decoder="native" if native else ("cv2" if cv2_version else None))
    res["ok"] = bool(native or not all(headers.values()))
    log("  decoders: " + ", ".join(f"{h} {'found' if ok else 'missing'}" for h, ok in headers.items())
        + f"; native library {'built' if native else 'not built'}"
        + ("" if native else f" ({errors[0] if errors else error[:200]!r})")
        + f"; cv2 {cv2_version or 'does not import'}; images decode with {res['decoder'] or 'nothing'}"
        + ("" if res["ok"] else ": FAILED, the headers are present and the build failed"))
    return res


def _launch_line(kernels) -> str:
    return ", ".join(f"{k} {n}" for k, n in sorted({**kernels.LAUNCHES, **kernels.DTYPE_LAUNCHES}.items()) if n)


def _against(np, traj, ref):
    diff = float(np.abs(traj - ref).max()) if traj.shape == ref.shape else float("inf")
    return dict(bitwise=bool(traj.shape == ref.shape and np.array_equal(traj, ref)), max_diff=diff,
                tol=FILE_TOL, within_tol=diff <= FILE_TOL)


def demo_from_files(torch, np, port, fx, root: Path, device: str = "cuda"):
    """Phase 11b: apps/demo.py's main on the demo folder at the default
    384x512 area with the shipped weights, --stride 1 and a reconstruction,
    with the launch counts reset before it and read after it; its
    trajectory against a Droid of the same configuration fed the rendered
    frames in memory, resized as the stream resizes them
    (streams._resize_to_area: the native library, else cv2)."""
    recon = root / "reconstruction"
    argv = ["--imagedir", str(fx["imagedir"]), "--calib", str(fx["calib"]), "--weights", str(WEIGHTS),
            "--stride", "1", "--image_size", *map(str, DEMO_SIZE), "--reconstruction_path", str(recon),
            "--device", device]
    torch.cuda.synchronize()
    port.kernels.reset_launches()
    traj, rec = port.demo.main(argv)
    torch.cuda.synchronize()
    launches, by_type = dict(port.kernels.LAUNCHES), dict(port.kernels.DTYPE_LAUNCHES)
    line = _launch_line(port.kernels)

    args = port.demo.parser().parse_args(argv)
    args.upsample = True  # as main does for --reconstruction_path
    fx0, fy0, cx0, cy0 = np.loadtxt(fx["calib"], delimiter=" ")[:4]
    stream = []
    for k, image in enumerate(fx["seq"]["images"]):
        image, (sx, sy) = port.streams._resize_to_area(image, DEMO_SIZE[0] * DEMO_SIZE[1])
        stream.append((k, image, np.array([fx0 * sx, fy0 * sy, cx0 * sx, cy0 * sy], np.float32)))
    droid = port.Droid(port.demo.config_for(args, stream[0][1].shape[:2]), weights=str(WEIGHTS), device=device)
    for t, image, intr in stream:
        droid.track(t, image, intrinsics=intr)
    ref = droid.terminate(iter(stream))
    files = {name: recon / f"{name}.npy" for name in RECONSTRUCTION_FILES}
    disps = np.load(files["disps"]) if files["disps"].exists() else np.zeros(1)
    res = dict(rec, launches=launches, dtype_launches=by_type, vs_in_memory=_against(np, traj, ref),
               in_memory_keyframes=droid.counter, files=all(p.exists() for p in files.values()),
               disps_nonzero=float((disps != 0).mean()), finite=bool(np.isfinite(traj).all()))
    res["ok"] = bool(res["finite"] and traj.shape == (len(stream), 7) and res["vs_in_memory"]["within_tol"]
                     and res["files"] and res["disps_nonzero"] > 0 and launches["corr_level"] > 0
                     and launches["corr_slab"] > 0 and launches["corr_window"] > 0)
    log(f"  demo: {rec['frames']} frames at {rec['image_size'][0]}x{rec['image_size'][1]}, {rec['fps']:.2f} "
        f"frames/s, terminate {rec['terminate_s']:.3f} s, keyframes {rec['keyframes']} (in memory "
        f"{droid.counter}); vs in memory {res['vs_in_memory']}; reconstruction files "
        f"{'all written' if res['files'] else 'MISSING'}, disparities non-zero {res['disps_nonzero']:.3f}; "
        f"launches {line}: {'ok' if res['ok'] else 'FAILED'}")
    return res


def evaluate_tartanair(torch, np, port, fx, card: str, device: str = "cuda"):
    """Phase 11c: apps/evaluate.py --dataset tartanair on the scene with
    --gt pose_left.txt and the shipped weights, the launch counts reset
    before it and read after it; its trajectory against run_slam on the
    stream's items built in memory (the rendered frames resized to 384x512
    as the stream resizes them, 0.8 x TartanAir's intrinsics)."""
    argv = ["--dataset", "tartanair", "--datapath", str(fx["scene"]), "--gt", str(fx["scene"] / "pose_left.txt"),
            "--weights", str(WEIGHTS), "--device", device]
    torch.cuda.synchronize()
    port.kernels.reset_launches()
    res = port.evaluate.main(argv)
    torch.cuda.synchronize()
    launches, line = dict(port.kernels.LAUNCHES), _launch_line(port.kernels)
    traj = res.pop("trajectory")

    intr = 0.8 * np.asarray((320.0, 320.0, 320.0, 240.0), np.float32)
    track = [(k, port.streams._resize_rgb(image, TARTAN_SIZE), intr) for k, image in enumerate(fx["seq"]["images"])]
    config = port.preset("tartanair", image_size=TARTAN_SIZE)
    ref, droid, _ = port.evaluate.run_slam(config, str(WEIGHTS), track, track, device=device)
    res.update(launches=launches, dtype_launches=dict(port.kernels.DTYPE_LAUNCHES),
               vs_in_memory=_against(np, traj, ref), finite=bool(np.isfinite(traj).all()))
    res["ok"] = bool(res["finite"] and traj.shape == (len(track), 7) and res["vs_in_memory"]["within_tol"]
                     and res["n_pairs"] == len(track) and launches["corr_level"] > 0
                     and launches["corr_slab"] > 0 and launches["corr_window"] > 0)
    log(f"  evaluate --dataset tartanair: ATE {res['ate_rmse']:.4f} (scale-corrected, pose_left.txt units), "
        f"scale {res['scale']:.4f}, {res['n_pairs']} pairs, keyframes {res['keyframes']}/{res['frames']}, "
        f"tracking {res['track_s']:.2f} s, terminate {res['terminate_s']:.2f} s on {card}; vs in memory "
        f"{res['vs_in_memory']}; launches {line}: {'ok' if res['ok'] else 'FAILED'}")
    return res


def train_tartanair(torch, np, port, fx, decoder, cache_dir: Path, device: str = "cuda", argv=None):
    """Phase 11d: apps/train.py --datapath on the fixtures' TartanAir root,
    at the trainer's defaults from the shipped weights, 2 optimizer steps
    (TARTAN_TRAIN_ARGV), with the launch counts reset before the steps and
    read after them. Without an image decoder the reader takes each frame's
    .npy twin (a TartanAir whose image_read loads it), and says so."""
    args = port.train_app.parser().parse_args(
        ["--datapath", str(fx["tartan_root"]), "--ckpt", str(WEIGHTS), "--cache_dir", str(cache_dir)]
        + (TARTAN_TRAIN_ARGV if argv is None else argv))
    t0 = time.perf_counter()
    if decoder:
        db = port.train_app.dataset(args)
    else:
        class NpyTartanAir(port.dataset.TartanAir):
            @staticmethod
            def image_read(image_file: str):
                return np.load(image_file[: -len(".png")] + ".npy")

        db = NpyTartanAir(datapath=args.datapath, n_frames=args.n_frames, fmin=args.fmin, fmax=args.fmax,
                          crop_size=tuple(args.crop), seed=args.process_id, cache_dir=args.cache_dir)
    graph_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    port.kernels.reset_launches()
    t0 = time.perf_counter()
    hist = port.train_app._train(args, db, torch.device(device), log=log)
    wall = time.perf_counter() - t0
    launches = dict(port.kernels.DTYPE_LAUNCHES)
    res = dict(image_read=decoder or "npy (no PNG decoder on this machine)", clips=len(db), graph_s=graph_s,
               steps=len(hist), passes=[h["passes"] for h in hist], step_walls_s=[h["wall_s"] for h in hist],
               losses=[h["metrics"]["loss"] for h in hist], wall_s=wall,
               grads_finite=all(h["grads_finite"] for h in hist),
               peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    res["ok"] = bool(res["steps"] == args.steps and res["grads_finite"] and np.isfinite(res["losses"]).all()
                     and launches.get("corr_level_f32", 0) > 0 and launches.get("corr_backward_f32", 0) > 0)
    log(f"  train --datapath: image_read {res['image_read']}, {res['clips']} clips (graphs in {graph_s:.1f} s), "
        f"crop {args.crop[0]}x{args.crop[1]}, {args.n_frames} frames, {args.iters} iterations, batch {args.batch}; "
        f"passes {res['passes']}, step walls {', '.join(f'{x:.2f}' for x in res['step_walls_s'])} s, losses "
        f"{', '.join(f'{x:.4f}' for x in res['losses'])}, gradients finite {res['grads_finite']}, peak "
        f"{res['peak_allocated_gb']:.2f} GB, launches corr_level_f32 {launches.get('corr_level_f32', 0)} "
        f"corr_backward_f32 {launches.get('corr_backward_f32', 0)}: {'ok' if res['ok'] else 'FAILED'}")
    return res


def file_paths(torch, np, port, seed: int, card: str, device: str = "cuda"):
    """Phase 11: the decoder finding (11-0), the fixtures (11a), the demo
    from files (11b) and evaluate --dataset tartanair (11c) where this
    machine decodes PNG, and TartanAir training (11d). The fixtures live in
    a temporary directory, removed at the end."""
    import shutil
    import tempfile

    log("phase 11-0: what this machine decodes")
    finding = decoder_finding(port.native_loader)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_files_"))
    res = dict(decoders=finding)
    try:
        t0 = time.perf_counter()
        fx = write_file_fixtures(np, port.render_sequence, root, seed, FILE_SIZE, FILE_FRAMES, FILE_FOCAL)
        res["fixtures_s"] = time.perf_counter() - t0
        log(f"phase 11a: {FILE_FRAMES} frames rendered at {FILE_SIZE[0]}x{FILE_SIZE[1]} (focal {FILE_FOCAL}) and "
            f"written as a TartanAir scene and a demo folder in {res['fixtures_s']:.1f} s")
        if finding["decoder"]:
            log("phase 11b: apps/demo.py on the PNG folder")
            res["demo"] = demo_from_files(torch, np, port, fx, root, device)
            log("phase 11c: apps/evaluate.py --dataset tartanair")
            res["evaluate"] = evaluate_tartanair(torch, np, port, fx, card, device)
        else:
            log("phase 11b-c: not run: this machine decodes no PNG (no native library, no cv2)")
        log("phase 11d: apps/train.py --datapath at the trainer's defaults, 2 steps")
        res["train"] = train_tartanair(torch, np, port, fx, finding["decoder"], root / "cache", device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["ok"] = bool(finding["ok"] and res["train"]["ok"]
                     and all(res[k]["ok"] for k in ("demo", "evaluate") if k in res))
    return res


# -----------------------------------------------------------------------------
# phase 12: the reference-scale entry points (droid_slam_tpu_torch/tools)
# -----------------------------------------------------------------------------

# the sizes of phase 12: tools/longloop.py's protocol (seed 7, 240 frames at
# 384x512, bf16) and the quarter-loop gate of tests/test_longloop.py:35-75
# (the first 60 frames of the 240-frame render at 192x256, f32, buffer 96);
# bench.py's backend probe (200 keyframes at 240x320); the sweep at phase
# 7's sizes (MONO_FRAMES at MONO_SIZE).
LOOP_SEED, LOOP_FRAMES, LOOP_SIZE = 7, 240, (384, 512)
QUARTER_FRAMES, QUARTER_SIZE = 60, (192, 256)
PROBE_T, PROBE_SIZE = 200, (240, 320)
LOOP_KEYFRAMES = (150, 240)
# tests/test_longloop.py's gates: keyframes, scale-corrected ATE of the
# keyframes, fitted scale
QUARTER_KEYFRAMES, QUARTER_ATE, QUARTER_SCALE = (10, 55), 0.45, (0.25, 12.0)
PROBE_JAX_EDGES = 3138  # the JAX package's record of the probe's edges (BENCH_r05.json), printed beside
# what the long loop gives with every step eager (capture=False, TF32 off,
# NVIDIA H100 80GB HBM3 at 700 W): 213 keyframes and an ATE of 2.4312 after
# terminate; the captured run must keep the keyframes and stay within
# LOOP_ATE_TOL of the ATE. A change to the order of the tracking step's
# sums moves both: the linearisation and systems of csrc/ba_window.cu gave
# these, and the same eager run with ops/ba.py::linearize_window_ref (the
# plain stages) forced in still gives 213 and 2.4321; before it, the
# window Schur complement over the occupied cells moved 205 and 2.4291
# (ops/ba.py::window_schur_ref, the dense E, forced in) to 213 and 2.4321;
# in f32 storage those two orders part the other way (dense 213 and 2.4331,
# cells 205 and 2.4256). After such a change, measure them again eagerly.
LOOP_REFERENCE, LOOP_ATE_TOL = (213, 2.4312), 1e-3
# the sweep's rows: (seed, compute dtype, phase 7's row of the same seed and dtype)
SWEEP_ROWS = ((7, "float32", 1), (11, "bfloat16", 6))


def split_pair_ok(launches, steps_chunks) -> bool:
    """The split pair ran 4 levels x steps x chunks times summed over the
    (steps, chunks) passes, and at least once."""
    want = 4 * sum(s * c for s, c in steps_chunks)
    return want > 0 and all(launches.get(k, 0) == want for k in ("corr_slab", "corr_window"))


def memory_peaks(torch, fn):
    """fn() from an emptied allocator cache: its wall and the peaks of
    allocated and of reserved memory (a captured step's pool is reserved,
    not allocated, once its capture ends), in GB."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return dict(wall_s=time.perf_counter() - t0, peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)


def loop_terminates(torch, droid, stream, out_dir):
    """Phase 12b's terminates after the row's: terminate(stream) under the
    profiler (device activity, table in DIR/profile_longloop_terminate.txt),
    then with capture=False and with capture, each from an emptied cache:
    walls and memory peaks side by side."""
    prof = profile_terminate(torch, lambda: droid.terminate(iter(stream)), None, out_dir,
                             "profile_longloop_terminate")
    kept = droid.capture
    try:
        for capture in (False, True):
            droid.capture = capture
            prof["captured" if capture else "eager"] = memory_peaks(torch, lambda: droid.terminate(iter(stream)))
    finally:
        droid.capture = kept
    return prof


def long_loop(torch, np, port, cache: Path, out_dir=None):
    """Phase 12b: tools/longloop.py's run() at the reference scale, with the
    launch counts reset before it and read after it; its terminate again
    through loop_terminates (profiled, then eager and captured from an
    emptied cache). Terminate's split-pair launches on the card are held
    to its two global-BA passes' steps and chunks (the filler launches
    only corr_level)."""
    torch.cuda.synchronize()
    port.kernels.reset_launches()
    t0 = time.perf_counter()
    row = port.longloop.run(LOOP_SEED, LOOP_FRAMES, *LOOP_SIZE, "bfloat16", cache_dir=cache,
                            profile=lambda droid, stream: loop_terminates(torch, droid, stream, out_dir))
    wall = time.perf_counter() - t0
    launches = port.kernels.launch_counts()
    prof = row["profile"]
    # the busy share of the unprofiled terminate, as 12d's of its step
    prof["device_busy_share"] = prof["device_ms"] / (row["terminate_s"] * 1e3)
    kf = row["keyframes"]
    passes = [dict(p, edges_ok=0 < p["edges"] <= 16 * kf) for p in row["backend_runs"]]
    # the card's launches of terminate: its steps are captured, and a
    # wrapper counts a captured launch once
    track, term = row["launches"]["track"], row["terminate_device_launches"]
    res = dict(row=row, wall_s=wall, launches=launches, passes=passes,
               keyframes_ok=LOOP_KEYFRAMES[0] <= kf <= LOOP_KEYFRAMES[1],
               reference_ok=kf == LOOP_REFERENCE[0] and abs(row["ate_rmse"] - LOOP_REFERENCE[1]) <= LOOP_ATE_TOL,
               poses_ok=row["poses_filled"] == LOOP_FRAMES and row["poses_finite"],
               split_pair_ok=split_pair_ok(term, [(p["steps"], p["chunks"]) for p in passes]),
               corr_level_ok=track.get("corr_level_bf16", 0) > 0 and track.get("corr_level_f32", 0) > 0)
    res["ok"] = bool(res["keyframes_ok"] and res["reference_ok"] and res["poses_ok"] and res["corr_level_ok"]
                     and res["split_pair_ok"] and all(p["edges_ok"] for p in passes))
    log(f"  long loop: {kf} keyframes of {row['frames']} frames (range {LOOP_KEYFRAMES}), tracking "
        f"{row['track_s']} s ({row['track_fps']} frames/s), warm_terminate {row['warm_terminate_s']} s, terminate "
        f"{row['terminate_s']} s; ATE {row['ate_rmse']} at scale {row['scale']} (keyframes before terminate: "
        f"{row['ate_kf_pre_terminate']} at scale {row['scale_kf_pre_terminate']}); peak "
        f"{row['peak_allocated_gb']} GB; wall {wall:.1f} s: {'ok' if res['ok'] else 'FAILED'}")
    for p in passes:
        log(f"    pass of {p['steps']} steps: {p['edges']} edges (budget {16 * kf}), {p['chunks']} chunks")
    per_pass = " + ".join(f"{p['steps']} x {p['chunks']}" for p in passes)
    log(f"    terminate: corr_slab {term.get('corr_slab', 0)} corr_window {term.get('corr_window', 0)} "
        f"(4 x ({per_pass})) on the card, {row['launches']['terminate'].get('corr_slab', 0)} queued; captured steps "
        f"{row['terminate_capture']}; keyframes and ATE vs {LOOP_REFERENCE} (tolerance {LOOP_ATE_TOL}): "
        f"{'ok' if res['reference_ok'] else 'FAILED'}")
    log(f"    launches: tracking {track}; terminate {row['launches']['terminate']}; peak by stage "
        f"{row['peak_allocated_gb_by_stage']} GB")
    log(f"    terminate profile (busy share of the unprofiled terminate): "
        f"{ {k: v for k, v in prof.items() if k not in ('eager', 'captured')} }")
    log(f"    terminate(stream) again from an emptied cache: capture=False {prof['eager']}; captured "
        f"{prof['captured']}; peak reserved by stage {row['peak_reserved_gb_by_stage']} GB")
    return res


def quarter_loop(torch, np, port, seq):
    """Phase 12c: tests/test_longloop.py's quarter-loop gate: the first
    frames of the 240-frame render, f32, buffer 96, the shipped weights;
    the keyframes' scale-corrected ATE after tracking."""
    K = QUARTER_FRAMES
    config = port.DroidConfig(image_size=QUARTER_SIZE, buffer=96, warmup=8, compute_dtype="float32")
    droid = port.Droid(config, weights=str(WEIGHTS))
    t0 = time.perf_counter()
    for k in range(K):
        droid.track(k, seq["images"][k], intrinsics=seq["intrinsics"][k])
    droid.sync()
    track_s = time.perf_counter() - t0
    t = droid.counter
    est = port.lie.inv(droid.poses).cpu().numpy()
    ref = port.Trajectory.from_poses(np.arange(K, dtype=np.float64), seq["poses"][:K])
    r = port.ate_rmse(ref, port.Trajectory.from_poses(droid.tstamps.cpu().numpy(), est), correct_scale=True,
                      max_dt=0.25)
    res = dict(frames=K, keyframes=t, ate=r["ate_rmse"], scale=float(r["scale"]), track_s=track_s)
    res["ok"] = bool(QUARTER_KEYFRAMES[0] <= t <= QUARTER_KEYFRAMES[1] and r["ate_rmse"] < QUARTER_ATE
                     and QUARTER_SCALE[0] < r["scale"] < QUARTER_SCALE[1])
    log(f"  quarter loop: {t} keyframes of {K} frames (range {QUARTER_KEYFRAMES}), ATE {r['ate_rmse']:.4f} (bound "
        f"{QUARTER_ATE}) at scale {r['scale']:.4f} (band {QUARTER_SCALE}), tracking {track_s:.2f} s: "
        f"{'ok' if res['ok'] else 'FAILED'}")
    return res


def probe_profile(torch, step):
    """One probe step under torch.profiler through device_ms (its retakes
    included): device ms by kernel."""
    by_kernel = {}
    ms = device_ms(torch, step, reps=1, warm=0, by_kernel=by_kernel)
    ranked = sorted(by_kernel, key=lambda k: -by_kernel[k])
    return dict(device_ms=ms, top_kernels_ms={k[:60]: by_kernel[k] for k in ranked[:10]},
                corr_slab_ms=sum(v for k, v in by_kernel.items() if "corr_slab" in k),
                corr_window_ms=sum(v for k, v in by_kernel.items() if "corr_window" in k))


def backend_probe_path(torch, np, port):
    """Phase 12d: tools/backend_probe.py at 200 keyframes: its edge count
    against the same draws' distinct pairs counted on the host, the split
    pair's launches, one more step under the profiler."""
    t_, (H, W) = PROBE_T, PROBE_SIZE
    host_edges = port.backend_probe.unique_edges(port.backend_probe.probe_arrays(t_, t_ + 8, H // 8, W // 8))
    torch.cuda.synchronize()
    port.kernels.reset_launches()
    t0 = time.perf_counter()
    row = port.backend_probe.backend_scale_probe(t_, (H, W), profile=lambda step: probe_profile(torch, step))
    wall = time.perf_counter() - t0
    prof = row["profile"]
    prof["device_busy_share"] = prof["device_ms"] / (row["backend_step_s"] * 1e3)
    res = dict(row=row, host_edges=host_edges, wall_s=wall, launches=port.kernels.launch_counts())
    # the timed steps are replays: nothing queued by a wrapper, all run on the card
    res["ok"] = bool(row["backend_edges"] == host_edges and row["capture"] and row["replays"] == row["steps"]
                     and split_pair_ok(row["device_launches"], [(row["steps"], row["backend_chunks"])]))
    log(f"  probe: {t_} keyframes, {row['backend_edges']} edges (host count {host_edges}; the JAX package's "
        f"record {PROBE_JAX_EDGES}), {row['backend_chunks']} chunks per step, {row['backend_step_s']} s per step "
        f"({row['replays']} replays), warm call {row['warm_s']} s of which capture {row['capture_s']} s "
        f"({row['graphs']} graph, pool {row['pool_bytes'] / 1e6:.1f} MB), timed steps' launches queued "
        f"{row['launches']}, on the card {row['device_launches']}, peak {row['peak_allocated_gb']} GB, wall "
        f"{wall:.1f} s: {'ok' if res['ok'] else 'FAILED'}")
    log(f"    profiled step: {prof['device_ms']:.1f} ms of device time, busy share "
        f"{prof['device_busy_share']:.3f} of the unprofiled step; {prof['top_kernels_ms']}")
    return res


def sweep_path(torch, np, port, proto_rows):
    """Phase 12e: tools/eval_sweep.py over the shipped weights, one row per
    (seed, dtype) of SWEEP_ROWS, with the launch counts reset before each
    and read after it; keyframes and ATE bit for bit phase 7's row."""
    rows = []
    for seed, dtype, k in SWEEP_ROWS:
        torch.cuda.synchronize()
        port.kernels.reset_launches()
        row = port.eval_sweep.sweep([str(WEIGHTS)], [seed], MONO_FRAMES, tuple(MONO_SIZE), dtype)[0]
        launches = port.kernels.launch_counts()
        ref = next(r for r in proto_rows if r["row"] == k)
        row.update(phase7_row=k, phase7_keyframes=ref["keyframes"], phase7_ate=ref["ate"], launches=launches,
                   same=bool(row["kf"] == ref["keyframes"] and row["ate_rmse"] == ref["ate"]))
        row["ok"] = bool(row["same"] and all(launches.get(n, 0) > 0 for n in ("corr_level", "corr_slab",
                                                                             "corr_window")))
        log(f"  sweep seed {seed} {dtype}: {row['kf']} keyframes, ATE {row['ate_rmse']!r} (phase 7 row {k}: "
            f"{ref['keyframes']}, {ref['ate']!r}), wall {row['wall_s']} s: {'ok' if row['ok'] else 'FAILED'}")
        rows.append(row)
    return dict(rows=rows, ok=all(r["ok"] for r in rows))


def reference_scale(torch, np, port, proto_rows, out_dir=None):
    """Phase 12: the loops rendered and cached in a temporary directory
    (12a), the long loop (12b), the quarter-loop gate (12c), the backend
    probe (12d) and the sweep (12e). The cache is removed at the end."""
    import os
    import shutil
    import tempfile

    cache = Path(tempfile.mkdtemp(prefix="chip_smoke_loop_"))
    res = {}
    try:
        workers = min(8, os.cpu_count() or 1)
        renders = {}
        for H, W in (LOOP_SIZE, QUARTER_SIZE):  # the quarter loop's sequence is the last
            t0 = time.perf_counter()
            quarter_seq = port.longloop.load_or_render(LOOP_SEED, LOOP_FRAMES, H, W, cache, workers)
            renders[f"{H}x{W}"] = time.perf_counter() - t0
        res["render_s"] = renders
        log(f"phase 12a: the {LOOP_FRAMES}-frame loop (seed {LOOP_SEED}) rendered on {workers} threads and "
            f"cached: " + ", ".join(f"{k} in {v:.1f} s" for k, v in renders.items()))
        log("phase 12b: tools/longloop.py run() at the reference scale")
        res["long_loop"] = long_loop(torch, np, port, cache, out_dir)
        log("phase 12c: the quarter-loop gate")
        res["quarter"] = quarter_loop(torch, np, port, quarter_seq)
        log("phase 12d: tools/backend_probe.py")
        res["probe"] = backend_probe_path(torch, np, port)
        log("phase 12e: tools/eval_sweep.py against phase 7's rows")
        res["sweep"] = sweep_path(torch, np, port, proto_rows)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    res["ok"] = all(res[k]["ok"] for k in ("long_loop", "quarter", "probe", "sweep"))
    return res


def main(argv=None) -> int:
    global LOG_PATH
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    ap.add_argument("--out", type=Path, default=None, help="directory for the detail files")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    t_run = time.perf_counter()
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

    from droid_slam_tpu_torch.apps import demo, evaluate
    from droid_slam_tpu_torch.apps import train as train_app
    from droid_slam_tpu_torch.data import dataset, native_loader, streams
    from droid_slam_tpu_torch.data.synthetic import SyntheticDataset, render_sequence
    from droid_slam_tpu_torch.models.droid_net import DroidNet, init_params
    from droid_slam_tpu_torch.ops import ba, corr, kernels, lie, segment
    from droid_slam_tpu_torch.ops import projective as pops
    from droid_slam_tpu_torch.runtime import Droid, DroidConfig, graph
    from droid_slam_tpu_torch.runtime.config import preset
    from droid_slam_tpu_torch.eval.ate import Trajectory, ate_rmse
    from droid_slam_tpu_torch.tools import backend_probe, eval_sweep, longloop
    from droid_slam_tpu_torch.train import checkpoints, trainer
    from droid_slam_tpu_torch.utils import profiling, visualization

    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(f"  the GPU driver's CUDA {driver_cuda_version()}; torch.cuda.CUDAGraph has "
        + ", ".join(f"{m} {hasattr(torch.cuda.CUDAGraph, m)}" for m in GRAPH_IF_API)
        + " (the port builds its IF nodes in csrc/graph_cond.cu either way)")

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
    backward_spills = {}  # the backward's functions: bytes of spill stores and loads
    for name, text in build_logs.items():
        func = ""
        for line in text.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                func = line.split()[-1].strip("'")
            elif "registers" in line or "spill" in line or "smem" in line:
                if "corr_backward" in func and "spill" in line:
                    # "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
                    backward_spills[func] = backward_spills.get(func, 0) + sum(
                        int(part.split()[0]) for part in line.split(",") if "spill" in part)
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

    log("phase 3d: the flight recorder's kernels vs their plain versions at the tracking step's ring")
    trace_res = check_trace_kernels(torch, profiling, graph, dev, args.seed)

    log("phase 3e: the window Schur complement over the occupied cells vs the plain dense version")
    schur_cases = check_schur_window(torch, ba, kernels, dev, args.seed)

    log("phase 3f: the window's linearisation and its pose and depth systems vs the plain stages")
    lin_cases = check_ba_window(torch, ba, kernels, dev, args.seed)

    # with the other kernel checks: late in the run torch.profiler has come
    # back with some or none of the device events of these launches
    log("phase 9a: corr_backward vs autograd through corr_level_ref at the training path's shapes")
    t0 = time.perf_counter()
    bwd_cases = check_backward_kernel(torch, corr, pops, dev, args.seed)
    # ragged maps: no level's width a multiple of 8, level 0's height neither
    # (partial column tiles and row blocks, the df2 edge clamps)
    bwd_cases += check_backward_kernel(torch, corr, pops, dev, args.seed, N=16, h=44, w=60, kinds=("iid", "far"),
                                       timed=False)
    bwd_wall = time.perf_counter() - t0

    log("phase 4: small replay + terminate, GPU port vs CPU port")
    small = small_replay(torch, np, Droid, DroidConfig, init_params, args.seed)

    log("phase 5: main path, Droid.track at the bench configuration")
    main_res, droid = main_path(torch, np, kernels, Droid, DroidConfig, init_params, args.seed, args.out)
    log("  flight recorder launches: " + ", ".join(
        f"{k} queued {main_res['launches'].get(k)}, captured {main_res['captured_launches'].get(k)}, "
        f"on the card {main_res['device_launches'].get(k)}" for k in TRACE_STEP_LAUNCHES))

    log("phase 5b: the captured step vs capture=False, bit for bit, no host read after the capture")
    t0 = time.perf_counter()
    capture_res = captured_vs_eager(torch, np, Droid, DroidConfig, init_params, evaluate, graph, args.seed,
                                    dict(droid=droid))
    capture_res["wall_s"] = time.perf_counter() - t0

    log("phase 6: terminate path, Droid.terminate() at the bench configuration")
    term_res, term_ref = terminate_path(torch, np, kernels, graph, droid, args.seed, args.out)
    del droid

    log("phase 7: synthetic protocol with the shipped weights")
    t0 = time.perf_counter()
    proto = synthetic_protocol(torch, np, kernels, evaluate, DroidConfig, render_sequence, Droid, args.out)
    proto["wall_s"] = time.perf_counter() - t0

    log("phase 8: host-driven engine, Droid(fused=False)")
    t0 = time.perf_counter()
    host = host_engine(torch, np, kernels, Droid, DroidConfig, init_params, visualization, evaluate,
                       render_sequence, graph, args.seed, args.out, main_res["profile"]["device_busy_share"],
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

    log("phase 10: the distributed paths as 1-rank groups")
    t0 = time.perf_counter()
    term_ref["backend_runs"] = term_res["runs"][0]["backend_runs"]
    dist_res = distributed_paths(torch, np, kernels, Droid, DroidConfig, init_params, port, args.seed, term_ref)
    dist_res["wall_s"] = time.perf_counter() - t0
    log(f"  phase 10 wall: {dist_res['wall_s']:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]

    log("phase 11: the file-based data layer and its apps")
    t0 = time.perf_counter()
    files_port = SimpleNamespace(native_loader=native_loader, streams=streams, dataset=dataset, demo=demo,
                                 evaluate=evaluate, train_app=train_app, kernels=kernels, Droid=Droid,
                                 preset=preset, render_sequence=render_sequence)
    files = file_paths(torch, np, files_port, args.seed, smi)
    files["wall_s"] = time.perf_counter() - t0
    log(f"  phase 11 wall: {files['wall_s']:.1f} s")

    log("phase 12: the reference-scale entry points (droid_slam_tpu_torch/tools)")
    t0 = time.perf_counter()
    tools_port = SimpleNamespace(longloop=longloop, backend_probe=backend_probe, eval_sweep=eval_sweep,
                                 kernels=kernels, lie=lie, Droid=Droid, DroidConfig=DroidConfig,
                                 Trajectory=Trajectory, ate_rmse=ate_rmse)
    scale = reference_scale(torch, np, tools_port, proto["rows"], args.out)
    scale["wall_s"] = time.perf_counter() - t0
    log(f"  phase 12 wall: {scale['wall_s']:.1f} s")

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
        replayed_launches=main_res["replayed_launches"]["corr_level"],
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
            replayed_launches=term_res["runs"][0]["replayed_launches"].get(name, 0),
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
    # levels; corr_level_f32 with phase 5's launches (the probe, replayed
    # with the captured step), corr_slab_f32 with phase 7 row 1's (an f32
    # row of the protocol)
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
        launched = main_res["launches"] if name == "corr_level_f32" else row1["dtype_launches"]
        kernel_rows.append(share(dict(
            name=name,
            route="cuda",
            source=f"droid_slam_tpu_torch/csrc/{source}",
            replaces=f"droid_slam_tpu/ops/pallas_corr.py:{line}",
            launches=launched.get(name, 0),
            replayed_launches=main_res["replayed_launches"].get(name, 0) if name == "corr_level_f32" else 0,
            max_abs_err=err,
            ms=sum(ms(c) for c in sel),
            plain_ms=sum(plain(c) for c in sel),
            bound_ms=sum(bnd(c) for c in sel),
            bound_by="bytes" if k_bytes >= k_ops else "operations",
            library_ms=None,
        )))
    # the backward of the lookup: one training-path lookup's backward, the 4
    # levels at 208 edges, iid, f32, with phase 9c's launches
    bwd_iid = [c for c in train["backward_cases"] if "ms" in c]
    b_bytes = sum(c["bytes"] / MEM_BYTES_PER_S for c in bwd_iid)
    b_ops = sum(c["ops"] / PEAK_OPS_PER_S["float32"] for c in bwd_iid)
    kernel_rows.append(share(dict(
        name="corr_backward",
        route="cuda",
        source="droid_slam_tpu_torch/csrc/corr_backward.cu",
        replaces="droid_slam_tpu/ops/corr.py:135 (no Pallas counterpart: XLA autodiff of corr_index)",
        launches=train["defaults"]["launches"].get("corr_backward_f32", 0),
        replayed_launches=0,
        max_abs_err=max(max(c["max_abs_err"].values()) for c in train["backward_cases"]),
        ms=sum(c["ms"] for c in bwd_iid),
        plain_ms=sum(c["plain_ms"] for c in bwd_iid),
        bound_ms=sum(c["bound_ms"] for c in bwd_iid),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        library_ms=sum(c["library_ms"] for c in bwd_iid),
    )))
    # the IF node's set kernel: no TPU kernel; JAX's lax.cond inside the
    # jitted step, with phase 5's launches (GRAPH_IF_NODES captured, as many
    # per replay)
    gc = capture_res["graph_cond"]
    kernel_rows.append(share(dict(
        name="graph_cond",
        route="cuda",
        source="droid_slam_tpu_torch/csrc/graph_cond.cu",
        replaces="droid_slam_tpu/runtime/fused.py:597 (lax.cond in the jitted step; not a Pallas kernel)",
        launches=main_res["launches"].get("graph_cond", 0),
        replayed_launches=main_res["replayed_launches"].get("graph_cond", 0),
        max_abs_err=gc["max_abs_err"],
        ms=gc["ms"],
        plain_ms=gc["plain_ms"],
        bound_ms=gc["bound_ms"],
        bound_by=gc["bound_by"],
        library_ms=None,
    )))
    # the window Schur complement: no Pallas kernel (the JAX package's XLA
    # dense E); the allkf bf16 case of phase 3e, with phase 5's launches
    sw = next(c for c in schur_cases if c["kind"] == "allkf" and c["dtype"] == "bfloat16")
    kernel_rows.append(share(dict(
        name="schur_window",
        route="cuda",
        source="droid_slam_tpu_torch/csrc/schur_window.cu",
        replaces="droid_slam_tpu/ops/ba.py:722 (the dense E of ba_iteration_dense_window in XLA; not a Pallas kernel)",
        launches=main_res["launches"].get("schur_window", 0),
        replayed_launches=main_res["replayed_launches"].get("schur_window", 0),
        max_abs_err=max(sw["max_abs_err"].values()),
        ms=sw["ms"],
        plain_ms=sw["plain_ms"],
        bound_ms=sw["bound_ms"],
        bound_by="bytes" if sw["bytes"] / MEM_BYTES_PER_S >= sw["ops"] / PEAK_OPS_PER_S["float32"] else "operations",
        library_ms=None,
    )))
    # the linearisation and the systems: no Pallas kernel (the JAX package's
    # XLA build_edge_blocks and scatters); the mono case of phase 3f, with
    # phase 5's launches
    lw = next(c for c in lin_cases if c["kind"] == "mono")
    kernel_rows.append(share(dict(
        name="ba_window",
        route="cuda",
        source="droid_slam_tpu_torch/csrc/ba_window.cu",
        replaces="droid_slam_tpu/ops/ba.py::build_edge_blocks and the dense window's scatters (XLA; not a Pallas "
                 "kernel)",
        launches=main_res["launches"].get("ba_window", 0),
        replayed_launches=main_res["replayed_launches"].get("ba_window", 0),
        max_abs_err=max(lw["max_abs_err"].values()),
        ms=lw["ms"],
        plain_ms=lw["plain_ms"],
        bound_ms=lw["bound_ms"],
        bound_by="bytes",
        library_ms=None,
    )))
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(dict(
            device=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__,
            tf32_defaults=tf32_defaults,
            build_s=build_s, sass=sass, cases=cases, split_cases=split_cases, segment_cases=seg_cases,
            small_replay=small,
            main_path=main_res, captured_vs_eager=capture_res, terminate_path=term_res, synthetic_protocol=proto, host_engine=host,
            training=train, distributed=dist_res, files=files, reference_scale=scale, kernels=kernel_rows,
            trace_kernels=trace_res, schur_window=schur_cases, ba_window=lin_cases,
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
        if not row1["dtype_launches"].get(name):
            failed.append(f"{name}: no launch in phase 7 row 1")
    failed += [f"{row['name']}: no launch in phase 5" for row in kernel_rows
               if row["name"] in ("corr_level", "corr_level_f32", "graph_cond") and not row["launches"]]
    slab32 = next(r for r in kernel_rows if r["name"] == "corr_slab_f32")
    if slab32["ms"] > slab32["plain_ms"]:
        failed.append(f"corr_slab_f32 {slab32['ms']:.4f} ms is slower than its plain version "
                      f"{slab32['plain_ms']:.4f} ms (iid, N=256, 4 levels)")
    failed += [f"segment_sum {c['name']}" for c in seg_cases if not c["ok"]]
    if not trace_res["ok"]:
        failed.append("phase 3d trace kernels")
    failed += [f"phase 3e schur_window {c['kind']} {c['dtype']}" for c in schur_cases if not c["ok"]]
    failed += [f"phase 3f ba_window {c['kind']}" for c in lin_cases if not c["ok"]]
    if not main_res["ok"]:
        failed.append("main path")
    if not capture_res["graph_cond"]["ok"]:
        failed.append("phase 5b graph_cond vs eager cond")
    failed += [f"phase 5b {name}: {case['same']}" for name, case in capture_res["cases"].items() if not case["ok"]]
    if not term_res["ok"]:
        failed.append("terminate path")
    failed += [f"phase 6b {name}: {case['same']}" for name, case in term_res["capture_vs_eager"]["cases"].items()
               if not case["ok"]]
    failed += [f"synthetic row {r['row']} {r['mode']} seed {r['seed']} {r['dtype']}"
               for r in proto["rows"] if not r["ok"]]
    if not proto["cull"]["ok"]:
        failed.append(f"synthetic row 9 cull replay: {proto['cull']}")
    failed += [f"host engine {part}" for part, ok in (
        ("8a tracking", host["bench"]["tracking_ok"]), ("8a terminate", host["bench"]["terminate"]["ok"]),
        ("8a map", host["bench"]["map"]["ok"]), ("8a captured vs eager", host["bench"]["capture_vs_eager"]["ok"]),
        ("8b cull replay", host["cull"]["ok"]),
        ("8c row 1", host["row1"]["ok"])) if not ok]
    failed += [f"corr_backward {c['kind']} {c['H2']}x{c['W2']} L{c['level']}" for c in train["backward_cases"]
               if not c["ok"]]
    failed += [f"grid_sample backward yardstick L{c['level']}: forward max_err {c['grid_sample_err']:.3e}"
               for c in bwd_iid if not c["grid_sample_ok"]]
    failed += [f"{f}: {k} tensor-core instructions" for f, k in
               ((f, sum(c.values())) for f, c in sass.items() if "corr_backward" in f) if k]
    for fn in ("corr_backward_df1_kernel", "corr_backward_df2_kernel"):
        if sum(fn in f for f in sass) != 4:  # C in (32, 64, 128, 256)
            failed.append(f"{fn}: expected 4 instantiations in the SASS, found {sum(fn in f for f in sass)}")
    failed += [f"{f}: {k} bytes of spills" for f, k in backward_spills.items() if k]
    bwd_row = next(r for r in kernel_rows if r["name"] == "corr_backward")
    if bwd_row["ms"] > BACKWARD_LIMIT_MS:
        failed.append(f"corr_backward {bwd_row['ms']:.4f} ms per 4-level backward exceeds {BACKWARD_LIMIT_MS} ms "
                      "(iid, N=208)")
    failed += [f"training {part}" for part in ("card_vs_cpu", "defaults", "learns", "resume")
               if not train[part]["ok"]]
    dt, dd = dist_res["terminate"], dist_res["training"]
    failed += [f"phase 10a {part}" for part, ok in (
        ("small replay", dt["small_replay"]["ok"]), ("small replay vs single-device", dt["small_replay"]["vs_single_ok"]),
        ("terminate runs", all(r["ok"] for r in dt["runs"])),
        ("repeat", dt["repeat"]["ok"]), ("vs single-device", dt["vs_single_device"]["ok"])) if not ok]
    if not dd["ok"]:
        failed.append("phase 10b data-parallel step")
    failed += [f"phase 11 {part}" for part in ("decoders", "demo", "evaluate", "train")
               if part in files and not files[part]["ok"]]
    failed += [f"phase 12{tag} {part}" for tag, part in (("b", "long_loop"), ("c", "quarter"), ("d", "probe"),
                                                         ("e", "sweep")) if not scale[part]["ok"]]
    if failed:
        print("chip_smoke: FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1

    prof, bench = main_res["profile"], capture_res["cases"]["bench"]
    log(f"main path (captured step): {main_res['fps']:.2f} frames/s (capture=False: {bench['eager_fps']:.2f}), "
        f"{main_res['keyframes']} keyframes, {main_res['event_ms_per_frame']:.2f} ms per frame of CUDA events, "
        f"device {prof['device_ms_per_frame']:.2f} ms per frame, busy {prof['device_busy_share']:.3f}, "
        f"graph launches per frame {main_res['graph_launches_per_frame']:.2f} (profiled: "
        f"{prof['graph_launches_per_frame']:.2f}; kernel launches by the host {prof['kernel_launches_per_frame']:.1f}), "
        f"capture {main_res['capture_s']:.3f} s, pool {main_res['pool_bytes'] / 1e6:.1f} MB; corr_level launches "
        f"{main_res['launches']['corr_level']} queued, {main_res['device_launches']['corr_level']} on the card "
        f"({prof['corr_level_records_per_frame']:.1f} records per profiled frame)")
    log(f"captured vs eager (phase 5b, {capture_res['wall_s']:.1f} s): "
        + ", ".join(f"{name} {'bitwise' if case['ok'] else 'DIFFERS'} ({case['keyframes']} keyframes, "
                    f"{case['sync_checked_frames']} frames under sync debug 'error')"
                    for name, case in capture_res["cases"].items())
        + f"; graph_cond {capture_res['graph_cond']['ms']:.5f} ms per IF node; a host frame's upload waits for "
        f"the card: {capture_res['host_upload_syncs']}")
    walls = ", ".join(f"{r['wall_s']:.3f}" for r in term_res["runs"])
    first = term_res["runs"][0]
    versus = term_res["capture_vs_eager"]
    log(f"terminate path (captured steps): {term_res['keyframes']} keyframes, wall {walls} s, "
        f"corr_slab/corr_window launches {first['launches']['corr_slab']}/{first['launches']['corr_window']} "
        f"queued, {first['device_launches']['corr_slab']}/{first['device_launches']['corr_window']} on the card, "
        f"captured steps {first['capture']}, repeats: {term_res['repeat']}; device "
        f"{term_res['profile']['device_ms']:.1f} ms; 6b: "
        + ", ".join(f"{name} walls {c['walls_s']}, {'bitwise' if c['ok'] else 'DIFFERS'}"
                    for name, c in versus["cases"].items())
        + f"; device ms {versus['device_ms']}, busy share {versus['busy_share']}")
    log(f"synthetic protocol: {len(proto['rows'])} rows and the cull replay passed in "
        f"{proto['wall_s']:.1f} s; ATE " + ", ".join(f"{r['mode']} {r['seed']} {r['dtype']} {r['ate']:.4f}"
                                                   for r in proto["rows"]))
    for row in kernel_rows:
        if row["name"] in FIRST_DESIGN_MS:
            log(f"{row['name']}: {row['ms']:.4f} ms in this run (profiler); first design "
                f"{FIRST_DESIGN_MS[row['name']]} ms (a constant from earlier runs)")
    log(f"f32 launches of phase 7 row 1 (mono seed 7, f32): {row1['dtype_launches']}; "
        f"phase 5 (bf16 tracking, f32 probe): queued "
        f"{ {k: n for k, n in main_res['launches'].items() if k.startswith('corr_level_')} }, on the card "
        f"{ {k: n for k, n in main_res['device_launches'].items() if k.startswith('corr_level_')} }")
    hb, hterm, hrow = host["bench"], host["bench"]["terminate"], host["row1"]
    log(f"host engine (phase 8, {host['wall_s']:.1f} s): {hb['fps']:.2f} frames/s captured, "
        f"{hb['eager_fps']:.2f} with capture=False (bit for bit: {hb['capture_vs_eager']['ok']}; captured steps "
        f"{hb['capture']}), terminate eager {hterm['eager']['wall_s']:.3f} s (fused {main_res['fps']:.2f}), "
        f"device busy {hb['profile']['device_busy_share']:.3f} (fused "
        f"{main_res['profile']['device_busy_share']:.3f}), corr_level_f32 launches "
        f"{hb['dtype_launches'].get('corr_level_f32')}; terminate {hterm['wall_s']:.3f} s, corr_slab/corr_window "
        f"{hterm['launches']['corr_slab']}/{hterm['launches']['corr_window']}; map {hb['map']['points']} points, "
        f"masks agree {hb['map']['mask_agreement']:.5f}; cull replay {host['cull']['keyframes']} keyframes "
        f"on all four runs (captured and eager bit for bit: {all(host['cull']['capture_vs_eager'].values())}); "
        f"row 1 ATE {hrow['ate']:.4f}, keyframes {hrow['keyframes']} "
        f"(fused {row1['keyframes']})")
    td, tl = train["defaults"], train["learns"]
    log(f"training (phase 9, {train['wall_s']:.1f} s): corr_backward {bwd_row['ms']:.4f} ms per "
        f"4-level backward at 208 edges (plain {bwd_row['plain_ms']:.4f}, bound "
        f"{bwd_row['bound_ms']:.4f}, grid_sample backward {bwd_row['library_ms']:.4f}); "
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
    vs, pin, ar = dt["vs_single_device"], dt["vs_single_device_f32"], dd["allreduce"]
    log(f"distributed paths (phase 10, {dist_res['wall_s']:.1f} s, 1-rank groups): sharded terminate "
        f"{vs['keyframes']} keyframes, warm_terminate {dt['warm_terminate_s']:.3f} s, walls "
        + ", ".join(f"{r['wall_s']:.3f}" for r in dt["runs"]) + f" s, corr_slab/corr_window launches "
        f"{dt['runs'][0]['launches']['corr_slab']}/{dt['runs'][0]['launches']['corr_window']}, repeat "
        f"{dt['repeat']['trajectory_max_diff']:.1e}; vs single-device poses {vs['pose_diff']:.3e} "
        f"(bound {vs['tol']['poses']:.3e}), disps {vs['disp_diff']:.3e} (bound {vs['tol']['disps']:.3e}); "
        f"vs single-device with E in f32 poses {pin['pose_diff']:.3e}, disps {pin['disp_diff']:.3e} "
        f"(bound {pin['tol']:.0e}); small replay (f32) vs single-device {dt['small_replay']['vs_single_device']['cuda']}; "
        f"data-parallel step bitwise = plain; gradient all-reduce {ar['mb']:.2f} MB in {ar['ms']:.4f} ms")
    tr = files["train"]
    log(f"file paths (phase 11, {files['wall_s']:.1f} s, {smi}): images decode with "
        f"{files['decoders']['decoder'] or 'nothing'}"
        + (f"; demo {files['demo']['fps']:.2f} frames/s, terminate {files['demo']['terminate_s']:.3f} s, "
           f"{files['demo']['keyframes']} keyframes, vs in memory max diff {files['demo']['vs_in_memory']['max_diff']:.1e}; "
           f"evaluate tartanair ATE {files['evaluate']['ate_rmse']:.4f} scale {files['evaluate']['scale']:.4f}, "
           f"vs in memory max diff {files['evaluate']['vs_in_memory']['max_diff']:.1e}"
           if "demo" in files else "; 11b-c not run (no PNG decoder)")
        + f"; TartanAir training {tr['clips']} clips, step walls "
        f"{', '.join(f'{x:.2f}' for x in tr['step_walls_s'])} s, peak {tr['peak_allocated_gb']:.2f} GB")
    ll, pr, qt = scale["long_loop"], scale["probe"], scale["quarter"]
    log(f"reference scale (phase 12, {scale['wall_s']:.1f} s, {smi}): long loop {ll['row']['keyframes']} keyframes, "
        f"{ll['row']['track_fps']} frames/s, terminate {ll['row']['terminate_s']} s (device "
        f"{ll['row']['profile']['device_ms']:.0f} ms, busy {ll['row']['profile']['device_busy_share']:.3f} "
        f"of the unprofiled terminate), ATE {ll['row']['ate_rmse']} "
        f"scale {ll['row']['scale']}, peak {ll['row']['peak_allocated_gb']} GB, passes "
        + ", ".join(f"{p['edges']} edges/{p['chunks']} chunks" for p in ll["passes"])
        + f", terminate's captured steps {ll['row']['terminate_capture']}; quarter loop {qt['keyframes']} keyframes, "
        f"ATE {qt['ate']:.4f}; probe {pr['row']['backend_edges']} edges, {pr['row']['backend_step_s']} s per step "
        f"(replays; capture {pr['row']['capture_s']} s, pool {pr['row']['pool_bytes'] / 1e6:.1f} MB), "
        f"{pr['row']['backend_chunks']} chunks; sweep rows = "
        f"phase 7's rows {[r['phase7_row'] for r in scale['sweep']['rows']]} bit for bit")
    log(f"whole run: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
