"""Window driver of the tracking cells: closed-loop sessions, back to back.

Each session is a new ``Droid`` (built from the loaded state dict) that
tracks every frame of the cell's sequence, one ``Droid.track`` call per
frame, the next frame as soon as the call returns. Sessions follow each
other until the window's seconds are up; the frame in flight then
finishes and the window's end is fenced by a synchronize.

``track_fps``: frames tracked ÷ the window's seconds. ``frame_p95_ms``: the
95th percentile, over every frame of the window, session starts included,
of the time between two CUDA events recorded on the tracking stream just
before and just after the frame's ``track`` call (from when the card
could start the frame to when its pose is done); the events are read
after the window.

Set-up warms the cell's shapes: one session prefix through the
initialisation and the capture of the tracked step. The traced run tracks
a fresh session to ``trace_start`` frames untraced (its construction, the
eager initialisation and the capture), then profiles the next
``trace_frames`` frames, all replays of the captured step as in the
window's steady state, then counts the work of those frames in a counting
pass over the same frames (the program repeats bit for bit, so the pass
sees the same decisions).

The window keeps device copies of every session's keyframes at
``check_frames`` frames (no host read inside the window). The check
compares every session with the first (``session_gap``: the same inputs
give the same keyframes bit for bit), replays one session to
``check_frames`` frames, which must give the first bit for bit
(``replay_gap``), and has the reference follow the frame that initialises
the map (``init_unmoved``) and ``check_steps`` frames drawn from the seed,
each from the program's state before it (``step_*``; ``check.py``). The
first session's keyframes against the ground truth (``ate``) go to
standard error: the weights' own error swamps what it could tell
(PERF.md).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from slam_bench import check as compare
from slam_bench import costs, harness


def _droid(ctx):
    return ctx.port.Droid(ctx.droid_config, params=ctx.params, device=ctx.device)


def _track(d, inputs, k):
    d.track(k, inputs["images"][k], intrinsics=inputs["intrinsics"][k])


# the keyframe buffers of a fused tracking state that the check reads
_KEPT = ("tstamp", "poses", "disps", "counter")


def _session_copy(d):
    """Device copies of a session's keyframe buffers, queued on the
    tracking stream behind the frame's work: no host read."""
    return {f: getattr(d._state, f).clone() for f in _KEPT}


def _host_state(copy):
    n = int(copy["counter"])
    return {"tstamps": copy["tstamp"][:n].float().cpu().numpy(), "poses": copy["poses"][:n].float().cpu().numpy(),
            "disps": copy["disps"][:n].float().cpu().numpy()}


def setup(ctx):
    d = _droid(ctx)
    for k in range(ctx.args["warm_frames"]):
        _track(d, ctx.inputs, k)
    d.sync()
    return {}


def window(ctx, st, seconds: float):
    torch, cuda = ctx.torch, ctx.device.type == "cuda"
    inputs = ctx.inputs
    frames = len(inputs["images"])
    events, host_s = [], []
    kept, pending = [], None
    check_frames = ctx.args["check_frames"]
    done = 0
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    stop = False
    while not stop:
        d = _droid(ctx)
        for k in range(frames):
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            h0 = time.perf_counter()
            _track(d, inputs, k)
            h1 = time.perf_counter()
            if cuda:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                events.append((e0, e1))
            host_s.append(h1 - h0)
            done += 1
            if k + 1 == check_frames:
                kept.append(_session_copy(d))  # after the frame's end event
            if h1 >= deadline:
                stop = True
                break
        if not kept:
            pending = (d, k + 1)  # the first session, tracked on to check_frames after the window
        del d
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if pending is not None:
        d, k0 = pending
        for k in range(k0, check_frames):
            _track(d, inputs, k)
        kept.append(_session_copy(d))
        del d
    del pending
    states = [_host_state(c) for c in kept]
    del kept
    if cuda:
        frame_ms = [e0.elapsed_time(e1) for e0, e1 in events]
    else:
        frame_ms = [1e3 * s for s in host_s]
    st["first"], st["sessions"] = states[0], states[1:]
    st["host_ms"] = [1e3 * s for s in host_s]
    return {"track_fps": done / (t1 - t0), "frame_p95_ms": harness.p95(frame_ms)}, done


def _count(ctx, start: int, frames: int):
    """The work of frames ``start`` to ``start + frames`` of a session, read from the
    program's public state after each frame: which frames were keyframes,
    which were culled, and the edges each operator iteration ran over."""
    cfg = ctx.droid_config
    H, W = cfg.image_size
    h, w = cfg.feat_size
    cdt = cfg.compute_dtype
    fb = 2 if cdt == "bfloat16" else 4
    flops, lookup_bytes, lookup_ops = {}, 0, {}
    d = _droid(ctx)
    warm = cfg.warmup
    init_edges = sum(1 for a in range(warm) for b in range(warm) if 0 < abs(a - b) <= 3)
    keyframes = culls = 0
    for k in range(start + frames):
        c0 = d.counter
        _track(d, ctx.inputs, k)
        c1 = d.counter
        if k < start:
            continue
        costs.add(flops, "float32", costs.encoder_flops(H, W, 128))  # fnet, every frame
        if c0 > 0:  # the motion filter's f32 probe: one edge, no aggregation
            costs.add(flops, "float32", costs.update_flops(1, h, w) + costs.lookup_dots(1, h, w))
            b, o = costs.lookup_work(1, h, w, 4)
            lookup_bytes += b
            costs.add(lookup_ops, "float32", o)
        is_kf = c1 > 0 and round(float(d.tstamps[-1])) == k
        if not is_kf:
            continue
        keyframes += 1
        costs.add(flops, "float32", costs.encoder_flops(H, W, 256))  # cnet
        edges = d.edges
        runs = []
        if c0 < warm and c1 == warm:  # the initialisation
            runs = [(init_edges, warm)] * 8 + [(len(edges) + len(d.inactive_edges), warm)] * 8
        elif c0 >= warm:
            culled = c1 == c0
            culls += culled
            srcs = len({i for i, _ in edges})
            runs = [(len(edges), srcs)] * (cfg.frontend_iters1 + (0 if culled else cfg.frontend_iters2))
        for e, srcs in runs:
            costs.add(flops, cdt, costs.update_flops(e, h, w, srcs) + costs.lookup_dots(e, h, w))
            b, o = costs.lookup_work(e, h, w, fb)
            lookup_bytes += b
            costs.add(lookup_ops, cdt, o)
    del d
    return {"flops": flops, "corr_level": {"bytes": lookup_bytes, "ops": lookup_ops},
            "keyframes": keyframes, "culls": culls}


def trace(ctx, st):
    total = len(ctx.inputs["images"])
    n = min(ctx.args["trace_frames"], total)
    start = min(ctx.args["trace_start"], total - n)
    d = _droid(ctx)
    for k in range(start):
        _track(d, ctx.inputs, k)

    def stretch():
        for k in range(start, start + n):
            _track(d, ctx.inputs, k)

    traced = harness.profile_stretch(ctx.torch, stretch, units=n)
    del d
    work = _count(ctx, start, n)
    return harness.Trace(kind="track", stretch=traced, host_ms=st["host_ms"],
                         counters={"keyframes": work["keyframes"], "culls": work["culls"]}, work=work)


def follow(ctx):
    """Replay a session with the program, as the window ran it, up to
    ``check_frames`` frames, keeping the state before and after the frames
    the check follows: the frame that initialises the map (the start) and
    ``check_steps`` frames drawn from the seed. Returns (the keyframes
    after ``check_frames`` frames, [(frame, before, after)])."""
    k_check = ctx.args["check_frames"]
    rng = np.random.default_rng([ctx.seed, 1])
    pool = np.arange(ctx.droid_config.warmup, k_check)
    drawn = set(int(k) for k in rng.choice(pool, size=min(ctx.args["check_steps"], len(pool)), replace=False))
    d = _droid(ctx)
    steps, init_done = [], False
    with ctx.torch.no_grad():
        for k in range(k_check):
            take = k in drawn or not init_done
            if take:
                before = compare.state_snapshot(d._state)
            _track(d, ctx.inputs, k)
            if take:
                after = compare.state_snapshot(d._state)
                if k in drawn or bool(after["is_init"]):
                    steps.append((k, before, after))
                init_done = bool(after["is_init"])
        replay = compare.keyframe_state(d)
    del d
    harness.free_device(ctx)
    return replay, steps


def reference_steps(ctx, steps, mode: str = "float32"):
    """The reference's state after each followed frame, from the program's
    state before it."""
    with compare.precision(mode) as dtype, ctx.torch.no_grad():
        ref = compare.reference_droid(ctx.fields, ctx.weights, ctx.device, dtype)
        out = [compare.ref_track_step(ref, before, k, ctx.inputs) for k, before, _ in steps]
    del ref
    harness.free_device(ctx)
    return out


def step_readings(steps, afters, refs):
    """The compared numbers of the followed steps, each side's state after
    a step in ``afters`` against the reference's in ``refs``: of the
    steps after the map's initialisation, the worst ``step_keyframes_apart``,
    the median over the steps of the larger of ``step_pose_gap`` and
    ``step_disp_gap`` (``step_gap_med``), and the median of
    ``step_disp_gap`` (``step_disp_med``). One step in a few reads far above
    the rest on some seeds, as fp8 does (PERF.md), so the widest gap over
    the steps goes to standard error only."""
    rows = [dict(compare.step_numbers(before, after, ref))
            for (_, before, _), after, ref in zip(steps, afters, refs) if not _initialises(before, after, ref)]
    if not rows:
        return [("step_keyframes_apart", 0.0), ("step_gap_med", 0.0), ("step_disp_med", 0.0)]
    return [("step_keyframes_apart", max(r["step_keyframes_apart"] for r in rows)),
            ("step_gap_med", float(np.median([max(r["step_pose_gap"], r["step_disp_gap"]) for r in rows]))),
            ("step_disp_med", float(np.median([r["step_disp_gap"] for r in rows])))]


def _initialises(before, after, ref) -> bool:
    """The step is the one that initialises the map, on either side."""
    return not bool(before["is_init"]) and (bool(after["is_init"]) or bool(ref["is_init"]))


def init_readings(steps, afters, refs, gt):
    """The numbers of the step that initialises the map, the program's
    keyframes after it in ``afters`` against the reference's in ``refs``
    from the same state: ``init_unmoved`` (compared), and for standard
    error the widest and the median gaps after a similarity alignment
    (``init_pose_gap``, ``init_pose_med`` and their disparity counterparts;
    no limit holds on them, PERF.md) and each side's keyframes against the
    ground truth (``init_ate``, ``init_ref_ate``). Empty where no followed
    step initialises."""
    for (_, before, _), after, ref in zip(steps, afters, refs):
        if _initialises(before, after, ref):
            p, r = compare.rows(after), compare.rows(ref)
            return ([("init_unmoved", compare.init_unmoved(before, after, ref))]
                    + compare.keyframe_numbers(p, r, "init_") + compare.aligned_medians(p, r, "init_")
                    + [("init_ate", compare.ate(p, gt)), ("init_ref_ate", compare.ate(r, gt))])
    return []


def step_diagnostics(k, before, after, ref):
    """One followed step's widest gaps, for standard error."""
    return dict(compare.step_numbers(before, after, ref))


def check(ctx, st):
    first, sessions = st["first"], st["sessions"]
    st.clear()
    harness.free_device(ctx)
    replay, steps = follow(ctx)
    refs = reference_steps(ctx, steps)
    afters = [after for _, _, after in steps]
    gt = ctx.inputs["poses"]
    for (k, before, after), ref in zip(steps, refs):
        if not _initialises(before, after, ref):
            print(f"slam_bench: step {k}: keyframes {int(before['counter'])} -> {int(after['counter'])}, "
                  f"{step_diagnostics(k, before, after, ref)}", file=sys.stderr)
    init = dict(init_readings(steps, afters, refs, gt))
    print(f"slam_bench: init step: {init}; the window's keyframes against the ground truth: "
          f"ate {compare.ate(first, gt)!r}", file=sys.stderr)
    numbers = [("replay_gap", compare.replay_gap(replay, first)),
               ("session_gap", max((compare.replay_gap(s, first) for s in sessions), default=0.0)),
               ("init_unmoved", init.get("init_unmoved", float("inf")))]
    numbers += step_readings(steps, afters, refs)
    return compare.limits(numbers, ctx.cell.workload["check"])
