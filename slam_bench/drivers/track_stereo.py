"""Window driver of the stereo tracking cells: ``track_sessions``'s
closed-loop sessions, window, replay and check, with three things of a
stereo rig its own.

* The state handed to the reference. The program keeps only the left image
  of each keyframe, so the mono hand-off (``check._load_state``) cannot
  encode the right one. Here both rig images of every keyframe, and of
  the last keyframe for the probe's ``pfmap``, are encoded again by the
  reference from the cell's own inputs, found by the keyframe's tstamp
  (the frame's index); nothing of the program's features is copied.
* The count of work of the traced frames (``trace``): fnet encodes both
  images of every frame; the update and its lookups run over the valid
  edges, the stereo self edges (i, i) among them, as ``track_sessions``
  already counts them.
* ``check``, which calls the reference's steps with this hand-off
  (``track_sessions.check`` reaches its own).
"""

from __future__ import annotations

import sys

import numpy as np

from slam_bench import check as compare
from slam_bench import costs, harness
from slam_bench.drivers import track_sessions as mono
from slam_bench.drivers.track_sessions import (  # noqa: F401  (the driver's interface)
    _initialises, follow, init_readings, setup, step_diagnostics, step_readings, window)


def _load_state(d, snap, inputs) -> None:
    """Write the program's state ``snap`` into the reference Droid ``d``'s
    fused state, the features of both rig images encoded again from
    ``inputs`` and the context from the stored left image, one keyframe per
    call, as the program encodes a frame."""
    import torch

    st = d._state
    for f in compare._STATE_FIELDS:
        getattr(st, f).copy_(snap[f].to(getattr(st, f).dtype))
    n = int(snap["counter"])
    st.images[:n] = snap["images"].to(st.images.device)
    frames = np.round(snap["tstamp"][:n].double().numpy()).astype(np.int64)
    for s, k in enumerate(frames):
        fmap = d.net.features(torch.as_tensor(inputs["images"][k], device=st.fmaps.device))
        net, inp = d.net.context(st.images[s:s + 1])
        st.fmaps[s] = fmap.to(st.fmaps.dtype)
        st.nets[s] = net[0].to(st.nets.dtype)
        st.inps[s] = inp[0].to(st.inps.dtype)
    if n > 0:  # the probe's: the last keyframe's pair and its left image's context
        st.pfmap.copy_(fmap)
        st.pnet.copy_(net[0].float())
        st.pinp.copy_(inp[0].float())
    d._initialized = bool(snap["is_init"])
    torch.cuda.synchronize() if st.poses.is_cuda else None


def ref_track_step(d, before, k: int, inputs):
    """The reference Droid ``d`` tracks frame ``k`` from the program's state
    ``before``; returns its state after the frame (host copies)."""
    _load_state(d, before, inputs)
    d.track(k, inputs["images"][k], intrinsics=inputs["intrinsics"][k])
    return compare.state_snapshot(d._state)


def reference_steps(ctx, steps, mode: str = "float32"):
    """The reference's state after each followed frame, from the program's
    state before it."""
    with compare.precision(mode) as dtype, ctx.torch.no_grad():
        ref = compare.reference_droid(ctx.fields, ctx.weights, ctx.device, dtype)
        out = [ref_track_step(ref, before, k, ctx.inputs) for k, before, _ in steps]
    del ref
    harness.free_device(ctx)
    return out


def trace(ctx, st):
    """``track_sessions.trace``, its count of work with fnet on the right
    image of every traced frame too (the stretch starts after the
    initialisation, so the mono count of the init's edges, which stereo
    leaves |a − b| = 1 out of, never enters it)."""
    traced = mono.trace(ctx, st)
    H, W = ctx.droid_config.image_size
    costs.add(traced.work["flops"], "float32", traced.stretch.units * costs.encoder_flops(H, W, 128))
    return traced


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
