"""The stereo rig at the benchmark's EuRoC cell (``euroc-stereo-track-allkf``),
cut to a tiny size on the CPU:

* the port's fused tracking against the benchmark's plain reference
  (``slam_bench/reference``) in stereo, float32, bit for bit, on seeded
  random weights and on the shipped weights;
* the cell's generator: its left images are ``handheld``'s for the same
  seed, its right images the port's own stereo render
  (``data/synthetic.py``) of the same world and trajectory;
* the cell's driver: the state it hands the reference holds both rig
  images' features, encoded again from the inputs, bit for bit the
  program's, and a followed step then gives gap 0 against the program;
* the flight recorder in stereo: each update iteration's ``it{k}.self``
  counts the valid self edges, its ``it{k}.corr`` stamp lies between the
  iteration's start and its operator's end, as in the monocular layout,
  to which stereo adds only the ``.self`` counts.
"""

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.data import synthetic
from droid_slam_tpu_torch.runtime import Droid, DroidConfig
from droid_slam_tpu_torch.runtime import fused as fused_step
from slam_bench import check, harness, run
from slam_bench.tests.conftest import tiny

torch.set_num_threads(2)

CELL = "euroc-stereo-track-allkf"
FRAMES = 20  # warmup 15: the init at frame 14, then 5 updates
SEED = 2**31 + 7


@pytest.fixture(scope="module")
def cpu_f32():
    """Thread-count-independent CPU convolutions (oneDNN off)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _cell(frames=FRAMES):
    cell = tiny(CELL, frames=frames)
    cell.config["droid_config"]["compute_dtype"] = "float32"
    return cell


def _inputs(cell, seed=SEED):
    gen = harness.load_module("generators", cell.workload["generator"])
    return gen.generate(seed, image_size=cell.droid_fields()["image_size"], **cell.workload["generator_args"])


def _track(d, inputs, frames, at=()):
    """Track ``frames`` frames; the keyframe state after each count in ``at``
    and, per frame, the valid self edges after it."""
    states, selfs = {}, []
    for k in range(frames):
        d.track(k, inputs["images"][k], intrinsics=inputs["intrinsics"][k])
        selfs.append(sum(i == j for i, j in d.edges))
        if k + 1 in at:
            states[k + 1] = check.keyframe_state(d)
    return states, selfs


AT = [15, FRAMES]  # the keyframe states compared: after the init and at the end


def _droids(weights):
    """(the reference's Droid, the port's) at the tiny cell in float32, on
    seeded random weights or on the shipped weights."""
    from slam_bench.reference.models.droid_net import init_params
    from slam_bench.reference.runtime.config import DroidConfig as RefConfig
    from slam_bench.reference.runtime.droid import Droid as RefDroid

    fields = _cell().droid_fields()
    params = init_params(3) if weights == "seeded" else None
    path = None if params is not None else str(_cell().weights_path())
    return (RefDroid(RefConfig(**fields), params=params, weights=path, device="cpu"),
            Droid(DroidConfig(**fields), params=params, weights=path, device="cpu"))


@pytest.fixture(scope="module")
def shipped_port(cpu_f32):
    """The port's Droid tracked over the tiny cell on the shipped weights:
    (the Droid, its keyframe states at AT, its valid self edges per frame)."""
    _, port = _droids("shipped")
    with torch.no_grad():
        states, selfs = _track(port, _inputs(_cell()), FRAMES, AT)
    return port, states, selfs


@pytest.mark.parametrize("weights", ["seeded", "shipped"])
def test_port_matches_the_reference_in_stereo_float32(cpu_f32, shipped_port, weights):
    fields = _cell().droid_fields()
    assert fields["stereo"] and fields["warmup"] == 15
    inputs = _inputs(_cell())
    ref, port = _droids(weights)
    with torch.no_grad():
        got_ref, _ = _track(ref, inputs, FRAMES, AT)
        if weights == "shipped":
            port, got_port, selfs = shipped_port
        else:
            got_port, selfs = _track(port, inputs, FRAMES, AT)
    assert port.counter == FRAMES and max(selfs) > 0  # every frame keyframed; self edges in the graph
    for k in AT:
        for key in ("tstamps", "poses", "disps"):
            assert np.array_equal(got_ref[k][key], got_port[k][key]), (weights, k, key)


def test_generator_left_is_handheld_right_is_the_ports_stereo_render():
    args = dict(frames=5, t_sigma=0.04, r_sigma=0.01)
    pairs = harness.load_module("generators", "handheld_stereo").generate(11, (48, 64), **args)
    mono = harness.load_module("generators", "handheld").generate(11, (48, 64), **args)
    seq = synthetic.render_sequence(np.random.default_rng(11), n_frames=5, image_size=(48, 64), stereo=True)
    assert pairs["images"].shape == (5, 2, 48, 64, 3) and pairs["images"].dtype == np.uint8
    assert np.array_equal(pairs["images"][:, 0], mono["images"])
    assert np.array_equal(pairs["images"][:, 1], seq["images_right"])
    assert not np.array_equal(pairs["images"][:, 0], pairs["images"][:, 1])
    for key in ("poses", "intrinsics"):
        assert np.array_equal(pairs[key], mono[key]) and np.array_equal(pairs[key], seq[key]), key


def test_driver_hands_the_reference_both_rig_features_and_a_step_gives_gap_0(cpu_f32):
    cell = _cell()
    cell.workload["driver_args"]["check_steps"] = 1  # the init's step and one after it
    ctx = run.make_context(cell, SEED, torch, torch.device("cpu"))
    driver = harness.load_module("drivers", cell.workload["driver"])
    _, steps = driver.follow(ctx)
    k, before, after = steps[-1]
    assert int(before["counter"]) > ctx.droid_config.warmup  # a step after the init
    # the program's own features at that state
    prog = ctx.port.Droid(ctx.droid_config, params=ctx.params, device="cpu")
    with torch.no_grad():
        for f in range(k):
            prog.track(f, ctx.inputs["images"][f], intrinsics=ctx.inputs["intrinsics"][f])
        ref = check.reference_droid(ctx.fields, ctx.weights, ctx.device)
        driver._load_state(ref, before, ctx.inputs)
    n = int(before["counter"])
    got, want = ref._state, prog._state
    assert torch.equal(got.fmaps[:n], want.fmaps[:n]) and torch.equal(got.pfmap, want.pfmap)
    assert not torch.equal(got.fmaps[:n, 0], got.fmaps[:n, 1])  # the right image's, not a copy of the left's
    refs = driver.reference_steps(ctx, steps)
    for (_, b, a), r in zip(steps, refs):
        if not driver._initialises(b, a, r):
            assert dict(check.step_numbers(b, a, r)) == {"step_keyframes_apart": 0.0, "step_pose_gap": 0.0,
                                                          "step_disp_gap": 0.0}


def test_self_counts_and_lookup_stamps_of_each_update_iteration(shipped_port):
    d, _, selfs = shipped_port
    warm, iters = d.config.warmup, d.config.frontend_iters1 + d.config.frontend_iters2
    rows = d.session.rows()
    assert [r["tstamp"] for r in rows] == [float(k) for k in range(FRAMES)]
    for k, (r, n_self) in enumerate(zip(rows, selfs)):
        ran = [it for it in range(iters) if f"it{it}.gn" in r]
        assert ran == (list(range(iters)) if k >= warm else [])
        for it in ran:
            assert r[f"it{it}.self"] == n_self > 0  # the graph holds still over a frame's iterations
            assert r[f"it{it}.start"] <= r[f"it{it}.corr"] <= r[f"it{it}.op"]


MONO_ITERATION = ["start", "corr", "op", "gn", "edges", "cells"]
MONO_LAYOUT = (["tstamp", "step.start", "fnet.end", "probe.end", "keyframe.start", "keyframe.end", "init.start",
                "init.end", "update.start", "upkeep.end"]
               + [f"it{k}.{p}" for k in range(4) for p in MONO_ITERATION]
               + ["cull_dist.end", "cull.start", "cull.end", "keep.start"]
               + [f"it{k}.{p}" for k in range(4, 6) for p in MONO_ITERATION]
               + ["update.resume", "update.end", "step.end"])


def test_monocular_layout_is_unchanged_and_stereo_adds_two_columns_per_iteration():
    mono = DroidConfig(image_size=(48, 64))
    assert list(fused_step.trace_slots(mono)) == MONO_LAYOUT and len(MONO_LAYOUT) == 53
    phases = fused_step.trace_phases(mono)
    assert not any(name.endswith(".self") for name in phases)
    assert all(phases[f"it{k}.corr"] == "update" for k in range(6))
    stereo = DroidConfig(image_size=(48, 64), stereo=True)
    want = [n for m in MONO_LAYOUT for n in ([m, m.replace(".cells", ".self")] if m.endswith(".cells") else [m])]
    assert list(fused_step.trace_slots(stereo)) == want
    sp = fused_step.trace_phases(stereo)
    assert all(sp[f"it{k}.corr"] == "update" and f"it{k}.self" not in sp for k in range(6))
    assert sp == phases
