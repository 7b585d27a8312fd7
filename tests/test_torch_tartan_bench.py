"""The benchmark's TartanAir cell (``tartan-track-loop``), cut to a tiny size
on the CPU:

* the port's fused tracking against the benchmark's plain reference
  (``slam_bench/reference``) under the TartanAir flags (frontend radius 1,
  nms 1, window 20, warmup 12), float32, bit for bit, on seeded random
  weights and on the shipped weights, through the init and the update
  frames after it;
* the cell's configuration: its program fields are ``preset("tartanair")``;
* the cell's generator: ``data/synthetic.py::render_loop_sequence`` of the
  port, bit for bit, for two seeds;
* the flight recorder in mono: each update iteration's ``it{k}.corr`` stamp
  lies between its start and its operator's end.
"""

import dataclasses

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.data import synthetic
from droid_slam_tpu_torch.runtime import Droid, DroidConfig, preset
from slam_bench import check, harness
from slam_bench.tests.conftest import tiny

torch.set_num_threads(2)

CELL = "tartan-track-loop"
FRAMES = 17  # warmup 12: the init at frame 11, then 5 updates
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def cpu_f32():
    """Thread-count-independent CPU convolutions (oneDNN off)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _cell():
    cell = tiny(CELL, frames=FRAMES)
    cell.config["droid_config"]["compute_dtype"] = "float32"
    return cell


def _inputs(cell, seed=SEED):
    gen = harness.load_module("generators", cell.workload["generator"])
    return gen.generate(seed, image_size=cell.droid_fields()["image_size"], **cell.workload["generator_args"])


AT = [12, FRAMES]  # the keyframe states compared: after the init and at the end


def _track(d, inputs):
    states = {}
    for k in range(FRAMES):
        d.track(k, inputs["images"][k], intrinsics=inputs["intrinsics"][k])
        if k + 1 in AT:
            states[k + 1] = check.keyframe_state(d)
    return states


def _droids(weights):
    """(the reference's Droid, the port's) at the tiny cell in float32, on
    seeded random weights or on the shipped weights."""
    from slam_bench.reference.models.droid_net import init_params
    from slam_bench.reference.runtime.config import DroidConfig as RefConfig
    from slam_bench.reference.runtime.droid import Droid as RefDroid

    fields = _cell().droid_fields()
    params = init_params(5) if weights == "seeded" else None
    path = None if params is not None else str(_cell().weights_path())
    return (RefDroid(RefConfig(**fields), params=params, weights=path, device="cpu"),
            Droid(DroidConfig(**fields), params=params, weights=path, device="cpu"))


@pytest.fixture(scope="module")
def shipped_port(cpu_f32):
    """The port's Droid tracked over the tiny cell on the shipped weights,
    and its keyframe states at AT."""
    _, port = _droids("shipped")
    with torch.no_grad():
        states = _track(port, _inputs(_cell()))
    return port, states


@pytest.mark.parametrize("weights", ["seeded", "shipped"])
def test_port_matches_the_reference_under_the_tartanair_flags_float32(cpu_f32, shipped_port, weights):
    fields = _cell().droid_fields()
    assert (fields["frontend_radius"], fields["frontend_nms"], fields["frontend_window"], fields["warmup"]) == \
        (1, 1, 20, 12)
    inputs = _inputs(_cell())
    ref, port = _droids(weights)
    with torch.no_grad():
        got_ref = _track(ref, inputs)
        if weights == "shipped":
            port, got_port = shipped_port
        else:
            got_port = _track(port, inputs)
    assert port.counter == FRAMES  # every frame keyframed: the init and 5 updates
    for k in AT:
        for key in ("tstamps", "poses", "disps"):
            assert np.array_equal(got_ref[k][key], got_port[k][key]), (weights, k, key)


def test_configuration_is_the_tartanair_preset():
    fields = harness.Cell.load(CELL).config["droid_config"]
    want = dataclasses.asdict(preset("tartanair"))
    want["image_size"] = list(want["image_size"])
    assert fields == want


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_generator_is_the_ports_loop_sequence(seed):
    args = harness.Cell.load(CELL).workload["generator_args"]
    got = harness.load_module("generators", "courtyard_loop").generate(seed, (24, 32), **dict(args, frames=9))
    want = synthetic.render_loop_sequence(np.random.default_rng(seed), n_frames=9, image_size=(24, 32),
                                          radius=args["radius"], revisit=args["revisit"])
    assert got["images"].shape == (9, 24, 32, 3) and got["images"].dtype == np.uint8
    for key in ("images", "poses", "intrinsics"):
        assert np.array_equal(got[key], want[key]), key


def test_lookup_stamps_of_each_monocular_update_iteration(shipped_port):
    d, _ = shipped_port
    warm, iters = d.config.warmup, d.config.frontend_iters1 + d.config.frontend_iters2
    rows = d.session.rows()
    assert [r["tstamp"] for r in rows] == [float(k) for k in range(FRAMES)]
    for k, r in enumerate(rows):
        ran = [it for it in range(iters) if f"it{it}.gn" in r]
        assert ran == (list(range(iters)) if k >= warm else [])
        assert all(f"it{it}.corr" not in r for it in range(iters) if it not in ran)
        for it in ran:
            assert r[f"it{it}.start"] <= r[f"it{it}.corr"] <= r[f"it{it}.op"]
