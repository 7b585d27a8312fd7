"""The plain reference against the port's CPU path at a tiny size. On the
CPU the port runs its plain versions, which the reference froze, so in
float32 the two agree bit for bit: tracking, and the reference's own
msgpack reader."""

import numpy as np
import torch

from slam_bench import check, harness
from slam_bench.tests.conftest import tiny


def _inputs(cell, seed=3):
    gen = harness.load_module("generators", cell.workload["generator"])
    fields = cell.droid_fields()
    return gen.generate(seed, image_size=fields["image_size"], **cell.workload["generator_args"])


def track_snapshots(d, inputs, at):
    """Track the first max(at) frames with ``d`` and keep its keyframe
    state after each frame count in ``at``."""
    out = {}
    for k in range(max(at)):
        d.track(k, inputs["images"][k], intrinsics=inputs["intrinsics"][k])
        if k + 1 in at:
            out[k + 1] = check.keyframe_state(d)
    return out


def test_weights_reader_matches_the_port():
    from droid_slam_tpu_torch.models.weights import load_weights as port_load
    from slam_bench.reference.models.weights import load_weights as ref_load

    cell = harness.Cell.load("tum-track-allkf")
    a, b = ref_load(str(cell.weights_path())), port_load(str(cell.weights_path()))
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_tracking_matches_the_port_in_float32(torch_cpu):
    from droid_slam_tpu_torch.runtime import Droid, DroidConfig

    cell = tiny("tum-track-allkf", frames=14)
    fields = {**cell.droid_fields(), "compute_dtype": "float32"}
    inputs = _inputs(cell)
    weights = str(cell.weights_path())
    with torch.no_grad():
        ref = check.reference_droid(fields, weights, torch.device("cpu"))
        port = Droid(DroidConfig(**fields), weights=weights, device="cpu")
        got_ref = track_snapshots(ref, inputs, [8, 14])
        got_port = track_snapshots(port, inputs, [8, 14])
    for k in (8, 14):
        for key in ("tstamps", "poses", "disps"):
            assert np.array_equal(got_ref[k][key], got_port[k][key]), (k, key)


def test_reference_launches_no_kernel():
    from slam_bench.reference.ops import corr

    assert corr.corr_level is corr.corr_level_ref
