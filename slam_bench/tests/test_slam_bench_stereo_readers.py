"""The two readers of the stereo step's recorder columns
(``fused.self_edges_per_update``, ``ops.corr_ms_per_frame``) on a synthetic
stereo session: ``test_slam_bench_trace_readers``'s session and rows, with
each update iteration's lookups ending CORR after its start and its valid
self edges counted. The phase split, the clock fit and the existing
readers take the extra stamp in order; a monocular ring, as the parent
writes it, gives both new readers None."""

import numpy as np
import pytest
import torch

from slam_bench import harness, recorder
from slam_bench.tests import test_slam_bench_trace_readers as mono

US = mono.US
CORR = 15 * US  # each iteration's start to after its lookups
SELF = [2, 3, 3, 4, 4, 4]  # valid self edges of each update iteration


def _session(base):
    """The mono readers' session with the stereo layout and columns: a
    replay's row is mono's with ``it{k}.corr`` and ``it{k}.self`` added."""
    from droid_slam_tpu_torch.runtime import DroidConfig
    from droid_slam_tpu_torch.runtime.fused import trace_phases, trace_slots
    from droid_slam_tpu_torch.utils import profiling

    s, lo, hi = mono._session(base=base)
    config = DroidConfig(image_size=(48, 64), stereo=True)
    slots, s.phases = trace_slots(config), trace_phases(config)
    rows = s.rows()
    ring = profiling.new_ring(len(slots), "cpu")
    s.ring, s.row, s.slots = ring["trace_ring"], ring["trace_row"], slots
    for r in rows:
        profiling.ring_begin(s.ring, s.row, torch.tensor(r["tstamp"]))
        if "it0.start" in r:
            for k, n in enumerate(SELF):
                r[f"it{k}.corr"] = r[f"it{k}.start"] + CORR
                r[f"it{k}.self"] = n
        for name, v in r.items():
            if name != "tstamp":
                s.ring[int(s.row), slots[name]] = v
    return s, lo, hi


def _read(name, trace):
    return harness.load_module("metrics", name).read(trace)


def test_stereo_readers_on_the_synthetic_session():
    s, lo, hi = _session(4 * 10**12)
    t = mono._trace(lo, hi, mono._stamp_records(s))
    assert _read("fused.self_edges_per_update", t) == pytest.approx(np.mean(SELF))
    assert _read("ops.corr_ms_per_frame", t) == pytest.approx(6 * CORR * 1e-6)
    # the update phase still runs from each iteration's start to after its operator
    assert _read("models.update_ms_per_frame", t) == pytest.approx(0.24)
    assert _read("ops.ba_ms_per_frame", t) == pytest.approx(0.186)
    assert _read("fused.edges_per_update", t) == pytest.approx(np.mean(mono.EDGES))


def test_phases_and_clock_fit_take_the_lookup_stamp_in_order():
    s, lo, hi = _session(5 * 10**12)
    _, rows = recorder.replay_rows(mono._trace(lo, hi))
    assert rows
    for r in rows:
        p = recorder.phases(s, r)
        assert sum(sum(v) for k, v in p.items() if k not in ("step", "edges")) == p["step"][0] == mono.STEP
        assert p["update"] == [CORR, 40 * US - CORR] * 6 and p["edges"] == mono.EDGES
    a, b, t0 = recorder.clock_fit(mono._trace(lo, hi, mono._stamp_records(s)), s)
    assert a == pytest.approx(1 + mono.DRIFT, abs=1e-6) and b == pytest.approx(t0 + mono.OFFSET, abs=1)


def test_a_monocular_ring_gives_none():
    s, lo, hi = mono._session(base=6 * 10**12)
    t = mono._trace(lo, hi, mono._stamp_records(s))
    assert _read("fused.edges_per_update", t) is not None
    assert _read("fused.self_edges_per_update", t) is None
    assert _read("ops.corr_ms_per_frame", t) is None
