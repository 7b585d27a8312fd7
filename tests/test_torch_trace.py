"""The port's tracing (``utils/profiling.py``): host spans and the fused
step's device flight recorder.

* Spans: nesting, parents, the session and frame taken from the enclosing
  span, tags, the bounded per-session buffer and the history of the last
  sessions; under a CPU ``torch.profiler`` each span is a
  ``record_function`` range starting within 1 ms of its own start, and
  without a profiler no range is opened.
* The recorder on the CPU: the row cursor wraps at ``RING_ROWS``; tracking
  40 frames at the benchmark fixture's size (48x64, buffer 40, warmup 8,
  every frame a keyframe) writes one row per frame whose stamps follow the
  step's order, whose branch columns match the public state, whose
  edge count is ``len(Droid.edges)`` and whose Schur cell counts are
  present for every update iteration and bounded by the edge slots; the
  keyframes equal, bit for bit, those of the same run with the stamps
  removed. The trained replay
  (probe skips, culls) holds the branch columns on every side.
* The phase map (``fused.trace_phases``): each row's stamps, each less
  the one before it, sum by phase to the step, with one entry per body
  taken and one exit per return.
* ``Droid``'s spans while tracking; a
  ``device_trace`` (``apps/demo.py --profile``) shows them in its Chrome
  trace.
* On the card (``cuda``): one replay fills a row with non-decreasing
  stamps, and in a profiled stretch every stamp pairs with its kernel's
  record on a line (the clocks drift apart), each span's range within 1
  ms of its start.
  This module imports no JAX, so that on the card's machine (which has
  none) these run as ``python -m pytest tests/test_torch_trace.py -m cuda
  --noconftest``.
"""

import gc
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.data import synthetic
from droid_slam_tpu_torch.runtime import Droid, DroidConfig
from droid_slam_tpu_torch.runtime import fused as fused_step
from droid_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)

SHIPPED = str(Path(__file__).resolve().parents[1] / "weights" / "droid_synth.msgpack")

FRAMES = 40
SIZE = (48, 64)
ALLKF = dict(image_size=SIZE, buffer=40, warmup=8, filter_thresh=-1.0, keyframe_thresh=0.0)
COUNTS = (".edges", ".cells")  # the recorder's count columns (the rest are times)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_spans_nest_with_parents_session_frame_and_tags():
    s = profiling.Session()
    with profiling.span("outer", session=s, frame=7, kind="a") as outer:
        with profiling.span("inner") as inner:
            with profiling.span("leaf", frame=8):
                pass
        with profiling.span("second"):
            pass
    recs = {r.name: r for r in s.spans}
    assert [r.name for r in s.spans] == ["leaf", "inner", "second", "outer"]  # in the order they ended
    assert recs["outer"].parent is None and recs["outer"].tags == {"kind": "a"}
    assert recs["inner"].parent == outer.id and recs["second"].parent == outer.id
    assert recs["leaf"].parent == inner.id
    assert recs["inner"].frame == 7 and recs["leaf"].frame == 8
    assert recs["outer"].start_ns <= recs["inner"].start_ns <= recs["leaf"].start_ns
    assert recs["leaf"].end_ns <= recs["inner"].end_ns <= recs["second"].start_ns <= recs["outer"].end_ns
    assert outer.seconds == (recs["outer"].end_ns - recs["outer"].start_ns) / 1e9


def test_spans_outside_a_session_are_not_kept():
    s = profiling.Session()
    with profiling.span("loose") as loose:
        with profiling.span("inside"):
            pass
    assert loose.seconds >= 0 and not s.spans
    assert not any(r.name in ("loose", "inside") for x in profiling.sessions() for r in x.spans)


def test_span_buffer_is_bounded_and_history_keeps_the_last_sessions():
    s = profiling.Session()
    for k in range(profiling.SPAN_CAPACITY + 10):
        with profiling.span("s", session=s, frame=k):
            pass
    assert len(s.spans) == profiling.SPAN_CAPACITY and s.spans[0].frame == 10  # the oldest dropped
    made = [profiling.Session() for _ in range(profiling.HISTORY + 1)]
    assert profiling.sessions() == made[1:]
    assert len({x.id for x in made}) == len(made)


def test_span_is_a_profiler_range_only_under_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    s = profiling.Session()
    with profiling.span("quiet", session=s):
        pass
    assert not opened
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(5):
            with profiling.span("traced", session=s, frame=k):
                time.sleep(0.001)
    assert opened == ["traced"] * 5
    ranges = sorted(e.start_ns() for e in prof.profiler.kineto_results.events() if e.name() == "traced")
    starts = sorted(r.start_ns for r in s.spans if r.name == "traced")
    assert len(ranges) == 5
    assert max(abs(a - b) for a, b in zip(ranges, starts)) < 1_000_000  # same clock, within 1 ms


# ---------------------------------------------------------------------------
# the flight recorder on the CPU
# ---------------------------------------------------------------------------


def test_ring_cursor_wraps_and_rows_come_oldest_first():
    s = profiling.Session()
    ring = profiling.new_ring(5, "cpu")
    s.ring, s.row = ring["trace_ring"], ring["trace_row"]
    s.slots = {"tstamp": 0, "step.start": 1, "a": 2, "b": 3, "n": 4}
    n = profiling.RING_ROWS + 6
    for k in range(n):
        profiling.ring_begin(s.ring, s.row, torch.tensor(k + 0.5))
        if k % 2:
            profiling.stamp(s.ring, s.row, 2)
        profiling.count(s.ring, s.row, 4, torch.arange(k % 7) < 3)
    assert int(s.row) == (n - 1) % profiling.RING_ROWS == 5
    rows = s.rows()
    assert [r["tstamp"] for r in rows] == [k + 0.5 for k in range(6, n)]
    for k, r in zip(range(6, n), rows):
        assert ("a" in r) == bool(k % 2) and "b" not in r  # an empty column is left out
        assert r["n"] == min(k % 7, 3)
        assert r["step.start"] <= r.get("a", r["step.start"])


def _track(config, frames, weights, stamps=True, monkeypatch=None):
    """Track ``frames`` on the CPU; returns (the Droid, per frame: the
    keyframe count before and after, the active edges after)."""
    if not stamps:
        for name in ("ring_begin", "stamp", "count"):
            monkeypatch.setattr(profiling, name, lambda *a: None)
    d = Droid(DroidConfig(**config), device="cpu", weights=weights)
    log = []
    for t, (img, intr) in enumerate(frames):
        c0 = d.counter
        d.track(t, img, intrinsics=intr)
        log.append((c0, d.counter, len(d.edges)))
    return d, log


def _frames(n, size, seed):
    seq = synthetic.render_sequence(np.random.default_rng(seed), n_frames=n, image_size=size)
    return [(seq["images"][t], seq["intrinsics"][t]) for t in range(n)]


@pytest.fixture(scope="module")
def allkf_run():
    return _track(ALLKF, _frames(FRAMES, SIZE, 5), SHIPPED)


def test_one_row_per_frame_in_the_steps_order(allkf_run):
    d, _ = allkf_run
    rows = d.session.rows()
    assert [r["tstamp"] for r in rows] == [float(t) for t in range(FRAMES)]
    slots = d.session.slots
    assert list(slots) == list(fused_step.trace_slots(d.config)) and d._state.trace_ring.shape[1] == len(slots)
    for r in rows:
        times = [r[n] for n in slots if n in r and n != "tstamp" and not n.endswith(COUNTS)]
        assert times == sorted(times)  # the columns are in the order the step reaches them


def test_branch_columns_match_the_public_state(allkf_run):
    d, log = allkf_run
    warm, iters = d.config.warmup, d.config.frontend_iters1 + d.config.frontend_iters2
    for t, (r, (c0, c1, _)) in enumerate(zip(d.session.rows(), log)):
        assert ("keyframe.start" in r) == (c1 == c0 + 1) == ("keyframe.end" in r)  # every frame keyframed
        assert ("init.start" in r) == (t == warm - 1) == ("init.end" in r)
        assert ("update.start" in r) == (t >= warm)
        assert "cull.start" not in r and ("keep.start" in r) == (t >= warm)
        ran = [k for k in range(iters) if f"it{k}.gn" in r]
        assert ran == (list(range(iters)) if t >= warm else [])


def test_phases_sum_to_the_step_with_an_entry_per_body_taken(allkf_run):
    d, _ = allkf_run
    phases = d.session.phases
    assert list(phases) == [n for n in d.session.slots
                            if n not in ("tstamp", "step.start") and not n.endswith(".cells")]
    for t, r in enumerate(d.session.rows()):
        prev, by_phase = r["step.start"], {}
        for name, value in r.items():
            if phases.get(name, "edges") != "edges":
                by_phase.setdefault(phases[name], []).append(value - prev)
                prev = value
        assert sum(map(sum, by_phase.values())) == r["step.end"] - r["step.start"]
        bodies = [n for n in ("keyframe.start", "init.start", "update.start", "cull.start", "keep.start") if n in r]
        assert len(by_phase["entry"]) == len(bodies)
        assert len(by_phase["exit"]) == (2 if t >= d.config.warmup else 1)  # the resume after keep; the end
        assert ("init" in by_phase) == (t == d.config.warmup - 1)


def test_edge_count_is_the_active_edges_after_the_frame(allkf_run):
    d, log = allkf_run
    counted = 0
    for r, (_, _, edges) in zip(d.session.rows(), log):
        its = [n for n in r if n.endswith(".edges")]
        if its:
            assert r[its[-1]] == edges > 0
            counted += 1
    assert counted == FRAMES - d.config.warmup


def test_cells_count_each_update_iteration(allkf_run):
    """Each update iteration's first GN step counts the (depth frame, pose)
    cells its Schur complement occupied: some, and at most two per edge
    slot (the E_i and E_j rows of each edge, active and inactive)."""
    d, _ = allkf_run
    slots = d.config.inactive_pad + fused_step._edge_slots(d.config)
    for r in d.session.rows():
        iters = [n[:-len(".gn")] for n in r if n.endswith(".gn")]
        assert [n[:-len(".cells")] for n in r if n.endswith(".cells")] == iters
        assert all(0 < r[f"{it}.cells"] <= 2 * slots for it in iters)


def test_the_recorder_leaves_the_keyframes_bit_for_bit(allkf_run, monkeypatch):
    d, _ = allkf_run
    plain, _ = _track(ALLKF, _frames(FRAMES, SIZE, 5), SHIPPED, stamps=False, monkeypatch=monkeypatch)
    assert d.counter == plain.counter
    for name in ("tstamps", "poses", "disps"):
        assert torch.equal(getattr(d, name), getattr(plain, name)), name
    assert torch.equal(plain._state.trace_ring, torch.full_like(plain._state.trace_ring, profiling.EMPTY))


def test_branch_columns_on_the_trained_replay():
    """The trained replay skips frames at the probe and culls each new
    keyframe: each frame's keyframe, update, cull and keep columns say what
    its keyframe count did."""
    from test_torch_trained import CONFIG as TRAINED_CONFIG  # (imports JAX)
    from test_torch_trained import FIXTURE, N_FRAMES

    seq = synthetic.render_sequence(np.random.default_rng(11), n_frames=N_FRAMES, image_size=(64, 96),
                                    t_sigma=0.25, r_sigma=0.02)
    frames = [(seq["images"][t], seq["intrinsics"][t]) for t in range(N_FRAMES)]
    d, log = _track(TRAINED_CONFIG, frames, FIXTURE)
    seen = set()
    for r, (c0, c1, _) in zip(d.session.rows(), log):
        kf, cull, keep = "keyframe.start" in r, "cull.start" in r, "keep.start" in r
        assert (c1 - c0) + cull == kf  # a kept keyframe adds one, a culled one none
        if "update.start" in r:
            assert cull != keep and cull == ("cull.end" in r)
        else:
            assert not (cull or keep)
        seen |= {("kf", kf), ("cull", cull), ("keep", keep)}
    assert {(b, v) for b in ("kf", "cull") for v in (True, False)} <= seen  # keep: the allkf run


# ---------------------------------------------------------------------------
# Droid's spans
# ---------------------------------------------------------------------------


def _children(session):
    kids = {}
    for r in session.spans:
        kids.setdefault(r.parent, []).append(r.name)
    return kids


def test_track_spans():
    frames = _frames(12, SIZE, 6)
    d, _ = _track(ALLKF, frames, SHIPPED)
    s = d.session
    kids = _children(s)
    tracks = [r for r in s.spans if r.name == "droid.track"]
    assert [r.frame for r in tracks] == list(range(12)) and all(r.parent is None for r in tracks)
    for r in tracks:
        assert kids[r.id][0] == "track.upload" and kids[r.id][-1] == "track.eager"  # the CPU is eager
    eager = {r.id: r for r in s.spans if r.name == "track.eager"}
    reads = [r for r in s.spans if r.name == "cond.read"]
    assert reads and all(r.parent in eager for r in reads)
    assert all(len([r for r in reads if r.parent == e]) <= 3 for e in eager if eager[e].frame >= 8)



def test_device_trace_shows_the_spans(tmp_path):
    """What ``apps/demo.py --profile`` writes: the tracked frames' spans in
    the Chrome trace, beside the operators."""
    frames = _frames(3, SIZE, 9)
    d = Droid(DroidConfig(**ALLKF), device="cpu", weights=SHIPPED)
    with profiling.device_trace(str(tmp_path)):
        for t, (img, intr) in enumerate(frames):
            d.track(t, img, intrinsics=intr)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("droid.track") == names.count("track.upload") == names.count("track.eager") == 3
    assert "cond.read" in names


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The CUDA device a ``cuda`` test runs on; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_session(device, frames):
    """A Droid on the card tracking ``frames`` (its first replays follow
    the init at frame 7 and the capture at frame 8)."""
    gc.collect()  # no earlier test's graph may be collected during this one's capture
    d = Droid(DroidConfig(**ALLKF), device=device, weights=SHIPPED)
    for t, (img, intr) in enumerate(frames):
        d.track(t, img, intrinsics=intr)
    d.sync()
    return d


@pytest.mark.cuda
def test_card_replay_fills_a_row_in_order(cuda_device):
    frames = _frames(12, SIZE, 7)
    d = _card_session(cuda_device, frames)
    assert d.graph is not None and d.graph.replays == 12 - d.config.warmup
    rows = d.session.rows()
    assert [r["tstamp"] for r in rows] == [float(t) for t in range(12)]
    for r in rows[d.config.warmup:]:
        times = [r[n] for n in d.session.slots if n in r and n != "tstamp" and not n.endswith(COUNTS)]
        assert times == sorted(times) and "keep.start" in r and "cull.start" not in r
    assert rows[-1]["it5.edges"] == len(d.edges)


@pytest.mark.cuda
def test_card_stamps_and_spans_share_the_profilers_clock(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames = _frames(16, SIZE, 8)
    d = _card_session(cuda_device, frames[:12])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(12, 16):
            img, intr = frames[t]
            d.track(t, img, intrinsics=intr)
        d.sync()
    events = list(prof.profiler.kineto_results.events())
    kernels = sorted(e.start_ns() for e in events
                     if "trace_stamp_kernel" in e.name() or "trace_begin_kernel" in e.name())
    stamps = [r[n] for r in d.session.rows()[12:] for n in d.session.slots
              if n in r and n != "tstamp" and not n.endswith(COUNTS)]
    assert len(kernels) == len(stamps) > 0
    # the two clocks drift some ppm apart (3-25 over a traced stretch): a
    # line through the pairs leaves each kernel within a few us of its stamp
    x = np.asarray(stamps, np.int64) - stamps[0]
    y = np.asarray(kernels, np.int64) - kernels[0]
    residuals = y - np.polyval(np.polyfit(x.astype(np.float64), y.astype(np.float64), 1), x)
    q1, q3 = np.percentile(residuals, [25, 75])
    assert q3 - q1 <= 5_000  # ns
    ranges = {}
    for e in events:  # the host's ranges (kineto mirrors each on the device's timeline too)
        if e.device_type() == DeviceType.CPU and e.name() in ("droid.track", "track.upload", "track.replay"):
            ranges.setdefault(e.name(), []).append(e.start_ns())
    for name, starts in ranges.items():
        spans = [r.start_ns for r in d.session.spans if r.name == name and r.frame >= 12]
        assert len(spans) == len(starts) == 4
        assert max(abs(a - b) for a, b in zip(sorted(starts), spans)) < 1_000_000
