"""The fused step's control on the device: no host read outside ``cond``.

* The steady-state step (every frame after the one that runs init) reads
  the device only where :func:`droid_slam_tpu_torch.runtime.graph.cond`
  reads a branch's predicate: at most 3 reads per frame (keyframe, update,
  cull). During those frames every other way of reading a tensor on the
  host raises (``item``, ``bool``, ``float``, ``int``, ``__index__``,
  ``tolist``, ``cpu``, ``numpy``, ``nonzero``, and indexing with a 0-dim
  integer tensor or a boolean mask), and the state's buffers keep their
  storage (a captured step replays against the storage it was captured
  with). Run on the trained replay of tests/test_torch_trained.py (the
  probe skips frames and the test culls keyframes) and on an RGB-D and a
  stereo sequence at the sizes of tests/test_torch_stereo.py (every frame
  a keyframe, kept): between them both sides of every branch run.
* The update iterations over the edge store's view: the benchmark's tiny
  mono and stereo cells replayed under the same guard, where the store
  (64 or 96 slots) is wider than the view (50 rows): on every update
  iteration the operator's input has the view's rows, and the view's
  valid edges are the store's; the init runs over the whole store.
* ``cond``'s eager semantics on a toy state: one branch, written in place;
  in warm-up both branches; the predicate read once.

On the CPU the step is always eager; the captured graph runs on the card
(``chip_smoke.py`` phase 5b holds it bit for bit against ``capture=False``).
"""

import collections
import sys
import types

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.data import synthetic
from droid_slam_tpu_torch.models.droid_net import init_params
from droid_slam_tpu_torch.models.update import UpdateModule
from droid_slam_tpu_torch.runtime import Droid, DroidConfig
from droid_slam_tpu_torch.runtime import fused as fused_step
from droid_slam_tpu_torch.runtime import graph
from test_torch_stereo import CONFIG as STEREO_CONFIG
from test_torch_stereo import INTR as STEREO_INTR
from test_torch_trained import CONFIG as TRAINED_CONFIG
from test_torch_trained import FIXTURE, N_FRAMES
from slam_bench import harness
from slam_bench.tests.conftest import tiny

torch.set_num_threads(2)

MAX_READS_PER_FRAME = 3
READS = ("item", "tolist", "cpu", "numpy", "nonzero", "__float__", "__int__", "__index__")


class HostReadGuard:
    """While active, a host read of a tensor raises unless it is ``cond``
    reading its predicate; those reads are counted."""

    def __init__(self, monkeypatch):
        self.active = False
        self.cond_reads = 0
        orig_bool = torch.Tensor.__bool__

        def forbid(name, orig):
            def patched(*args, **kwargs):
                if self.active:
                    raise AssertionError(f"host read {name} in the steady-state step")
                return orig(*args, **kwargs)
            return patched

        def guarded_bool(t):
            if self.active:
                if sys._getframe(1).f_code is not graph.cond.__code__:
                    raise AssertionError("host read __bool__ outside cond")
                self.cond_reads += 1
            return orig_bool(t)

        def index_check(name, orig):
            def patched(t, index, *rest):
                if self.active:
                    for i in index if isinstance(index, tuple) else (index,):
                        if torch.is_tensor(i) and (i.dtype == torch.bool or i.dim() == 0):
                            raise AssertionError(f"{name} with a {i.dtype} {tuple(i.shape)} index reads the device")
                return orig(t, index, *rest)
            return patched

        for name in READS:
            monkeypatch.setattr(torch.Tensor, name, forbid(name, getattr(torch.Tensor, name)))
        monkeypatch.setattr(torch, "nonzero", forbid("torch.nonzero", torch.nonzero))
        monkeypatch.setattr(torch.Tensor, "__bool__", guarded_bool)
        for name in ("__getitem__", "__setitem__"):
            monkeypatch.setattr(torch.Tensor, name, index_check(name, getattr(torch.Tensor, name)))


def _record_branches(monkeypatch):
    """Count, by branch, the sides of fused's conds that ran."""
    taken = collections.Counter()
    real = graph.cond

    def recording(pred, true_fn, false_fn, operand):
        name = true_fn.__name__

        def on_true(s):
            taken[(name, True)] += 1
            true_fn(s)

        def on_false(s):
            taken[(name, False)] += 1
            if false_fn is not None:
                false_fn(s)

        real(pred, on_true, on_false, operand)

    monkeypatch.setattr(fused_step, "cond", recording)
    return taken


def _trained_frames():
    seq = synthetic.render_sequence(np.random.default_rng(11), n_frames=N_FRAMES, image_size=(64, 96),
                                    t_sigma=0.25, r_sigma=0.02)
    return ([(seq["images"][t], None, seq["intrinsics"][t]) for t in range(N_FRAMES)],
            dict(weights=FIXTURE), TRAINED_CONFIG)


def _rgbd_frames():
    seq = synthetic.render_sequence(np.random.default_rng(7), n_frames=8, image_size=(64, 64))
    cfg = {k: v for k, v in STEREO_CONFIG.items() if k != "stereo"}
    return ([(seq["images"][t], seq["depths"][t], seq["intrinsics"][t]) for t in range(8)],
            dict(params=init_params(0)), cfg)


def _stereo_frames():
    rng = np.random.default_rng(4321)
    return ([(rng.integers(0, 255, (2, 64, 64, 3), np.uint8), None, STEREO_INTR) for _ in range(6)],
            dict(params=init_params(0)), STEREO_CONFIG)


@pytest.mark.parametrize("sequence", ["trained", "rgbd", "stereo"])
def test_steady_state_reads_only_in_cond(monkeypatch, sequence):
    frames, weights, cfg = {"trained": _trained_frames, "rgbd": _rgbd_frames,
                            "stereo": _stereo_frames}[sequence]()
    droid = Droid(DroidConfig(**cfg), device="cpu", **weights)
    assert not droid.capture  # the CPU is always eager
    guard = HostReadGuard(monkeypatch)
    taken = _record_branches(monkeypatch)
    reads, storage, steady = [], None, 0
    with torch.backends.mkldnn.flags(enabled=False):
        for t, (img, depth, intr) in enumerate(frames):
            if not droid._initialized:
                droid.track(t, img, depth=depth, intrinsics=intr)
                continue
            if storage is None:
                storage = droid._state.storage()
                taken.clear()
            guard.cond_reads, guard.active = 0, True
            try:
                droid.track(t, img, depth=depth, intrinsics=intr)
            finally:
                guard.active = False
            reads.append(guard.cond_reads)
            assert droid._state.storage() == storage  # no buffer was rebound
            steady += 1
    assert steady >= 2 and droid.graph is None
    assert max(reads) <= MAX_READS_PER_FRAME, reads
    # between them the sequences run both sides of every branch
    if sequence == "trained":  # the probe skips frames, the test culls each new keyframe
        for branch in ("keyframe", "update_branch"):
            assert taken[(branch, True)] > 0 and taken[(branch, False)] > 0, (branch, dict(taken))
        assert taken[("cull", True)] > 0, dict(taken)
        assert max(reads) == MAX_READS_PER_FRAME and min(reads) < MAX_READS_PER_FRAME
    else:  # every frame a keyframe, kept
        assert min(reads) == max(reads) == MAX_READS_PER_FRAME
        assert taken[("cull", False)] == steady and not taken[("cull", True)]


@pytest.mark.parametrize("cell, frames", [("tum-track-allkf", 16), ("euroc-stereo-track-allkf", 19)])
def test_update_iterations_run_over_the_view(monkeypatch, cell, frames):
    cell = tiny(cell, frames=frames)
    fields = dict(cell.droid_fields(), compute_dtype="float32")  # the rows, not the precision, matter here
    gen = harness.load_module("generators", cell.workload["generator"])
    inputs = gen.generate(2**31 + 3, image_size=fields["image_size"], **cell.workload["generator_args"])
    config = DroidConfig(**fields)
    droid = Droid(config, device="cpu", weights=str(cell.weights_path()))
    V, slots = fused_step._update_rows(config), fused_step._edge_slots(config)
    assert V == 50 < slots

    calls = []  # per operator call over edges: its rows, the rows' valid edges, the store's
    real = UpdateModule.forward

    def spy(self, net, inp, corr, flow, ii=None, num_frames=None, edge_valid=None):
        if ii is not None:
            calls.append((net.shape[0], corr.shape[0], edge_valid.clone(), droid._state.valid.clone()))
        return real(self, net, inp, corr, flow, ii, num_frames, edge_valid)

    monkeypatch.setattr(UpdateModule, "forward", spy)
    guard = HostReadGuard(monkeypatch)
    iters = config.frontend_iters1 + config.frontend_iters2
    storage, steady = None, 0
    with torch.backends.mkldnn.flags(enabled=False):
        for t in range(frames):
            calls.clear()
            if not droid._initialized:
                droid.track(t, inputs["images"][t], intrinsics=inputs["intrinsics"][t])
                assert all(rows == slots for rows, *_ in calls)  # the init: the whole store
                continue
            storage = storage or droid._state.storage()
            guard.cond_reads, guard.active = 0, True
            try:
                droid.track(t, inputs["images"][t], intrinsics=inputs["intrinsics"][t])
            finally:
                guard.active = False
            assert guard.cond_reads <= MAX_READS_PER_FRAME
            assert droid._state.storage() == storage  # no buffer was rebound
            assert len(calls) == iters  # every frame a keyframe, kept
            for rows, corr_rows, view_valid, store_valid in calls:
                assert rows == corr_rows == V
                assert int(view_valid.sum()) == int(store_valid.sum()) > 0
            assert int(calls[-1][3].sum()) == len(droid.edges)
            steady += 1
    assert steady == frames - config.warmup >= 3


def _toy():
    return types.SimpleNamespace(x=torch.tensor([1.0, 2.0]), n=torch.zeros((), dtype=torch.int64))


def _double(s):
    s.x.mul_(2.0)
    s.n += 1


def _decrement(s):
    s.x.copy_(s.x - 1.0)


@pytest.mark.parametrize("pred, false_fn, want_x, want_n", [
    (True, _decrement, [2.0, 4.0], 1),
    (False, _decrement, [0.0, 1.0], 0),
    (False, None, [1.0, 2.0], 0),
])
def test_cond_eager_runs_one_branch_in_place(pred, false_fn, want_x, want_n):
    s = _toy()
    x, n = s.x, s.n
    graph.cond(torch.tensor(pred), _double, false_fn, s)
    assert s.x is x and s.n is n  # written into the same storage
    assert s.x.tolist() == want_x and int(s.n) == want_n


def test_cond_warm_up_runs_both_branches():
    s = _toy()
    with graph._warming():
        graph.cond(torch.tensor(False), _double, _decrement, s)
    assert s.x.tolist() == [1.0, 3.0] and int(s.n) == 1


def test_state_clone_and_assign_keep_storage():
    cfg = DroidConfig(**{k: v for k, v in STEREO_CONFIG.items() if k != "stereo"})
    st = fused_step.init_state(cfg, torch.device("cpu"))
    storage = st.storage()
    assert st.counter.dim() == st.t1.dim() == st.is_init.dim() == 0
    assert st.counter.dtype == st.t1.dtype == torch.int64 and st.is_init.dtype == torch.bool
    st.assign_("poses", st.poses + 1.0)
    st.assign_("counter", st.counter + 3)
    assert st.storage() == storage and int(st.counter) == 3
    twin = st.clone()
    assert all(twin.storage()[k] != p for k, p in storage.items())
    assert torch.equal(twin.poses, st.poses) and int(twin.counter) == 3
