"""The tracking step's window Schur complement (``ops/ba.py::window_schur``,
``csrc/schur_window.cu``) and its count in the flight recorder.

* On the CPU: the static bound on the pairs (``schur_max_pairs``)
  against every split of the rows over the frames at small sizes; the
  CPU step (the plain version) bit for bit the dense step of the
  benchmark's frozen copy (``slam_bench/reference``), with its cells; the
  recorder's ``it{k}.cells`` columns (phase None), which the benchmark's
  phase split and clock fit pass over, and ``ops.ba_cells_per_update``,
  their mean; the CPU recorder's count of the occupied cells.
* On the card (``cuda``): the kernels against the plain version at a small
  window and at the worst-case occupancy, bitwise over repeats.
  This module imports no JAX, so that on the card's machine (which has
  none) these run as ``python -m pytest tests/test_torch_schur_window.py -m
  cuda --noconftest``.
"""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from droid_slam_tpu_torch.ops import ba, lie
from droid_slam_tpu_torch.ops import projective as pops
from droid_slam_tpu_torch.runtime import DroidConfig
from droid_slam_tpu_torch.runtime import fused as fused_step
from droid_slam_tpu_torch.utils import profiling
from slam_bench import harness, recorder
from slam_bench.tests import test_slam_bench_trace_readers as readers

SHAPE = dict(N=144, Pw=64, Ka=72, hw=6 * 8)  # the tracking window at 6x8 features


def _case(kind, dtype, seed=0, **shape):
    return chip_smoke.schur_window_case(torch, kind, dtype, torch.device("cpu"), seed, **{**SHAPE, **shape})


def test_max_pairs_is_the_largest_split():
    for rows, window, kwin in itertools.product(range(9), range(1, 5), range(1, 4)):
        best = max(sum(n * (n + 1) // 2 for n in split)
                   for split in itertools.product(range(window + 1), repeat=kwin) if sum(split) <= rows)
        assert ba.schur_max_pairs(rows, window, kwin) == best, (rows, window, kwin)


def _window(seed, with_sens, F=8, h=6, w=8):
    """A seeded dense-window BA problem (tests/test_torch_ba.py's, drawn
    without JAX)."""
    r = np.random.default_rng(seed)
    xi = np.concatenate([0.05 * r.standard_normal((F, 3)), 0.02 * r.standard_normal((F, 3))], -1)
    poses = lie.exp(torch.tensor(xi, dtype=torch.float32))
    disps = torch.tensor(0.5 + r.random((F, h, w)), dtype=torch.float32)
    intr = torch.tensor([w * 0.9, w * 0.9, w / 2, h / 2], dtype=torch.float32)
    ii = torch.tensor([1, 2, 2, 3, 3, 4, 5, 6, 4, 6, 0, 7, 3])
    jj = torch.tensor([2, 1, 3, 2, 4, 3, 4, 5, 6, 4, 1, 6, 3])  # the last a stereo self edge
    coords, _ = pops.projective_transform(poses, disps, intr.expand(F, 4), ii, jj)
    target = coords + torch.tensor(0.5 * r.standard_normal(coords.shape), dtype=torch.float32)
    sens = torch.zeros(F, h, w)
    if with_sens:
        sens[2:5] = torch.tensor(0.5 + r.random((3, h, w)), dtype=torch.float32)
        sens[3, :2] = 0.0
    return dict(poses=poses, disps=disps, intrinsics=intr, disps_sens=sens, target=target,
                weight=torch.tensor(r.random(coords.shape), dtype=torch.float32),
                eta=torch.tensor(1e-3 + 1e-2 * r.random((F, h, w)), dtype=torch.float32), ii=ii, jj=jj,
                edge_valid=torch.tensor([1] * 11 + [0, 1], dtype=torch.bool))


@pytest.mark.parametrize("with_sens", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_step_is_the_dense_step_bit_for_bit(with_sens, dtype):
    """On the CPU ba_iteration_dense_window runs the plain dense version:
    its step equals, bit for bit, the benchmark's frozen copy of the dense
    step (slam_bench/reference), and its cells are the occupied ones."""
    from slam_bench.reference.ops import ba as frozen

    win = _window(21, with_sens)
    bounds = dict(t0=torch.tensor(1), t1=torch.tensor(7), kf0=torch.tensor(0), window=8, kwin=10)
    want = frozen.ba_iteration_dense_window(**win, **bounds, schur_dtype=dtype)
    got_p, got_d, cells = ba.ba_iteration_dense_window(**win, **bounds, schur_dtype=dtype)
    assert (got_p - win["poses"]).abs().max() > 1e-3  # the step moves things
    assert torch.equal(got_p, want[0]) and torch.equal(got_d, want[1])
    want_cells = torch.zeros(10, 8, dtype=torch.bool)
    for i, j in zip(win["ii"][win["edge_valid"]].tolist(), win["jj"][win["edge_valid"]].tolist()):
        for p in (i - 1, j - 1):
            if 0 <= p < 6:
                want_cells[i, p] = True
    assert torch.equal(cells, want_cells)


# ---------------------------------------------------------------------------
# the count in the flight recorder and its reader
# ---------------------------------------------------------------------------


def test_cells_columns_have_no_phase():
    config = DroidConfig(image_size=(48, 64))
    slots, phases = fused_step.trace_slots(config), fused_step.trace_phases(config)
    iters = config.frontend_iters1 + config.frontend_iters2
    cells = [f"it{k}.cells" for k in range(iters)]
    assert all(name in slots and name not in phases for name in cells)
    assert [slots[f"it{k}.cells"] - slots[f"it{k}.edges"] for k in range(iters)] == [1] * iters
    assert list(phases) == [n for n in slots if n not in ["tstamp", "step.start"] + cells]


CELLS = [61, 66, 70, 75, 83, 84]  # occupied cells of each update iteration's first GN step


def _session(base):
    """The benchmark readers' synthetic session (``slam_bench/tests``) with
    each replay's ``it{k}.cells`` written (its start at ``base``, so no
    other test's session overlaps its stretch)."""
    s, lo, hi = readers._session(base=base)
    for r in range(s.ring.shape[0]):
        if s.ring[r, s.slots["it0.gn"]] != profiling.EMPTY:
            for k, n in enumerate(CELLS):
                s.ring[r, s.slots[f"it{k}.cells"]] = n
    return s, lo, hi


def test_recorder_passes_over_the_cells_columns():
    """The benchmark's phase split leaves the counts out of every phase,
    and its clock fit pairs only the time columns with stamp kernels."""
    s, lo, hi = _session(2 * 10**12)
    _, rows = recorder.replay_rows(readers._trace(lo, hi))
    assert rows and all(r[f"it{k}.cells"] == CELLS[k] for r in rows for k in range(6))
    for r in rows:
        p = recorder.phases(s, r)
        assert sum(sum(v) for k, v in p.items() if k not in ("step", "edges")) == p["step"][0] == readers.STEP
        assert p["edges"] == readers.EDGES
    stretch = [r for r in s.rows() if readers.STRETCH[0] <= r["tstamp"] < readers.STRETCH[1]]
    times = sorted(v for r in stretch for n, v in r.items() if n != "tstamp" and not n.endswith((".edges", ".cells")))
    records = [("void trace_stamp_kernel(long long*)", v + readers.OFFSET, v + readers.OFFSET + 1) for v in times]
    a, b, t0 = recorder.clock_fit(readers._trace(lo, hi, records), s)
    assert a == pytest.approx(1.0) and b == pytest.approx(t0 + readers.OFFSET)


def test_cells_reader_gives_the_mean_and_nothing_without_the_columns():
    s, lo, hi = _session(3 * 10**12)
    read = harness.load_module("metrics", "ops.ba_cells_per_update").read
    assert read(readers._trace(lo, hi)) == pytest.approx(np.mean(CELLS))
    for k in range(6):  # a program that writes no cells column (the columns stay empty)
        s.ring[:, s.slots[f"it{k}.cells"]] = profiling.EMPTY
    assert read(readers._trace(lo, hi)) is None


def test_cpu_recorder_counts_the_occupied_cells():
    c = _case("allkf", "bfloat16", seed=7)
    cells = chip_smoke.schur_window_run(ba, c)["cells"]
    t0, kf0 = int(c["t0"]), int(c["kf0"])
    live = min(SHAPE["Pw"], int(c["t1"]) - t0)
    want = {(int(i) - kf0, int(p) - t0) for i, j, ok in zip(c["ii"], c["jj"], c["edge_valid"]) if ok
            for p in (i, j) if 0 <= int(i) - kf0 < SHAPE["Ka"] and 0 <= int(p) - t0 < live}
    ring = profiling.new_ring(4, "cpu")
    profiling.ring_begin(ring["trace_ring"], ring["trace_row"], torch.tensor(1.0))
    profiling.count(ring["trace_ring"], ring["trace_row"], 3, cells)
    assert int(ring["trace_ring"][0, 3]) == int(cells.sum()) == len(want) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The CUDA device a ``cuda`` test runs on; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype", [("allkf", "bfloat16"), ("allkf", "float32"), ("stereo", "bfloat16"),
                                        ("worst", "bfloat16"), ("worst", "float32")])
def test_card_kernels_match_the_plain_version_bitwise_over_repeats(cuda_device, kind, dtype):
    c = chip_smoke.schur_window_case(torch, kind, dtype, cuda_device, 11, N=96, Pw=64, Ka=72, hw=12 * 16)
    runs = [chip_smoke.schur_window_run(ba, c) for _ in range(3)]
    want = chip_smoke.schur_window_run(ba, c, ba.window_schur_ref)
    torch.cuda.synchronize()
    got = runs[0]
    assert torch.equal(got["cells"], want["cells"])
    for name in ("Ad", "rhs", "dz"):
        ref = want[name]
        assert float((got[name] - ref).abs().max()) <= chip_smoke.KERNEL_TOL * float(ref.abs().max()), name
    assert all(torch.equal(r[k], got[k]) for r in runs[1:] for k in got)
