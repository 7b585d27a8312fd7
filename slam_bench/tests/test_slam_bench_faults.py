"""The check catches a broken timed path: the rest of a run (set-up, the
window, the check against the reference), on the CPU at a tiny size, with
the program broken underneath, must come out not correct. The program
runs in float32 here, where on the CPU it is the reference bit for bit, so
the sound run reads 0 in every number compared with the reference and any
fault reads above the cell's limits. Each cell has one chip, so the fault
of an exchange between chips cannot occur."""

import time

import pytest
import torch

from slam_bench import run
from slam_bench.tests.conftest import tiny


def _measure(torch_cpu, cell):
    return run.measure(cell, 2**31 + 7, 0.3, False, torch_cpu, torch.device("cpu"), t0=time.perf_counter())


def _init_unchanged(mp, Droid):
    real = Droid.track

    def track(self, tstamp, image, depth=None, intrinsics=None):
        # the step that initialises the map leaves its poses and disparities as they were
        st = self._state
        before = None if bool(st.is_init) else (st.poses.clone(), st.disps.clone())
        real(self, tstamp, image, depth, intrinsics)
        if before is not None and bool(st.is_init):
            st.poses.copy_(before[0])
            st.disps.copy_(before[1])

    mp.setattr(Droid, "track", track)


def _unchanged(mp, Droid):
    mp.setattr(Droid, "track", lambda self, tstamp, image, depth=None, intrinsics=None: None)


def _half(mp, Droid):
    real = Droid.track

    def track(self, tstamp, image, depth=None, intrinsics=None):
        if int(tstamp) % 2 == 0:
            real(self, tstamp, image, depth, intrinsics)

    mp.setattr(Droid, "track", track)


def _altered(mp, Droid):
    real = Droid.track

    def track(self, tstamp, image, depth=None, intrinsics=None):
        real(self, tstamp, image, depth, intrinsics)
        # every frame's newest pose moved where the step writes it
        n = int(self._state.counter)
        if n > 0:
            self._state.poses[n - 1, :3] += 0.05

    mp.setattr(Droid, "track", track)


@pytest.mark.parametrize("fault", [_unchanged, _init_unchanged, _half, _altered])
def test_tracking_fault_is_not_correct(torch_cpu, monkeypatch, fault):
    from droid_slam_tpu_torch.runtime import droid

    cell = tiny("tum-track-allkf", frames=16)
    cell.workload["driver_args"]["check_steps"] = 3
    cell.config["droid_config"]["compute_dtype"] = "float32"
    sound = _measure(torch_cpu, cell)
    assert sound["correct"] and all(row["value"] == 0 for row in sound["check"].values()), sound["check"]
    fault(monkeypatch, droid.Droid)
    res = _measure(torch_cpu, cell)
    assert res["correct"] is False, res["check"]


def test_a_later_session_that_differs_is_not_correct(torch_cpu, monkeypatch):
    # from the window's second session on, every Droid moves the newest pose
    # where the step writes it: the first session and its replay agree
    from droid_slam_tpu_torch.runtime import droid

    cell = tiny("tum-track-allkf", frames=12)
    cell.workload["driver_args"]["check_steps"] = 2
    cell.config["droid_config"]["compute_dtype"] = "float32"
    # a window of about three sessions, from the time one session takes here
    ctx = run.make_context(cell, 2**31 + 7, torch_cpu, torch.device("cpu"))
    t0 = time.perf_counter()
    d = ctx.port.Droid(ctx.droid_config, params=ctx.params, device=ctx.device)
    for k in range(12):
        d.track(k, ctx.inputs["images"][k], intrinsics=ctx.inputs["intrinsics"][k])
    seconds = 2.8 * (time.perf_counter() - t0)
    del d, ctx
    made = []
    real_init, real_track = droid.Droid.__init__, droid.Droid.track

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        made.append(self)

    def track(self, tstamp, image, depth=None, intrinsics=None):
        real_track(self, tstamp, image, depth, intrinsics)
        if self in made[2:3]:  # set-up's Droid, the first session's, then this one
            n = int(self._state.counter)
            self._state.poses[n - 1, :3] += 0.05

    monkeypatch.setattr(droid.Droid, "__init__", init)
    monkeypatch.setattr(droid.Droid, "track", track)
    res = run.measure(cell, 2**31 + 7, seconds, False, torch_cpu, torch.device("cpu"), t0=time.perf_counter())
    assert res["check"]["replay_gap"]["value"] == 0, res["check"]
    assert res["check"]["session_gap"]["value"] > 0 and res["correct"] is False, res["check"]
