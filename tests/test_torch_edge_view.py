"""The fused step's view of the edge store (``runtime/fused.py``): the
update branch's iterations run over ``_update_rows(config)`` rows that hold
every valid edge, while the store keeps the init's size.

* ``_update_rows`` equals, for every preset in mono and stereo, a brute
  force over every count the update's ``_add_edges(evict=True,
  budget=max_factors)`` can meet: the valid edges before it, the base
  edges in range, the greedy picks the budget admits and how many of them
  survive the dedup.
* ``_add_edges`` driven with the update's own candidates over adversarial
  states (a store full of valid edges of mixed ages, an empty store, every
  candidate passing the distance test, candidates that repeat live or
  inactive edges), several frames in a row, never leaves more valid edges
  than the view's rows, and ``_edge_view`` then holds every valid slot in
  ascending slot order.
* On the card (``cuda``): a captured stereo session at the EuRoC cell's
  tiny size, whose update iterations' lookups run over the view's rows
  and whose every replay counts (``it{k}.edges``) the valid edges a host
  count finds in the store after the frame.
  This module imports no JAX, so that on the card's machine (which has
  none) it runs as ``python -m pytest tests/test_torch_edge_view.py -m
  cuda --noconftest``.
"""

import dataclasses
import gc

import pytest
import torch

from droid_slam_tpu_torch.runtime import fused as fused_step
from droid_slam_tpu_torch.runtime.config import PRESETS

PRESET_CASES = [(name, stereo) for name in PRESETS for stereo in (False, True)]


def _worst_count(config) -> int:
    """The most valid edges the update's ``_add_edges`` can leave, by brute
    force over its counts."""
    slots = fused_step._edge_slots(config)
    cap = config.max_factors
    base = fused_step._UPDATE_SOURCES * (2 * (config.frontend_radius + 1) + int(config.stereo))
    worst = 0
    for in_range in range(base + 1):  # base edges whose keyframes exist
        passed = in_range
        for _ in range(fused_step._n_greedy(cap)):  # every pick passes the distance test
            if passed <= cap:  # the budget gate
                passed += 2
        for m in range(passed + 1):  # of them, m are neither live, inactive nor repeated
            for n0 in range(slots + 1):  # valid edges before the add
                evicted = min(max(n0 + m - cap, 0), n0)
                n1 = n0 - evicted
                worst = max(worst, n1 + min(m, slots - n1))
    return worst


@pytest.mark.parametrize("name, stereo", PRESET_CASES)
def test_update_rows_is_the_worst_count_of_every_preset(name, stereo):
    config = dataclasses.replace(PRESETS[name], stereo=stereo)
    assert fused_step._update_rows(config) == _worst_count(config)


def test_update_rows_of_the_benchmark_cells():
    """50 rows in both cells, in a store of 64 (TUM) or 96 (EuRoC stereo)."""
    tum, euroc = PRESETS["tum"], dataclasses.replace(PRESETS["euroc"], stereo=True)
    assert [fused_step._update_rows(c) for c in (tum, euroc)] == [50, 50]
    assert [fused_step._edge_slots(c) for c in (tum, euroc)] == [64, 96]


FRAME = 40  # the newest keyframe's count in the adversarial states


def _state(config, gen):
    """A small state of ``config``'s graph sizes with FRAME keyframes,
    poses a little apart (every proximity candidate within the distance
    threshold) and the rest empty."""
    cfg = dataclasses.replace(config, image_size=(16, 16), buffer=64)
    st = fused_step.init_state(cfg, "cpu")
    st.poses[:, :3] = 0.01 * torch.randn(64, 3, generator=gen)
    st.intrinsics[:] = torch.tensor([2.0, 2.0, 1.0, 1.0])
    st.counter.fill_(FRAME)
    return cfg, st


def _fill(st, n, gen, start=0):
    """Make slots [start, start + n) valid edges between old keyframes,
    each (i, j) distinct, of mixed ages (none new)."""
    pairs = [(i, j) for i in range(20) for j in range(20) if i != j][start:start + n]
    idx = torch.arange(start, start + len(pairs))
    st.ii[idx] = torch.tensor([p[0] for p in pairs])
    st.jj[idx] = torch.tensor([p[1] for p in pairs])
    st.age[idx] = torch.randint(1, 30, (len(pairs),), generator=gen)
    st.valid[idx] = True


def _adversary(kind, config, gen):
    cfg, st = _state(config, gen)
    slots = st.ii.shape[0]
    if kind == "full":
        _fill(st, slots, gen)
    elif kind == "over_budget":  # as the init leaves it: more than max_factors, some slots free
        _fill(st, min(slots - 4, cfg.max_factors + 8), gen)
    elif kind == "every_candidate_passes":  # a full store, and no distance test
        _fill(st, slots, gen)
        cfg = dataclasses.replace(cfg, frontend_thresh=1e9)
    elif kind == "duplicates":  # half the candidates live, the other half inactive
        ci, cj, cok = fused_step._update_candidates(st, cfg, st.counter)
        live = [(int(i), int(j)) for i, j, ok in zip(ci, cj, cok) if ok]
        half = min(len(live) // 2, slots)
        for s, (i, j) in enumerate(live[:half]):
            st.ii[s], st.jj[s], st.valid[s] = i, j, True
        rest = live[half:][: st.inac_ii.shape[0]]
        for s, (i, j) in enumerate(rest):
            st.inac_ii[s], st.inac_jj[s], st.inac_valid[s] = i, j, True
        st.inac_next.fill_(len(rest))
    else:
        assert kind == "empty"
    return cfg, st


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("kind", ["full", "over_budget", "empty", "every_candidate_passes", "duplicates"])
def test_add_edges_never_leaves_more_than_the_view(kind, stereo):
    gen = torch.Generator().manual_seed(5)
    for name in PRESETS:
        config = dataclasses.replace(PRESETS[name], stereo=stereo)
        cfg, st = _adversary(kind, config, gen)
        V = fused_step._update_rows(cfg)
        added = 0
        for frame in range(3):  # the update's upkeep, three keyframes in a row
            fused_step._rm_factors(st, st.valid & (st.age > cfg.max_age), store=True)
            fused_step._add_edges(st, *fused_step._update_candidates(st, cfg, st.counter), evict=True,
                                  budget=cfg.max_factors)
            n = int(st.valid.sum())
            assert n <= V, (name, kind, frame, n, V)
            valid_slots = torch.nonzero(st.valid)[:, 0]
            view = fused_step._edge_view(st.valid, V)
            assert view.shape == (V,)
            assert torch.equal(view[:n], valid_slots)  # every valid slot, ascending
            assert not st.valid[view[n:]].any()
            added += int((st.valid & (st.age == 0)).sum())
            st.age += st.valid.long()
            st.counter += 1
        assert added > 0, (name, kind)  # the candidates did reach the store


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
def test_card_replays_count_every_valid_edge_over_the_view(cuda_device, monkeypatch):
    from droid_slam_tpu_torch.ops import corr as corr_ops
    from droid_slam_tpu_torch.runtime import Droid, DroidConfig
    from slam_bench import harness
    from slam_bench.tests.conftest import tiny

    frames = 24
    cell = tiny("euroc-stereo-track-allkf", frames=frames)
    fields = cell.droid_fields()
    gen = harness.load_module("generators", cell.workload["generator"])
    inputs = gen.generate(2**31 + 11, image_size=fields["image_size"], **cell.workload["generator_args"])
    config = DroidConfig(**fields)
    V, slots = fused_step._update_rows(config), fused_step._edge_slots(config)
    assert config.stereo and V < slots

    lookups = []  # (frame, edges) of every lookup the step's Python makes
    real = corr_ops.corr_lookup

    def spy(fmap1, fmap2, coords, *args, **kwargs):
        lookups.append((frame, fmap1.shape[0]))
        return real(fmap1, fmap2, coords, *args, **kwargs)

    monkeypatch.setattr(corr_ops, "corr_lookup", spy)
    gc.collect()  # no earlier test's graph may be collected during this one's capture
    d = Droid(config, device=cuda_device, weights=str(cell.weights_path()))
    counted = 0
    for frame in range(frames):
        d.track(frame, inputs["images"][frame], intrinsics=inputs["intrinsics"][frame])
        d.sync()
        row = d.session.rows()[-1]
        its = [n for n in row if n.endswith(".edges")]
        if frame >= config.warmup:  # a replay of the captured step
            assert its and all(row[n] == len(d.edges) for n in its), (frame, len(d.edges))
            counted += 1
    assert d.graph is not None and d.graph.replays == counted == frames - config.warmup
    init, update = config.warmup - 1, config.warmup
    assert {n for f, n in lookups if f == init} == {1, slots}  # the probe; the init over the whole store
    assert {n for f, n in lookups if f == update} == {1, V}  # the capture: the probe; the view
    assert not [f for f, _ in lookups if f > update]  # every later frame a replay
