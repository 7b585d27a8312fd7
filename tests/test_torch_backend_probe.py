"""Port parity for the backend probe (``droid_slam_tpu_torch/tools/backend_probe.py``).

The JAX probe is ``bench.py::backend_scale_probe``: a synthetic t-keyframe
map with ~16·t edges and one ``update_lowmem`` step. Its construction is
copied here with the JAX package's modules (bench.py times and returns
only the counts, not the state) at t = 12 and 64×96, in f32, and the port's
``build_probe`` gets the same weights through ``params_from_jax``. Gates:
the same draws and edge list (slot by slot), the same graph sizes, and
after ``update_lowmem(steps=1)`` poses and disparities within 1e-3 of the
JAX ``FactorGraph``'s (tests/test_torch_terminate.py's bound).

The multi-process backend (``tools/mp_backend.py``): two gloo ranks on the
CPU at the tool's defaults, each passing the tool's own bounds (the
distributed backend's poses and disparities within 5e-3 of the
single-device oracle's, the keyframe ATE within 1e-3); two ranks on one
GPU are refused, with the reason.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.models.droid_net import init_params as jinit_params
from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.runtime.backend import _pow2ceil as jpow2ceil
from droid_slam_tpu.runtime.config import DroidConfig as JDroidConfig
from droid_slam_tpu.runtime.factor_graph import FactorGraph as JFactorGraph
from droid_slam_tpu.runtime.video import VideoState as JVideoState
from droid_slam_tpu_torch.models.weights import params_from_jax
from droid_slam_tpu_torch.tools import backend_probe, mp_backend

torch.set_num_threads(2)

T = 12
SIZE = (64, 96)


def _jax_probe(t, image_size, compute_dtype):
    """bench.py:31-99's construction (before its timing), with the compute
    dtype named."""
    cfg = JDroidConfig(image_size=image_size, buffer=t + 8, window_pad=64, compute_dtype=compute_dtype)
    h, w = cfg.feat_size
    params = jinit_params(jax.random.PRNGKey(1))
    upd = {"params": params["params"]["update"]}

    rng = np.random.default_rng(5)
    v = JVideoState(cfg)
    v.counter = t
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (cfg.buffer, 1))
    tw = np.zeros((cfg.buffer, 6), np.float32)
    tw[:t] = np.cumsum(0.01 * rng.standard_normal((t, 6)), axis=0).astype(np.float32)
    v.poses = jlie.retr(jnp.asarray(poses), jnp.asarray(tw))
    v.disps = jnp.asarray((0.5 + rng.random((cfg.buffer, h, w))).astype(np.float32))
    v.intrinsics = jnp.asarray(
        np.broadcast_to(
            np.array([image_size[1] / 8, image_size[1] / 8, w / 2, h / 2], np.float32),
            (cfg.buffer, 4),
        ).copy()
    )
    v.fmaps = jnp.asarray(rng.standard_normal((cfg.buffer, 1, h, w, 128)).astype(np.float32))
    v.nets = jnp.asarray(np.tanh(rng.standard_normal((cfg.buffer, h, w, 128))).astype(np.float32))
    v.inps = jnp.asarray(rng.standard_normal((cfg.buffer, h, w, 128)).astype(np.float32))

    graph = JFactorGraph(v, upd, max_factors=jpow2ceil(16 * t), edge_pad=jpow2ceil(16 * t), inactive_pad=16)
    ii, jj = [], []
    for i in range(t):
        for d in (1, 2):
            if i - d >= 0:
                ii.extend([i, i - d])
                jj.extend([i - d, i])
    n_rand = 8 * t - len(ii) // 2
    a = rng.integers(0, t, 2 * n_rand)
    b = rng.integers(0, t, 2 * n_rand)
    keep = np.abs(a - b) > 2
    ii.extend(a[keep][:n_rand])
    jj.extend(b[keep][:n_rand])
    ii.extend(b[keep][:n_rand])
    jj.extend(a[keep][:n_rand])
    graph.add_factors(np.asarray(ii, np.int32), np.asarray(jj, np.int32))
    return graph, v, params, np.asarray(ii, np.int32), np.asarray(jj, np.int32)


@functools.lru_cache(maxsize=None)
def _run():
    jgraph, jv, params, ii, jj = _jax_probe(T, SIZE, "float32")
    want = dict(ii=ii, jj=jj, slots=(jgraph.ii.copy(), jgraph.jj.copy(), jgraph.valid.copy()),
                edge_pad=jgraph.edge_pad, max_factors=jgraph.max_factors, edges=jgraph.num_active,
                disps0=np.asarray(jv.disps), poses0=np.asarray(jv.poses))
    jgraph.update_lowmem(steps=1)
    want["poses"], want["disps"] = np.asarray(jv.poses[:T]), np.asarray(jv.disps[:T])

    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        graph, v = backend_probe.build_probe(T, SIZE, "cpu", tparams, "float32")
        got = dict(slots=(graph.ii.copy(), graph.jj.copy(), graph.valid.copy()), edge_pad=graph.edge_pad,
                   max_factors=graph.max_factors, edges=graph.num_active, disps0=v.disps.numpy().copy(),
                   poses0=v.poses.numpy().copy())
        got["chunks"] = graph.update_lowmem(steps=1)
    got["poses"], got["disps"] = v.poses[:T].numpy(), v.disps[:T].numpy()
    return want, got


def test_probe_draws_the_jax_edge_list():
    want, _ = _run()
    x = backend_probe.probe_arrays(T, T + 8, SIZE[0] // 8, SIZE[1] // 8)
    assert np.array_equal(x.ii, want["ii"]) and np.array_equal(x.jj, want["jj"])
    assert backend_probe.unique_edges(x) == want["edges"]


def test_probe_graph_is_the_jax_graph():
    want, got = _run()
    assert got["edge_pad"] == got["max_factors"] == want["edge_pad"] == want["max_factors"] == 256
    assert got["edges"] == want["edges"]
    for a, b in zip(got["slots"], want["slots"]):
        assert np.array_equal(a, b)
    assert np.array_equal(got["disps0"], want["disps0"])
    assert np.abs(got["poses0"] - want["poses0"]).max() < 1e-6


def test_probe_step_matches_jax():
    want, got = _run()
    assert got["chunks"] == 1
    assert np.isfinite(got["poses"]).all() and np.isfinite(got["disps"]).all()
    assert np.abs(got["poses"] - want["poses"]).max() < 1e-3
    assert np.abs(got["disps"] - want["disps"]).max() < 1e-3
    # the step moved the map: the comparison is not of two untouched states
    assert np.abs(got["poses"] - got["poses0"][:T]).max() > 1e-4


@pytest.mark.parametrize("n,want", [(1, 64), (64, 64), (65, 128), (3200, 4096), (4096, 4096)])
def test_pow2ceil_is_the_jax_backends(n, want):
    assert backend_probe._pow2ceil(n) == jpow2ceil(n) == want


def test_backend_scale_probe_row():
    """The probe's row on the CPU at the default bf16: the JAX probe's keys
    and the port's readings."""
    row = backend_probe.backend_scale_probe(T, SIZE, device="cpu")
    assert {"backend_step_s", "backend_keyframes", "backend_edges"} <= set(row)
    x = backend_probe.probe_arrays(T, T + 8, SIZE[0] // 8, SIZE[1] // 8)
    assert row["backend_keyframes"] == T and row["backend_edges"] == backend_probe.unique_edges(x)
    assert row["backend_chunks"] == 1 and row["steps"] == 2 and row["backend_step_s"] > 0
    assert row["launches"] == {} and row["peak_allocated_gb"] is None  # plain versions on the CPU


def test_mp_backend_two_gloo_ranks(monkeypatch, capfd):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    code = mp_backend.main(["--num_processes", "2", "--device", "cpu"])
    out, err = capfd.readouterr()
    assert code == 0, out[-3000:] + err[-3000:]
    for rank in range(2):
        assert f"[rank {rank}] MP_BACKEND_RUN_OK" in out, out[-3000:] + err[-3000:]
        assert f"[rank {rank}] 2-process distributed backend: ATE" in out
    assert "MP_BACKEND_DONE" in out


@pytest.mark.parametrize("cards", [0, 1])
def test_mp_backend_refuses_ranks_beyond_the_cards(monkeypatch, capsys, cards):
    """NCCL puts no two ranks on one GPU: two ranks need two cards, and the
    launcher says so instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mp_backend.main(["--num_processes", "2"]) == 1
    err = capsys.readouterr().err
    assert "--device cpu" in err
    if cards:
        assert "NCCL puts no two ranks on one GPU" in err and "machine has 1" in err
    else:
        assert "no CUDA device" in err
