"""Port parity for the edge-sharded global BA on torch.distributed (gloo on
the CPU): the shard plan, the sharded solve over 2 and 3 ranks and the
backend with a process group, against the JAX package's
``parallel/sharded_ba.py`` and its single-device BA.

* ``ShardedBAPlan.build`` must give each shard the JAX plan's edges,
  owners, first frame and pair list exactly (on the JAX plan's unpadded
  prefix), for D = 1, 2, 3 and a counter below the buffer.
* The sharded solve (2 and 3 ranks, 1 and 2 iterations, with and without a
  depth prior, the counter at and below the 16-frame buffer, a shard
  without edges) must agree with the JAX package's single-device
  ``ba_solve`` and with its ``sharded_ba_solve`` on a 1-device mesh within
  1e-4 (``tests/test_parallel.py``'s bound), and every rank must return
  the same bits.
* ``DroidBackend(mesh=)`` over 2 ranks on ``tests/test_torch_backend.py``'s
  tracked RGB-D state must agree with the JAX backend on a 1-device
  ``"ba"`` mesh within 5e-3 (poses, disparities; ``test_parallel.py``'s
  bound), its ranks bit for bit; with ``upsample=True`` its ``disps_up``,
  upsampled before each step's sharded solve as in the JAX package (so it
  lags the disparities by one solve), must agree with the JAX mesh
  backend's within the same bound; and it must agree with the port's
  single-device backend within 1e-4.

Ranks are child processes (``sys.executable -c``) that meet at a
``TCPStore`` the test process holds on 127.0.0.1 (bound to a port the
kernel picks, and held until every child has exited, so no other process
can take the port in between), with a 120 s group timeout, waited on for
at most 300 s and killed in a ``finally``; a failing child's exit code and
the end of its stderr go into the assertion message.
"""

import datetime
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from droid_slam_tpu.models.droid_net import init_params as jinit_params
from droid_slam_tpu.ops import ba as jba
from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.ops import projective as jpops
from droid_slam_tpu.parallel import sharded_ba as jsh
from droid_slam_tpu.runtime import Droid as JDroid
from droid_slam_tpu.runtime import DroidConfig as JDroidConfig
from droid_slam_tpu.runtime import backend as jbackend
from droid_slam_tpu.runtime.video import VideoState as JVideoState
from droid_slam_tpu_torch.models.droid_net import DroidNet
from droid_slam_tpu_torch.models.weights import params_from_jax
from droid_slam_tpu_torch.parallel.sharded_ba import ShardedBAPlan, edge_owners
from droid_slam_tpu_torch.runtime import DroidConfig
from droid_slam_tpu_torch.runtime import backend as tbackend
from droid_slam_tpu_torch.runtime.video import VideoState

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

# -----------------------------------------------------------------------------
# ranks as child processes
# -----------------------------------------------------------------------------

CHILD = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(2)
rank, world, port, job_path = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
job = json.loads(open(job_path).read())
timeout = datetime.timedelta(seconds=120)
store = dist.TCPStore("127.0.0.1", port, is_master=False, timeout=timeout)
dist.init_process_group("gloo", store=store, world_size=world, rank=rank, timeout=timeout)
group = dist.group.WORLD
out = {}
if job["kind"] == "solve":
    from droid_slam_tpu_torch.parallel.sharded_ba import ShardedBAPlan, sharded_ba_solve

    for name, case in job["cases"].items():
        x = {k: torch.from_numpy(v) for k, v in np.load(case["inputs"]).items()}
        plan = ShardedBAPlan.build(x["ii"].numpy(), x["jj"].numpy(), np.ones(len(x["ii"]), bool), world,
                                   case["counter"], case["t0"], case["t1"], shard=rank)
        p, d = sharded_ba_solve(group, plan, x["target"], x["weight"], x["eta"], x["poses"], x["disps"],
                                x["intr"], x["sens"], case["t0"], case["t1"], case["t1"] - case["t0"],
                                iterations=case["iterations"])
        out[name + "/poses"], out[name + "/disps"] = p.numpy(), d.numpy()
        out[name + "/n_local"] = np.array(len(plan.perm))
else:
    from droid_slam_tpu_torch.models.droid_net import DroidNet
    from droid_slam_tpu_torch.runtime import DroidConfig
    from droid_slam_tpu_torch.runtime.backend import DroidBackend
    from droid_slam_tpu_torch.runtime.video import VideoState

    state = dict(np.load(job["state"]))
    net = DroidNet()
    net.load_state_dict(torch.load(job["weights"], weights_only=True))
    for name, config in job["configs"].items():
        cfg = DroidConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in config.items()})
        v = VideoState(cfg, "cpu")
        v.counter = job["t"]
        for k, a in state.items():
            setattr(v, k, torch.from_numpy(a.copy()))
        with torch.backends.mkldnn.flags(enabled=False), torch.no_grad():
            runs = DroidBackend(net.update, v, cfg, mesh=group)(2)
        t = job["t"]
        out[name + "/poses"] = v.poses[:t].numpy()
        out[name + "/disps"] = v.disps[:t].numpy()
        out[name + "/disps_up"] = v.disps_up[:t].numpy()
        out[name + "/runs"] = np.array(runs)
np.savez(job["out"].format(rank=rank), **out)
# Drop the last reference to the group, so that destroy_process_group frees
# it and joins gloo's worker threads while the interpreter still runs. A
# worker that is still releasing a finished collective's tensors once the
# interpreter finalizes is ended as it waits for the GIL, and the rank
# aborts ("terminate called without an active exception").
del group
dist.destroy_process_group()
"""


def _store():
    """The rendezvous of the ranks: a TCPStore that this process serves on a
    port the kernel picks, for as long as the caller holds it."""
    return dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=120))


def _check_children(procs, results):
    """Every child exited 0; else each child's exit code and stderr tail."""
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join(f"rank {r}: exit {p.returncode}\n{out[-2000:]}{err[-4000:]}"
                                  for r, (p, (out, err)) in enumerate(zip(procs, results)))


def _run_ranks(world: int, job: dict, tmp: Path):
    """Run CHILD on ``world`` ranks; returns each rank's outputs."""
    job = dict(job, out=str(tmp / "rank{rank}.npz"))
    job_path = tmp / "job.json"
    job_path.write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    store = _store()
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(world), str(store.port), str(job_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for r in range(world)]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    del store
    _check_children(procs, results)
    return [dict(np.load(job["out"].format(rank=r))) for r in range(world)]


# -----------------------------------------------------------------------------
# the plan
# -----------------------------------------------------------------------------


def _plan_edges(counter, edge_max, seed=5, n=60):
    r = np.random.default_rng(seed)
    ii = r.integers(0, edge_max, n).astype(np.int32)
    jj = r.integers(0, counter, n).astype(np.int32)
    valid = r.random(n) < 0.8
    return ii, jj, valid


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("counter,edge_max,t0", [(13, 13, 1), (16, 16, 2), (13, 9, 1)])
def test_plan_matches_jax(D, counter, edge_max, t0):
    """The counter below the 16-frame buffer, at it, and with edges only
    among the first 9 frames (the last of 3 shards owns none)."""
    ii, jj, valid = _plan_edges(counter, edge_max)
    t1 = counter
    want = jsh.ShardedBAPlan.build(ii, jj, valid, D, counter, t0, t1, pad_floor=4)
    owners = edge_owners(ii, D, counter)
    n_edges = []
    for s in range(D):
        got = ShardedBAPlan.build(ii, jj, valid, D, counter, t0, t1, shard=s)
        assert got.frames_per_shard == want.frames_per_shard
        assert got.f0 == int(want.f0[s])
        n = int(want.valid[s].sum())
        assert not want.valid[s][n:].any()
        np.testing.assert_array_equal(got.perm, want.perm[s, :n])
        np.testing.assert_array_equal(got.ii, want.ii[s, :n])
        np.testing.assert_array_equal(got.jj, want.jj[s, :n])
        np.testing.assert_array_equal(owners[got.perm], s)
        m = int(want.pair_valid[s].sum())
        assert not want.pair_valid[s][m:].any()
        np.testing.assert_array_equal(got.pair_a, want.pair_a[s, :m])
        np.testing.assert_array_equal(got.pair_b, want.pair_b[s, :m])
        n_edges.append(n)
    assert sum(n_edges) == int(valid.sum())
    if D == 3 and edge_max == 9:
        assert n_edges[-1] == 0


# -----------------------------------------------------------------------------
# the sharded solve
# -----------------------------------------------------------------------------

F, HT, WD = 16, 6, 8
T0 = 1
# name: (counter, edges among frames below, iterations, depth prior)
CASES = {
    "cut_1it": (16, 16, 1, False),
    "cut_2it": (16, 16, 2, False),
    "cut_prior_1it": (16, 16, 1, True),
    "cut_prior_2it": (16, 16, 2, True),
    "pad_prior_2it": (13, 13, 2, True),
    "empty_shard_2it": (13, 9, 2, False),
}


def _solve_inputs(counter, edge_max, prior, seed=7):
    """tests/test_parallel.py's problem: 16 frames of 6x8, edges with
    |i − j| ≤ 2 among the frames below ``edge_max``."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (F, 1))
    poses = np.asarray(jlie.retr(jnp.asarray(poses), jnp.asarray(0.02 * rng.standard_normal((F, 6)), jnp.float32)))
    disps = (0.5 + rng.random((F, HT, WD))).astype(np.float32)
    intr = np.array([8.0, 8.0, WD / 2, HT / 2], np.float32)
    pairs = [(a, b) for a in range(edge_max) for b in range(edge_max) if a != b and abs(a - b) <= 2]
    ii = np.array([a for a, _ in pairs], np.int32)
    jj = np.array([b for _, b in pairs], np.int32)
    coords, _ = jpops.projective_transform(jnp.asarray(poses), jnp.asarray(disps),
                                           jnp.broadcast_to(jnp.asarray(intr), (F, 4)), jnp.asarray(ii),
                                           jnp.asarray(jj))
    target = (np.asarray(coords) + 0.05 * rng.standard_normal(coords.shape)).astype(np.float32)
    weight = (0.4 + 0.6 * rng.random(target.shape)).astype(np.float32)
    eta = np.full((F, HT, WD), 0.01, np.float32)
    sens = np.zeros_like(disps)
    if prior:
        sens[3:7] = (0.5 + rng.random((4, HT, WD))).astype(np.float32)
        sens[4, :2] = 0.0  # partly missing depth
    return dict(poses=poses, disps=disps, intr=intr, sens=sens, target=target, weight=weight, eta=eta,
                ii=ii, jj=jj)


def _jax_refs(x, counter, iterations):
    """(single-device ba_solve, 1-device-mesh sharded_ba_solve) of the JAX
    package, lm 1e-5 and ep 1e-2 as the sharded path uses."""
    t1 = counter
    window = t1 - T0
    N = len(x["ii"])
    valid = np.ones(N, bool)
    pairs = jba.SchurPairs.build(x["ii"], x["jj"], valid, T0, t1, window)
    prob = jba.BAProblem(
        target=jnp.asarray(x["target"]), weight=jnp.asarray(x["weight"]), eta=jnp.asarray(x["eta"]),
        ii=jnp.asarray(x["ii"]), jj=jnp.asarray(x["jj"]), edge_valid=jnp.asarray(valid),
        t0=jnp.int32(T0), t1=jnp.int32(t1), pairs=pairs,
    )
    single = jba.ba_solve(jnp.asarray(x["poses"]), jnp.asarray(x["disps"]), jnp.asarray(x["intr"]),
                          jnp.asarray(x["sens"]), prob, window, iterations=iterations, lm=1e-5, ep=1e-2)
    mesh = Mesh(np.array(jax.devices()[:1]), ("ba",))
    plan = jsh.ShardedBAPlan.build(x["ii"], x["jj"], valid, 1, counter, T0, t1)
    sharded = jsh.sharded_ba_solve(mesh, plan, x["target"], x["weight"], jnp.asarray(x["eta"]),
                                   jnp.asarray(x["poses"]), jnp.asarray(x["disps"]), jnp.asarray(x["intr"]),
                                   jnp.asarray(x["sens"]), T0, t1, window, iterations=iterations)
    return [tuple(np.asarray(a) for a in r) for r in (single, sharded)]


@pytest.fixture(scope="module")
def sharded_solves(tmp_path_factory):
    """Every case through 2 and 3 gloo ranks (one launch per rank count),
    and the JAX references."""
    tmp = tmp_path_factory.mktemp("sharded_solves")
    cases, inputs = {}, {}
    for name, (counter, edge_max, iterations, prior) in CASES.items():
        x = _solve_inputs(counter, edge_max, prior)
        path = tmp / f"{name}.npz"
        np.savez(path, **{k: v.astype(np.int64) if k in ("ii", "jj") else v for k, v in x.items()})
        inputs[name] = x
        cases[name] = dict(inputs=str(path), counter=counter, t0=T0, t1=counter, iterations=iterations)
    runs = {}
    for world in (2, 3):
        sub = tmp / f"world{world}"
        sub.mkdir()
        runs[world] = _run_ranks(world, dict(kind="solve", cases=cases), sub)
    refs = {name: _jax_refs(inputs[name], CASES[name][0], CASES[name][2]) for name in CASES}
    return inputs, runs, refs


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_solve_matches_jax(sharded_solves, world, case):
    inputs, runs, refs = sharded_solves
    ranks = runs[world]
    for r in ranks[1:]:  # every rank holds the same replicated result
        for k in ("poses", "disps"):
            np.testing.assert_array_equal(r[f"{case}/{k}"], ranks[0][f"{case}/{k}"])
    gp, gd = ranks[0][f"{case}/poses"], ranks[0][f"{case}/disps"]
    x = inputs[case]
    (sp, sd), (mp, md) = refs[case]
    assert np.abs(sp - x["poses"]).max() > 1e-3  # the solve moves the poses
    for want_p, want_d in ((sp, sd), (mp, md)):
        assert np.abs(gp - want_p).max() < 1e-4
        assert np.abs(gd - want_d).max() < 1e-4
    assert gd.min() >= 0.001
    n_local = [int(r[f"{case}/n_local"]) for r in ranks]
    assert sum(n_local) == len(x["ii"])
    if case.startswith("empty_shard") and world == 3:
        assert n_local[-1] == 0


# -----------------------------------------------------------------------------
# the backend with a process group
# -----------------------------------------------------------------------------

CONFIG = dict(
    image_size=(64, 64),
    buffer=24,
    warmup=4,
    max_factors=16,
    inactive_pad=16,
    window_pad=16,
    schur_pair_floor=512,
    filter_thresh=-1.0,
    keyframe_thresh=0.0,
    frontend_window=8,
    frontend_thresh=1e9,
    backend_thresh=1e9,
    frontend_iters1=2,
    frontend_iters2=1,
    compute_dtype="float32",
)
BUFFERS = ("tstamp", "images", "poses", "disps", "disps_sens", "intrinsics", "fmaps", "nets", "inps")
# the port's sharded backend against its single-device backend on the same
# state, in f32: the two differ by the order of their sums (observed:
# 1.3e-7 poses, 5.4e-7 disparities), held to the BA's 1e-4. In bf16 the
# single-device solve stores the Schur blocks in bf16 and the sharded one
# in f32: tests/test_torch_droid_mesh.py compares those
SHARDED_VS_SINGLE_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _tracked_state():
    """tests/test_torch_backend.py's state: 10 RGB-D frames tracked by the
    JAX package at CONFIG."""
    params = jinit_params(jax.random.PRNGKey(7), image_size=(64, 64))
    rng = np.random.default_rng(5432)
    drng = np.random.default_rng(99)
    base = rng.integers(0, 255, (10, 10, 3)).astype(np.float32)
    big = np.kron(base, np.ones((8, 8, 1)))[:64, :64]
    intr = jnp.asarray([64.0, 64.0, 32.0, 32.0], jnp.float32)
    jd = JDroid(JDroidConfig(**CONFIG), params=params)
    for t in range(10):
        frame = np.roll(big, shift=2 * t, axis=1).astype(np.uint8)
        depth = ((1.0 + 2.0 * drng.random((64, 64))) * (drng.random((64, 64)) > 0.2)).astype(np.float32)
        jd.track(t, jnp.asarray(frame), depth=jnp.asarray(depth), intrinsics=intr)
    jd._sync_fused_state()
    state = {k: np.array(getattr(jd.video, k)) for k in BUFFERS}
    return params, state, jd.video.counter


def _jax_mesh_backend(params, state, t, upsample):
    cfg = JDroidConfig(**dict(CONFIG, upsample=upsample))
    v = JVideoState(cfg)
    v.counter = t
    for k, a in state.items():
        setattr(v, k, jnp.asarray(a))
    mesh = Mesh(np.array(jax.devices()[:1]), ("ba",))
    jbackend.DroidBackend({"params": params["params"]["update"]}, v, cfg, mesh=mesh)(2)
    return np.asarray(v.poses[:t]), np.asarray(v.disps[:t]), np.asarray(v.disps_up[:t])


def _port_single_backend(net, state, t, upsample=False):
    cfg = DroidConfig(**dict(CONFIG, upsample=upsample))
    v = VideoState(cfg, "cpu")
    v.counter = t
    for k, a in state.items():
        setattr(v, k, torch.from_numpy(a.copy()))
    with torch.backends.mkldnn.flags(enabled=False), torch.no_grad():
        runs = tbackend.DroidBackend(net.update, v, cfg)(2)
    return v.poses[:t].numpy(), v.disps[:t].numpy(), runs, v.disps_up[:t].numpy()


@pytest.fixture(scope="module")
def mesh_backend(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_backend")
    params, state, t = _tracked_state()
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    torch.save(sd, tmp / "weights.pt")
    np.savez(tmp / "state.npz", **state)
    configs = {f"up{int(up)}": dict(CONFIG, upsample=up) for up in (False, True)}
    ranks = _run_ranks(2, dict(kind="backend", state=str(tmp / "state.npz"), weights=str(tmp / "weights.pt"),
                                 t=t, configs=configs), tmp)
    net = DroidNet()
    net.load_state_dict(sd)
    return dict(
        t=t, state=state, ranks=ranks,
        jax={up: _jax_mesh_backend(params, state, t, up) for up in (False, True)},
        single=_port_single_backend(net, state, t),
        single_up=_port_single_backend(net, state, t, upsample=True)[3],
    )


@pytest.mark.parametrize("upsample", [False, True])
def test_mesh_backend_matches_jax(mesh_backend, upsample):
    r = mesh_backend
    name = f"up{int(upsample)}"
    ranks = r["ranks"]
    for k in ("poses", "disps", "disps_up", "runs"):
        np.testing.assert_array_equal(ranks[1][f"{name}/{k}"], ranks[0][f"{name}/{k}"])
    gp, gd, gu = (ranks[0][f"{name}/{k}"] for k in ("poses", "disps", "disps_up"))
    wp, wd, wu = r["jax"][upsample]
    assert np.abs(wp - r["state"]["poses"][: r["t"]]).max() > 1e-4  # the backend moved the poses
    assert np.abs(gp - wp).max() < 5e-3
    assert np.abs(gd - wd).max() < 5e-3
    if upsample:
        assert np.abs(gu).max() > 0.1  # disps_up was written
        assert np.abs(gu - wu).max() < 5e-3
        # the single-device backend upsamples after its solve; the lag is
        # what tells them apart (0.033 here)
        assert np.abs(r["single_up"] - gu).max() > 5e-3
    else:
        assert not gu.any()


def test_mesh_backend_against_single_device(mesh_backend):
    """The same edges and chunks, poses and disparities within
    SHARDED_VS_SINGLE_TOL of the single-device backend."""
    r = mesh_backend
    sp, sd, runs, _ = r["single"]
    gp, gd = r["ranks"][0]["up0/poses"], r["ranks"][0]["up0/disps"]
    assert tuple(r["ranks"][0]["up0/runs"]) == tuple(runs)
    assert np.abs(gp - sp).max() < SHARDED_VS_SINGLE_TOL
    assert np.abs(gd - sd).max() < SHARDED_VS_SINGLE_TOL
