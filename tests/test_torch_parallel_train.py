"""Port parity for data-parallel training on torch.distributed (gloo on the
CPU): one optimizer step of 2 ranks, each on its half of a batch, against
the JAX package's ``make_train_step`` on the whole batch.

Each rank computes the gradient of its rows (``shard_batch_for_mesh``),
scaled as its half of the global mean loss (``grad(..., mesh=)``), the
ranks sum it in one flat all-reduce (``allreduce_gradients``), reduce
the metrics (``reduce_metrics``: the means over equal counts averaged,
``f_error`` and ``1px`` as summed numerators over summed valid-pixel
counts) and apply AdamW. The
all-reduced gradient of every parameter must agree with ``jax.grad`` of
the whole batch's loss within 1e-3 of that parameter's largest gradient
entry (``tests/test_torch_train_unroll.py``'s bound): AdamW's first step
moves a parameter by about the learning rate times the sign of its
gradient, so the parameters alone would not see a gradient that is off by
a factor. The loss must agree within 1e-4 and the parameters within 5e-4
(``tests/test_parallel.py``'s bounds), every metric within 1e-4 of the
JAX step's global-batch metric (relative above 1), and the two ranks'
gradients and parameters bit for bit.

Ranks are child processes (``sys.executable -c``) that meet at a
``TCPStore`` the test process holds on 127.0.0.1 (bound to a port the
kernel picks, and held until both children have exited, so no other
process can take the port in between), with a 120 s group timeout, waited
on for at most 300 s and killed in a ``finally``; a failing child's exit
code and the end of its stderr go into the assertion message.
"""

import datetime
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

from droid_slam_tpu.models.droid_net import init_params as jinit_params
from droid_slam_tpu.train.trainer import TrainConfig as JTrainConfig
from droid_slam_tpu.train.trainer import init_state as jinit_state
from droid_slam_tpu.train.trainer import make_initial_batch as jmake_initial_batch
from droid_slam_tpu.train.trainer import make_train_step as jmake_train_step
from droid_slam_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FRAMES, SIZE, BATCH, ITERS = 3, (32, 32), 4, 2
GRAPH = [(a, b) for a in range(FRAMES) for b in range(FRAMES) if a != b]

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

from droid_slam_tpu_torch.models.droid_net import DroidNet
from droid_slam_tpu_torch.train.trainer import (
    TrainConfig, allreduce_gradients, host_local_slice, init_state, make_train_step, reduce_metrics,
    replicate_for_mesh, shard_batch_for_mesh,
)

model = DroidNet()
if rank == 0:  # the other ranks start from other weights and take rank 0's
    model.load_state_dict(torch.load(job["weights"], weights_only=True))
replicate_for_mesh(model, group)
cfg = TrainConfig(n_frames=job["frames"], num_iters=job["iters"], steps=10)
state = init_state(model, cfg)
ii, jj = np.array(job["ii"]), np.array(job["jj"])
step = make_train_step(cfg, ii, jj)
batch = shard_batch_for_mesh(dict(np.load(job["batch"])), group)
counts = {}
grads, metrics, out = step.grad(state["model"], batch, counts, mesh=group)
poses_re = out.poses[-1]
assert host_local_slice(poses_re, len(batch["images"])) is poses_re
grads = allreduce_gradients(grads, group)
metrics = reduce_metrics(metrics, counts, group)
res = {"grad/" + k: g.numpy().copy() for k, g in grads.items()}
state = step.apply(state, grads)
res.update({"param/" + k: v.detach().numpy() for k, v in state["model"].state_dict().items()})
res.update({"metric/" + k: v.numpy() for k, v in metrics.items()})
res["local_rows"] = np.array(len(batch["images"]))
np.savez(job["out"].format(rank=rank), **res)
dist.destroy_process_group()
"""


def _store():
    """The rendezvous of the ranks: a TCPStore that this process serves on a
    port the kernel picks, for as long as the caller holds it."""
    return dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=120))


@pytest.fixture(scope="module")
def dp_step(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_step")
    params = jinit_params(jax.random.PRNGKey(0), image_size=SIZE)
    batch = jmake_initial_batch(np.random.default_rng(0), BATCH, FRAMES, SIZE)
    torch.save(params_from_jax(jax.tree_util.tree_map(np.asarray, params)), tmp / "weights.pt")
    np.savez(tmp / "batch.npz", **batch)
    job = dict(weights=str(tmp / "weights.pt"), batch=str(tmp / "batch.npz"), frames=FRAMES, iters=ITERS,
               ii=[a for a, _ in GRAPH], jj=[b for _, b in GRAPH], out=str(tmp / "rank{rank}.npz"))
    (tmp / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    store = _store()
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), "2", str(store.port), str(tmp / "job.json")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for r in range(2)]
    try:
        # the JAX reference while the ranks run
        cfg = JTrainConfig(num_iters=ITERS, n_frames=FRAMES, steps=10)
        step = jmake_train_step(cfg, np.array([a for a, _ in GRAPH]), np.array([b for _, b in GRAPH]))
        jgrads, jmetrics, _ = step.grad(params, {k: jnp.asarray(v) for k, v in batch.items()})
        jstate = step.apply(jinit_state(params, cfg), jgrads)
        want_params = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]))
        want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    del store
    failed = [p.returncode for p in procs if p.returncode != 0]
    assert not failed, "\n".join(f"rank {r}: exit {p.returncode}\n{out[-2000:]}{err[-4000:]}"
                                  for r, (p, (out, err)) in enumerate(zip(procs, results)))
    ranks = [dict(np.load(job["out"].format(rank=r))) for r in range(2)]
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return ranks, {k: float(v) for k, v in jmetrics.items()}, want_params, init, want_grads


def test_ranks_agree_bitwise(dp_step):
    ranks = dp_step[0]
    assert [int(r["local_rows"]) for r in ranks] == [BATCH // 2] * 2
    keys = [k for k in ranks[0] if k.startswith(("grad/", "param/", "metric/"))]
    assert any(k.startswith("param/") for k in keys) and any(k.startswith("grad/") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)


def test_loss_and_parameters_match_jax_whole_batch(dp_step):
    ranks, jmetrics, want, init = dp_step[:4]
    got = ranks[0]
    assert abs(float(got["metric/loss"]) - jmetrics["loss"]) < 1e-4
    moved = 0.0
    for k, w in want.items():
        g = got["param/" + k]
        assert np.isfinite(g).all(), k
        assert np.abs(g - w.numpy()).max() < 5e-4, k
        moved = max(moved, float(np.abs(g - init[k].numpy()).max()))
    assert moved > 0.0  # the step updated the parameters


def test_allreduced_gradients_match_jax_whole_batch(dp_step):
    got = {k[len("grad/"):]: v for k, v in dp_step[0][0].items() if k.startswith("grad/")}
    want = dp_step[4]
    assert set(got) == set(want)
    G = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k, w in want.items():
        w = w.numpy()
        assert np.isfinite(got[k]).all(), k
        # each tensor relative to its largest entry, with a floor of 1e-3 of
        # the model's largest gradient entry (the biases ahead of the fnet's
        # instance norms have a zero gradient in exact arithmetic)
        scale = max(float(np.abs(w).max()), 1e-3 * G)
        err = float(np.abs(got[k] - w).max())
        assert err <= 1e-3 * scale, (k, err, scale)


def test_metrics_match_jax_global_batch(dp_step):
    ranks, jmetrics = dp_step[:2]
    got = {k[len("metric/"):]: float(v) for k, v in ranks[0].items() if k.startswith("metric/")}
    assert set(got) == set(jmetrics)
    assert {"f_error", "1px"} <= set(got)
    for k, w in jmetrics.items():
        assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got[k], w)
