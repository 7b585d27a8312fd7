"""The trainer's optimizer, checkpoints and entry point: the three learning-
rate schedules and a few AdamW updates (a clipped step and non-finite
gradients among them) against the JAX trainer's optax chain; parameter and
train-state checkpoints (a resumed step equals the uninterrupted one); and
``apps/train.py --synthetic --device cpu`` for 2 steps, whose checkpoint
``load_weights`` reads."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from droid_slam_tpu.train.trainer import TrainConfig as JTrainConfig
from droid_slam_tpu.train.trainer import make_optimizer as jmake_optimizer
from droid_slam_tpu_torch.apps import train as train_app
from droid_slam_tpu_torch.models.droid_net import DroidNet, init_params
from droid_slam_tpu_torch.models.weights import load_weights
from droid_slam_tpu_torch.train import checkpoints
from droid_slam_tpu_torch.train.trainer import (
    Optimizer,
    TrainConfig,
    init_state,
    learning_rate,
    make_initial_batch,
    make_train_step,
)

torch.set_num_threads(2)


def _optax_schedule(cfg):
    steps = max(cfg.steps, 2)
    pct = min(max(cfg.pct_start, 1.0 / steps), 0.5)
    if cfg.schedule == "onecycle":
        return optax.cosine_onecycle_schedule(transition_steps=steps, peak_value=cfg.lr, pct_start=pct)
    if cfg.schedule == "cosine":
        return optax.cosine_decay_schedule(init_value=cfg.lr, decay_steps=steps, alpha=cfg.lr_final / cfg.lr)
    return optax.constant_schedule(cfg.lr)


@pytest.mark.parametrize("schedule", ["onecycle", "cosine", "constant"])
@pytest.mark.parametrize("steps,pct_start", [(10, 0.01), (1000, 0.05)])
def test_learning_rate_matches_optax(schedule, steps, pct_start):
    cfg = TrainConfig(steps=steps, schedule=schedule, pct_start=pct_start)
    ours, theirs = learning_rate(cfg), _optax_schedule(cfg)
    for count in (0, 1, 2, 5, 9, 10, 11, 49, 50, 51, 500, 999, 1000, 2000):
        a, b = ours(count), float(theirs(count))
        # optax evaluates in f32: end + (start − end)/2·(cos + 1) loses
        # digits of the peak near the ends of the cycle
        assert abs(a - b) <= 1e-5 * abs(b) + 1e-7 * cfg.lr, (count, a, b)


def test_optimizer_updates_match_optax():
    """4 updates of two tensors: a small gradient, one above the clip
    norm, one with NaN and ±inf entries (zeroed before the clip), and a
    small one; each parameter within 2e-7 + 1e-6·|p| of optax's."""
    r = np.random.default_rng(0)
    start = {"a": r.standard_normal((3, 4)).astype(np.float32), "b": r.standard_normal(5).astype(np.float32)}
    grads = [{k: (s * r.standard_normal(v.shape)).astype(np.float32) for k, v in start.items()}
             for s in (0.1, 10.0, 0.5, 0.1)]
    grads[2]["a"][0, 0] = np.nan
    grads[2]["b"][1] = np.inf
    grads[2]["b"][2] = -np.inf
    kw = dict(steps=20, pct_start=0.1, clip=1.0, weight_decay=1e-2, lr=1e-2)

    tx = jmake_optimizer(JTrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
    opt = Optimizer(TrainConfig(**kw), tp.items())
    norms = []
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        norms.append(np.sqrt(sum(float(np.sum(np.where(np.isfinite(v), v, 0) ** 2)) for v in g.values())))
        for k in start:
            want, got = np.asarray(jp[k]), tp[k].detach().numpy()
            assert np.isfinite(got).all()
            assert (np.abs(got - want) <= 2e-7 + 1e-6 * np.abs(want)).all(), (k, np.abs(got - want).max())
    assert norms[1] > 1.0 > norms[0]  # the second step was clipped
    assert opt.count == 4


def _tiny_state(cfg):
    model = DroidNet()
    model.load_state_dict(init_params(1))
    return init_state(model, cfg)


def test_train_state_roundtrip_and_resume(tmp_path):
    """A restored state is the saved one bit for bit, and a step from it
    equals the step the uninterrupted run takes."""
    cfg = TrainConfig(steps=10, n_frames=3, num_iters=1, pct_start=0.2)
    ii, jj = train_app.neighbour_graph(3)
    step = make_train_step(cfg, ii, jj)
    batches = [make_initial_batch(np.random.default_rng(s), 1, 3, (32, 32)) for s in range(2)]

    state = _tiny_state(cfg)
    state, _, _ = step(state, batches[0])
    path = str(tmp_path / "state.pt")
    checkpoints.save_train_state(path, state)

    resumed = checkpoints.restore_train_state(path, _tiny_state(cfg))
    assert resumed["step"] == state["step"] == 1
    for (k, a), b in zip(state["model"].state_dict().items(), resumed["model"].state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = state["optimizer"].state_dict(), resumed["optimizer"].state_dict()
    assert sa["count"] == sb["count"] == 1
    for k in sa["adamw"]["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["adamw"]["state"][k][name], sb["adamw"]["state"][k][name])

    state, m1, _ = step(state, batches[1])
    resumed, m2, _ = step(resumed, batches[1])
    assert float(m1["loss"]) == float(m2["loss"])
    for (k, a), b in zip(state["model"].state_dict().items(), resumed["model"].state_dict().values()):
        assert torch.equal(a, b), k


def test_params_checkpoint_is_read_by_load_weights(tmp_path):
    model = DroidNet()
    model.load_state_dict(init_params(2))
    path = str(tmp_path / "p.pth")
    checkpoints.save_params(path, model)
    got = load_weights(path)
    assert set(got) == set(model.state_dict())
    assert all(torch.equal(got[k], v) for k, v in model.state_dict().items())


def test_train_app_two_steps_writes_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    history = train_app.main([
        "--synthetic", "--device", "cpu", "--crop", "64", "64", "--steps", "2", "--batch", "1",
        "--n_frames", "4", "--iters", "2", "--pool", "2", "--edges", "6", "--ckpt_every", "2",
        "--state_every", "1", "--name", "t",
    ])
    assert [h["step"] for h in history] == [1, 2]
    assert all(h["grads_finite"] and np.isfinite(h["metrics"]["loss"]) for h in history)
    params = load_weights(str(tmp_path / "checkpoints" / "t_000002.pth"))
    DroidNet().load_state_dict(params)
    assert all(torch.isfinite(v).all() for v in params.values())
    # and the train state of step 1 resumes to step 2
    history = train_app.main([
        "--synthetic", "--device", "cpu", "--crop", "64", "64", "--steps", "2", "--batch", "1",
        "--n_frames", "4", "--iters", "2", "--pool", "2", "--edges", "6", "--ckpt_every", "100",
        "--resume", str(tmp_path / "checkpoints" / "t_state_000001.pt"), "--name", "t",
    ])
    assert [h["step"] for h in history] == [2]


@pytest.mark.parametrize("argv,item", [
    (["--datapath", "datasets/TartanAir"], "item 3"),
    (["--synthetic", "--num_processes", "2"], "item 6"),
])
def test_train_app_refuses_what_is_not_ported(argv, item, capsys):
    with pytest.raises(SystemExit):
        train_app.main(argv + ["--device", "cpu"])
    assert item in capsys.readouterr().err
