"""The training unroll against the JAX package: ``DroidNet.forward`` (with
checkpointing) plus the trainer's loss (``train/trainer.py``'s
``make_train_step(...).grad``) against the JAX trainer's ``grad_step``
(``loss_fn`` under ``jax.value_and_grad``) on one rendered clip (B = 1,
4 frames at 64×64, 3 iterations) and a padded randomised graph with
``edge_valid``, the weights carried over by ``params_from_jax``: the loss,
each metric, the per-step outputs and every parameter's gradient.

The gradient case starts from per-frame distinct poses, as a restart pass
does. With the trainer's first-pass initialisation, frames 1..F-1 share one
pose, so the flow of their edges is rounding noise around 0, and the flow
encoder's first ReLU gates on that noise's sign, which differs between
XLA's fused multiply-adds and PyTorch's separate ones: the flow encoder's
bias gradients then differ by O(1). That case compares the loss, the
metrics and the outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from droid_slam_tpu.models.droid_net import init_params as jinit_params
from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.train.trainer import TrainConfig as JTrainConfig
from droid_slam_tpu.train.trainer import make_train_step as jmake_train_step
from droid_slam_tpu_torch.apps.train import neighbour_graph, pad_graph
from droid_slam_tpu_torch.models.droid_net import DroidNet
from droid_slam_tpu_torch.models.weights import params_from_jax
from droid_slam_tpu_torch.train.trainer import TrainConfig, make_train_step

torch.set_num_threads(2)

F, H, W, ITERS = 4, 64, 64, 3


def _batch(restart_init: bool):
    clip = next(JSyntheticDataset(n_frames=F, image_size=(H, W), seed=3, pool=0).clips(1))
    Ps = np.asarray(jlie.inv(jnp.asarray(clip["poses"])))
    Gs0 = Ps.copy()
    Gs0[:, 1:] = Ps[:, 1:2]
    if restart_init:
        tw = 0.02 * np.random.default_rng(1).standard_normal((1, F, 6)).astype(np.float32)
        Gs0 = np.asarray(jlie.retr(jnp.asarray(Gs0), jnp.asarray(tw)))
    bi, bj = neighbour_graph(F)
    ii, jj, valid = pad_graph(bi[::2], bj[::2], len(bi[::2]) + 2)  # 2 padded slots
    return dict(images=clip["images"], poses=Ps, disps=clip["disps"], intrinsics=clip["intrinsics"],
                poses_init=Gs0, disps_init=np.ones((1, F, H // 8, W // 8), np.float32),
                ii=ii, jj=jj, edge_valid=valid)


@pytest.fixture(scope="module")
def runs():
    """Both packages' grad step on both batches; the JAX side is jitted
    once for the two."""
    bi, bj = neighbour_graph(F)
    jparams = jinit_params(jax.random.PRNGKey(5), image_size=(H, W))
    jstep = jmake_train_step(JTrainConfig(n_frames=F, num_iters=ITERS, remat=False), bi, bj)
    net = DroidNet()
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    tstep = make_train_step(TrainConfig(n_frames=F, num_iters=ITERS), bi, bj)
    out = {}
    for restart in (True, False):
        batch = _batch(restart)
        jbatch = {k: jnp.asarray(v.astype(np.int32) if k in ("ii", "jj") else v) for k, v in batch.items()}
        jg, jm, jout = jstep.grad(jparams, jbatch)
        jg = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
        tg, tm, tout = tstep.grad(net, batch)
        out[restart] = (jg, jm, jout, tg, tm, tout)
    return out


@pytest.mark.parametrize("restart", [True, False])
def test_loss_metrics_and_outputs_match_jax(runs, restart):
    jg, jm, jout, tg, tm, tout = runs[restart]
    assert set(tm) == set(jm)
    # f32 through 3 iterations of operator and BA in two libraries: 1e-5
    # relative
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1e-3), k
    assert tout.poses.shape == (ITERS, 1, F, 7)
    assert tout.disps_up.shape == (ITERS, 1, F, H, W)
    n_slots = len(jout.residuals[0])
    assert n_slots == len(neighbour_graph(F)[0][::2]) + 2
    assert tout.residuals.shape == (ITERS, n_slots, H // 8, W // 8, 2)
    for name in ("poses", "disps_up", "residuals"):
        a, b = np.asarray(getattr(jout, name)), getattr(tout, name).numpy()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), name
    # the padded slots' residuals are zero
    assert not tout.residuals[:, -2:].any()


def test_every_parameter_gradient_matches_jax(runs):
    jg, _, _, tg, _, _ = runs[True]
    assert set(tg) == set(jg)
    G = max(float(g.abs().max()) for g in jg.values())
    for k, g in tg.items():
        ref = jg[k]
        assert torch.isfinite(g).all(), k
        # each tensor relative to its largest entry, with a floor of 1e-3 of
        # the largest gradient entry of the model: the biases ahead of the
        # fnet's instance norms have a zero gradient in exact arithmetic
        # (the norm removes any per-channel constant), and both packages
        # return rounding noise there
        scale = max(float(ref.abs().max()), 1e-3 * G)
        assert float((g - ref).abs().max()) <= 1e-3 * scale, (k, float((g - ref).abs().max()), scale)
