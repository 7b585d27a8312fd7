"""Port parity: encoders, update operator and convex upsampling against the
JAX package, on seeded inputs, with JAX parameters carried over by
``params_from_jax``. Tolerance 1e-4 L∞ in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.models import update as jupdate
from droid_slam_tpu.models.droid_net import DroidNet as JDroidNet
from droid_slam_tpu.models.droid_net import init_params as jinit_params
from droid_slam_tpu_torch.models import update as tupdate
from droid_slam_tpu_torch.models.droid_net import DroidNet, init_params
from droid_slam_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(2)

TOL = 1e-4
H, W = 64, 64
h, w = H // 8, W // 8


@pytest.fixture(scope="module")
def nets():
    jparams = jinit_params(jax.random.PRNGKey(7))
    net = DroidNet()
    net.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    return jparams, net.eval()


def _images(seed, n=2):
    return np.random.default_rng(seed).integers(0, 255, (n, H, W, 3)).astype(np.float32)


def _err(a, b):
    return float(np.abs(np.asarray(a) - b.detach().numpy()).max())


def test_fnet_matches_jax(nets):
    jparams, net = nets
    img = _images(0)
    want = JDroidNet().apply(jparams, jnp.asarray(img), method=JDroidNet.extract_features)[0]
    with torch.no_grad():
        got = net.features(torch.from_numpy(img))
    assert got.shape == want.shape
    assert _err(want, got) < TOL


def test_cnet_matches_jax(nets):
    jparams, net = nets
    img = _images(1)
    _, jnet, jinp = JDroidNet().apply(jparams, jnp.asarray(img), method=JDroidNet.extract_features)
    with torch.no_grad():
        tnet, tinp = net.context(torch.from_numpy(img))
    assert _err(jnet, tnet) < TOL
    assert _err(jinp, tinp) < TOL


def _update_inputs(seed, n=3):
    r = np.random.default_rng(seed)
    f32 = np.float32
    return (
        np.tanh(r.standard_normal((n, h, w, 128))).astype(f32),
        np.maximum(r.standard_normal((n, h, w, 128)), 0).astype(f32),
        r.standard_normal((n, h, w, 196)).astype(f32),
        (4 * r.standard_normal((n, h, w, 4))).astype(f32),
    )


@pytest.mark.parametrize("with_agg", [False, True])
def test_update_module_matches_jax(nets, with_agg):
    jparams, net = nets
    uparams = {"params": jparams["params"]["update"]}
    args = _update_inputs(2)
    ii = np.array([0, 2, 2], np.int64)
    valid = np.array([True, True, False])
    num_frames = 4
    extra_j = (jnp.asarray(ii), num_frames, jnp.asarray(valid)) if with_agg else ()
    want = jupdate.UpdateModule().apply(uparams, *map(jnp.asarray, args), *extra_j)
    extra_t = (torch.from_numpy(ii), num_frames, torch.from_numpy(valid)) if with_agg else ()
    with torch.no_grad():
        got = net.update(*map(torch.from_numpy, args), *extra_t)
    assert len(got) == len(want) == (5 if with_agg else 3)
    for a, b in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape)
        assert _err(a, b) < TOL


def test_cvx_upsample_matches_jax():
    r = np.random.default_rng(3)
    data = r.standard_normal((2, h, w, 3)).astype(np.float32)
    mask = r.standard_normal((2, h, w, 576)).astype(np.float32)
    want = jupdate.cvx_upsample(jnp.asarray(data), jnp.asarray(mask))
    got = tupdate.cvx_upsample(torch.from_numpy(data), torch.from_numpy(mask))
    assert got.shape == (2, H, W, 3)
    assert _err(want, got) < TOL
    disp = data[..., 0]
    assert _err(
        jupdate.upsample_disp(jnp.asarray(disp), jnp.asarray(mask)),
        tupdate.upsample_disp(torch.from_numpy(disp), torch.from_numpy(mask)),
    ) < TOL


def test_init_params_is_seeded_and_complete():
    a, b = init_params(3), init_params(3)
    names = set(DroidNet().state_dict())
    assert set(a) == names
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fnet.conv1.weight"], init_params(4)["fnet.conv1.weight"])
