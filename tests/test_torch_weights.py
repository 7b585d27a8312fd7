"""Port weights: the flax-free msgpack reader, the weight loaders, and the
port's DroidNet with the shipped weights against the JAX DroidNet.

``models/msgpack_io.py`` is held against the ``msgpack`` package on
hypothesis-generated documents (nested maps and arrays, ints at every width
boundary, floats, strings, bins and ext values of every size class) and
must refuse ext codes other than flax's ndarray and flax's chunked-array
nodes. ``load_weights`` must give, bit for bit, what ``params_from_jax``
gives on ``flax.serialization.msgpack_restore`` for both weight files, and
``state_dict_from_reference`` what the JAX converter
(``torch_state_dict_to_flax``) gives. With the shipped weights, fnet, cnet
and one update step of the port agree with the JAX DroidNet within 1e-4
(L∞, f32) on a rendered frame.
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from droid_slam_tpu.models import weights as jweights
from droid_slam_tpu.models.droid_net import DroidNet as JDroidNet
from droid_slam_tpu.models.update import UpdateModule as JUpdateModule
from droid_slam_tpu_torch.data.synthetic import render_sequence
from droid_slam_tpu_torch.models import msgpack_io
from droid_slam_tpu_torch.models.droid_net import DroidNet
from droid_slam_tpu_torch.models.weights import (
    load_params,
    load_weights,
    params_from_jax,
    state_dict_from_reference,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHT_FILES = ["droid_synth.msgpack", "equivalence_fixture.msgpack"]
TOL = 1e-4

# the edges of msgpack's integer encodings: fixint, int8/16/32/64, uint8/16/32/64
INT_EDGES = sorted({s * 2**k + d for k in (5, 7, 8, 15, 16, 31, 32, 63) for s in (1, -1) for d in (-1, 0, 1)
                    if -(2**63) <= s * 2**k + d < 2**64} | {2**64 - 1, 0})

scalars = (
    st.none()
    | st.booleans()
    | st.sampled_from(INT_EDGES)
    | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.floats(allow_nan=False)
    | st.text(max_size=40)
    | st.binary(max_size=300)
)
documents = st.recursive(
    scalars,
    lambda children: st.lists(children, max_size=20) | st.dictionaries(st.text(max_size=12), children, max_size=20),
    max_leaves=60,
)


@settings(max_examples=200, deadline=None)
@given(documents)
def test_unpackb_matches_msgpack(doc):
    data = msgpack.packb(doc, use_bin_type=True)
    assert msgpack_io.unpackb(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.floats(allow_nan=False, width=32), max_size=10))
def test_unpackb_reads_float32(values):
    data = msgpack.packb(values, use_single_float=True)
    assert msgpack_io.unpackb(data) == values


def _ext_pair(code, payload):
    return (code, bytes(payload))


@settings(max_examples=100, deadline=None)
@given(st.integers(min_value=0, max_value=127),
       st.sampled_from([1, 2, 4, 8, 16, 0, 3, 17, 255, 256, 65535, 65536]))
def test_unpackb_ext_sizes_match_msgpack(code, n):
    """fixext 1-16, ext 8/16/32: the payload and code reach the hook."""
    payload = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    data = msgpack.packb([msgpack.ExtType(code, payload), "after"])
    want = msgpack.unpackb(data, ext_hook=_ext_pair)
    assert msgpack_io.unpackb(data, ext_hook=_ext_pair) == want == [(code, payload), "after"]


@pytest.mark.parametrize("n", [15, 16, 65535, 65536])
def test_unpackb_large_containers(n):
    """fix, 16- and 32-bit lengths of str, bin, array and map."""
    doc = {
        "s": "x" * n,
        "b": b"\x01" * n,
        "a": list(range(n)),
        "m": {str(k): k for k in range(n)},
    }
    data = msgpack.packb(doc, use_bin_type=True)
    assert msgpack_io.unpackb(data) == doc


def test_ndarray_ext_is_a_writable_little_endian_copy():
    arr = np.arange(-6, 6, dtype=np.int64).reshape(3, 4) * 1000003
    data = serialization.msgpack_serialize({"x": {"y": arr, "z": np.float32(0)[None]}})
    tree = msgpack_io.unpackb(data)
    assert tree["x"]["y"].dtype == np.int64 and tree["x"]["y"].flags.writeable
    np.testing.assert_array_equal(tree["x"]["y"], arr)
    np.testing.assert_array_equal(tree["x"]["z"], [0.0])


@pytest.mark.parametrize("value", [np.float32(1.5), 1 + 2j])
def test_unknown_ext_codes_raise(value):
    """flax writes numpy scalars as ext 3 and complex numbers as ext 2."""
    data = serialization.msgpack_serialize({"params": {"a": np.ones(2, np.float32), "b": value}})
    with pytest.raises(msgpack_io.MsgpackError, match="ext type [23]"):
        msgpack_io.unpackb(data)


def test_chunked_array_node_raises():
    node = {"__msgpack_chunked_array__": True, "shape": [2], "chunks": {"0": [1.0, 2.0]}}
    data = msgpack.packb({"params": {"big": node}})
    with pytest.raises(msgpack_io.MsgpackError, match="__msgpack_chunked_array__"):
        msgpack_io.unpackb(data)


@pytest.mark.parametrize("data", [b"\x92\x01", b"\xc1", b"\x01\x02", b"\xc4\x05abc"])
def test_malformed_documents_raise(data):
    with pytest.raises(msgpack_io.MsgpackError):
        msgpack_io.unpackb(data)


@pytest.mark.parametrize("name", WEIGHT_FILES)
def test_load_weights_matches_flax_bitwise(name):
    path = os.path.join(REPO, "weights", name)
    with open(path, "rb") as f:
        want = params_from_jax(serialization.msgpack_restore(f.read()))
    got = load_weights(path)
    assert set(got) == set(want) == set(DroidNet().state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert len(jax.tree_util.tree_leaves(load_params(path))) == 102


def _reference_state_dict(seed: int):
    """A seeded state dict with the reference's names (DDP prefix, torch
    sequentials, 4-channel delta/weight heads), built from the port's
    module names through the inverse of the JAX converter's map."""
    inv_seq = {v: k for k, v in jweights._SEQ_MAP.items()}
    r = np.random.default_rng(seed)
    state = {}
    for name, p in DroidNet().state_dict().items():
        base, leaf = name.rsplit(".", 1)
        top, rest = base.split(".", 1)
        shape = tuple(p.shape)
        if top == "update":
            ref = f"update.{inv_seq[rest]}"
            if ref in jweights._TRUNCATED:
                shape = (4,) + shape[1:]
        elif rest.startswith("conv"):
            ref = base
        else:
            block, tail = rest.split(".", 1)
            layer, b = block.split("_")
            ref = f"{top}.{layer}.{b}.{tail}" + (".0" if tail == "downsample" else "")
        state[f"module.{ref}.{leaf}"] = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    return state


def test_state_dict_from_reference_matches_jax_converter():
    state = _reference_state_dict(11)
    assert any(v.shape[0] == 4 for v in state.values())  # the heads to truncate
    want = params_from_jax(jweights.torch_state_dict_to_flax({k: v.numpy() for k, v in state.items()}))
    got = state_dict_from_reference(state)
    assert set(got) == set(want) == set(DroidNet().state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    DroidNet().load_state_dict(got)  # every shape fits


def test_load_weights_reads_a_reference_checkpoint(tmp_path):
    state = _reference_state_dict(12)
    path = str(tmp_path / "droid.pth")
    torch.save(state, path)
    got = load_weights(path)
    want = state_dict_from_reference(state)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_state_dict_from_reference_rejects_unknown_names():
    with pytest.raises(KeyError):
        state_dict_from_reference({"module.update.unknown.0.weight": torch.zeros(1)})


@pytest.fixture(scope="module")
def shipped():
    path = os.path.join(REPO, "weights", WEIGHT_FILES[0])
    with open(path, "rb") as f:
        jparams = serialization.msgpack_restore(f.read())
    net = DroidNet()
    net.load_state_dict(load_weights(path))
    image = render_sequence(np.random.default_rng(7), n_frames=1, image_size=(96, 128),
                            t_sigma=0.25, r_sigma=0.02)["images"][:1].astype(np.float32)
    return jparams, net.eval(), image


def _err(a, b):
    return float(np.abs(np.asarray(a) - b.detach().numpy()).max())


def test_shipped_weights_encoders_match_jax(shipped):
    jparams, net, image = shipped
    fmap, jnet, jinp = JDroidNet().apply(jparams, jnp.asarray(image), method=JDroidNet.extract_features)
    with torch.no_grad():
        tfmap = net.features(torch.from_numpy(image))
        tnet, tinp = net.context(torch.from_numpy(image))
    assert _err(fmap[0], tfmap) < TOL
    assert _err(jnet, tnet) < TOL and _err(jinp, tinp) < TOL
    assert float(np.abs(np.asarray(fmap)).max()) > 0.1  # not a degenerate map


def test_shipped_weights_update_step_matches_jax(shipped):
    jparams, net, _ = shipped
    r = np.random.default_rng(3)
    n, h, w = 2, 12, 16
    args = (
        np.tanh(r.standard_normal((n, h, w, 128))).astype(np.float32),
        np.maximum(r.standard_normal((n, h, w, 128)), 0).astype(np.float32),
        r.standard_normal((n, h, w, 196)).astype(np.float32),
        (4 * r.standard_normal((n, h, w, 4))).astype(np.float32),
    )
    want = JUpdateModule().apply({"params": jparams["params"]["update"]}, *map(jnp.asarray, args))
    with torch.no_grad():
        got = net.update(*map(torch.from_numpy, args))
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape)
        assert _err(a, b) < TOL
