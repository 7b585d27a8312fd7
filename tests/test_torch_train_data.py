"""Training data and graphs against the JAX package: the covisibility
distance matrices (``data/rgbd_utils.py``), the frame-graph builders
(``train/graph_utils.py``, with the greedy-selection oracle of
``tests/test_training.py``) and ``SyntheticDataset.clips`` bit for bit."""

from collections import OrderedDict
from unittest import mock

import numpy as np
import pytest
import torch

from droid_slam_tpu.data import rgbd_utils as jrgbd
from droid_slam_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from droid_slam_tpu.train import graph_utils as jgraph
from droid_slam_tpu_torch.data import rgbd_utils
from droid_slam_tpu_torch.data.synthetic import SyntheticDataset
from droid_slam_tpu_torch.ops import lie
from droid_slam_tpu_torch.train import graph_utils

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clip():
    """A rendered 12-frame clip at 96x128 (camera-to-world poses)."""
    return next(SyntheticDataset(n_frames=12, image_size=(96, 128), seed=5, pool=0).clips(1))


def _forward_scene(F=6, H=32, W=32):
    """A camera moving forward over a textured plane: the covisibility
    scene of tests/test_training.py's v2 test."""
    r = np.random.default_rng(4)
    poses_w2c = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (F, 1))
    poses_w2c[:, 2] = 0.05 * np.arange(F)
    poses_c2w = lie.inv(torch.from_numpy(poses_w2c)).numpy()
    disps = (0.4 + 0.05 * r.random((F, H, W))).astype(np.float32)
    intr = np.tile(np.array([32.0, 32.0, 16.0, 16.0], np.float32), (F, 1))
    return poses_c2w, disps, intr


@pytest.mark.parametrize("which", ["flow", "flow2"])
def test_distance_matrices_match_jax(clip, which):
    poses, disps, intr = clip["poses"][0], clip["disps"][0][:, 3::8, 3::8], clip["intrinsics"][0] / 8.0
    if which == "flow":
        want = jrgbd.compute_distance_matrix_flow(poses, disps, intr)
        got = rgbd_utils.compute_distance_matrix_flow(poses, disps, intr, chunk=7)
    else:
        want = jrgbd.compute_distance_matrix_flow2(poses, disps, intr)
        got = rgbd_utils.compute_distance_matrix_flow2(poses, disps, intr, chunk=7)
    assert got.shape == want.shape == (12, 12)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.sum() > 12
    # f32 flow magnitudes averaged over pixels: 1e-4 relative
    assert np.abs(got[fin] - want[fin]).max() <= 1e-4 * np.abs(want[fin]).max()


def test_build_frame_graph_matches_jax(clip):
    args = (clip["poses"][0], clip["disps"][0], clip["intrinsics"][0])
    picked = 0
    for num in (24, 48, 60):  # the radius-2 neighbourhood alone is 42 edges
        want = jgraph.build_frame_graph(*args, num=num)
        got = graph_utils.build_frame_graph(*args, num=num)
        assert got == want
        for a, b in zip(graph_utils.graph_to_edge_list(got), jgraph.graph_to_edge_list(want)):
            assert np.array_equal(a, b)
        picked = max(picked, sum(len(v) for v in got.values()) - 42)
    assert picked > 0  # covisible pairs beyond the neighbourhood were picked


def test_build_frame_graph_v2_matches_jax():
    poses_c2w, disps, intr = _forward_scene()
    want = jgraph.build_frame_graph_v2(poses_c2w, disps, intr, thresh=100.0, r=1)
    got = graph_utils.build_frame_graph_v2(poses_c2w, disps, intr, thresh=100.0, r=1)
    assert got == want
    ii, jj, _ = graph_utils.graph_to_edge_list(got)
    long_range = [(i, j) for i, j in zip(ii.tolist(), jj.tolist()) if abs(i - j) > 1]
    assert long_range
    for a in long_range:  # NMS: no two accepted long-range edges within distance 1
        for b in long_range:
            assert a == b or max(abs(a[0] - b[0]), abs(a[1] - b[1])) > 1


def test_build_frame_graph_matches_greedy_oracle():
    """The one-shot argsort selection equals the reference's greedy
    repeated-argmin loop (graph_utils.py:37-68), adjacency order included."""
    rng = np.random.default_rng(11)
    N, num, thresh, r = 9, 22, 60.0, 2
    dmat = (rng.random((N, N)) * 100).astype(np.float32)

    def oracle(d):
        d = d.copy()
        count = 0
        graph = OrderedDict()
        for i in range(N):
            graph[i] = []
            d[i, i] = np.inf
            for j in range(i - r, i + r + 1):
                if 0 <= j < N and i != j:
                    graph[i].append(j)
                    d[i, j] = np.inf
                    count += 1
        while count < num:
            ix = int(np.argmin(d))
            i, j = ix // N, ix % N
            if d[i, j] >= thresh:
                break
            graph[i].append(j)
            d[i, j] = np.inf
            count += 1
        return graph

    with mock.patch.object(graph_utils, "compute_distance_matrix_flow", lambda *a, **k: dmat.copy()):
        got = graph_utils.build_frame_graph(np.zeros((N, 7)), np.ones((N, 24, 24)), np.ones((N, 4)),
                                            num=num, thresh=thresh, r=r)
    assert got == oracle(dmat)


def test_neighbourhood_graph_and_keyframes_match_jax():
    for n, r in ((5, 1), (7, 2), (7, 3)):
        for a, b in zip(graph_utils.neighbourhood_graph(n, r), jgraph.neighbourhood_graph(n, r)):
            assert np.array_equal(a, b)
    g = OrderedDict([(0, [1, 2]), (2, [0]), (5, [])])
    assert np.array_equal(graph_utils.keyframe_indicies(g), jgraph.keyframe_indicies(g))


@pytest.mark.parametrize("pool", [0, 3])
def test_synthetic_dataset_clips_bitwise(pool):
    kw = dict(n_frames=3, image_size=(48, 64), seed=9, pool=pool, varied_frac=0.5)
    ours, theirs = SyntheticDataset(**kw).clips(2), JSyntheticDataset(**kw).clips(2)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
