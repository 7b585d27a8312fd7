"""Port parity for the map visualisation and export.

* ``ops/vis_ops.py`` against the JAX package's on one seeded scene (a
  plane seen from 8 keyframes moving sideways, with outlier disparities):
  ``iproj_points`` and ``projmap`` within 1e-5·max(1, max|ref|), the
  ``depth_filter`` counts equal.
* ``utils/visualization.py``: ``filtered_point_cloud`` (points within
  1e-5·max|p|, colours equal), ``camera_frusta``, ``save_ply`` (the same
  file) and ``export_map`` against the JAX package's. The JAX package pads
  the frame count to a multiple of 32 before its consistency count (a
  workaround for its compiler) and then counts the padded frames as
  neighbours; the port counts among the keyframes only, so the scene's
  buffer holds exactly its 8 keyframes, where the two agree.
* The headless ``VisualizerThread`` during tracking and across
  ``terminate`` with either engine (tests/test_runtime.py:96-131 on the
  port), its S/A threshold keys, and ``Droid(visualize=True)``.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.ops import vis_ops as jvis
from droid_slam_tpu.runtime import DroidConfig as JDroidConfig
from droid_slam_tpu.runtime.video import VideoState as JVideoState
from droid_slam_tpu.utils import visualization as jviz
from droid_slam_tpu_torch.ops import vis_ops as tvis
from droid_slam_tpu_torch.runtime import Droid, DroidConfig
from droid_slam_tpu_torch.runtime.video import VideoState
from droid_slam_tpu_torch.utils import visualization as tviz

torch.set_num_threads(2)

T, H, W = 8, 32, 48
h, w = H // 8, W // 8


def _scene(seed: int = 0):
    """Poses [T, 7] (sideways steps with a small seeded jitter), disparities
    [T, h, w] of a plane at depth 2 with 10% outliers, intrinsics [4] and
    images [T, H, W, 3]."""
    r = np.random.default_rng(seed)
    xi = np.zeros((T, 6))
    xi[:, 0] = 0.02 * np.arange(T)
    xi += 0.002 * r.standard_normal((T, 6))
    poses = np.asarray(jlie.exp(jnp.asarray(xi, jnp.float32)))
    disps = 0.5 + 1e-4 * r.standard_normal((T, h, w))
    disps = np.where(r.random((T, h, w)) < 0.1, 1.5, disps).astype(np.float32)
    intr = np.array([w * 0.9, w * 0.9, w / 2, h / 2], np.float32)
    images = r.integers(0, 255, (T, H, W, 3)).astype(np.uint8)
    return poses, disps, intr, images


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() <= rel * max(1.0, np.abs(want).max())


def test_iproj_points_and_projmap_match_jax():
    poses, disps, intr, _ = _scene(1)
    want = jvis.iproj_points(jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr))
    got = tvis.iproj_points(torch.from_numpy(poses), torch.from_numpy(disps), torch.from_numpy(intr))
    assert got.shape == (T, h, w, 3) and _close(got, want)

    ii = np.array([0, 1, 2, 5, 7])
    jj = np.array([1, 0, 4, 5, 3])  # a self edge among them: the stereo baseline
    wc, wv = jvis.projmap(jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr), jnp.asarray(ii),
                          jnp.asarray(jj))
    gc, gv = tvis.projmap(torch.from_numpy(poses), torch.from_numpy(disps), torch.from_numpy(intr),
                          torch.from_numpy(ii), torch.from_numpy(jj))
    assert gc.shape == (5, h, w, 3) and _close(gc, wc)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_depth_filter_counts_match_jax():
    poses, disps, intr, _ = _scene(2)
    inds = np.array([0, 1, 3, 6, 7])
    thresh = np.array([0.005, 0.01, 0.005, 0.02, 0.005], np.float32)
    want = np.asarray(jvis.depth_filter(jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
                                        jnp.asarray(inds), jnp.asarray(thresh)))
    got = tvis.depth_filter(torch.from_numpy(poses), torch.from_numpy(disps), torch.from_numpy(intr),
                            torch.from_numpy(inds), torch.from_numpy(thresh)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 3 and (got == 0).any()  # agreement and disagreement both occur


def _videos(seed: int = 3):
    """A JAX and a port VideoState holding the scene, buffer = counter = T."""
    poses, disps, intr, images = _scene(seed)
    cfg = dict(image_size=(H, W), buffer=T, compute_dtype="float32")
    jv = JVideoState(JDroidConfig(**cfg))
    tv = VideoState(DroidConfig(**cfg), "cpu")
    for name, value in (("poses", poses), ("disps", disps), ("images", images),
                        ("intrinsics", np.tile(intr, (T, 1)))):
        setattr(jv, name, jnp.asarray(value))
        setattr(tv, name, torch.from_numpy(value.copy()))
    jv.counter = tv.counter = T
    return jv, tv


def test_filtered_point_cloud_matches_jax():
    jv, tv = _videos()
    wp, wc = jviz.filtered_point_cloud(jv)
    gp, gc = tviz.filtered_point_cloud(tv)
    assert 0 < len(gp) < T * h * w  # the filter kept some pixels and dropped some
    assert gp.shape == wp.shape and _close(gp, wp)
    np.testing.assert_array_equal(gc, wc)
    points, colors, mask = tviz.consistent_points(tv)
    assert points.shape == colors.shape == (T, h, w, 3) and mask.sum() == len(gp)


def test_camera_frusta_match_jax():
    poses, *_ = _scene(4)
    wp, wl = jviz.camera_frusta(poses)
    gp, gl = tviz.camera_frusta(poses)
    assert gp.dtype == np.float64 and gp.shape == (T * 8, 3) and np.abs(gp - wp).max() < 1e-6
    np.testing.assert_array_equal(gl, wl)
    # identity pose: apex at the origin, image-plane corners at z = 1.5·scale
    pts, lines = tviz.camera_frusta(np.array([[0, 0, 0, 0, 0, 0, 1]], np.float32), scale=0.1)
    assert pts.shape == (8, 3) and lines.shape == (10, 2)
    assert np.allclose(pts[0], 0.0, atol=1e-6) and np.allclose(pts[1:, 2], 0.15, atol=1e-6)


def test_save_ply_and_export_map_match_jax(tmp_path):
    r = np.random.default_rng(5)
    points = (r.standard_normal((7, 3)) * 3).astype(np.float32)
    colors = r.integers(0, 255, (7, 3)).astype(np.uint8)
    for with_colors in (True, False):
        c = colors if with_colors else None
        jviz.save_ply(str(tmp_path / "jax" / "p.ply"), points, c)
        tviz.save_ply(str(tmp_path / "port" / "p.ply"), points, c)
        assert (tmp_path / "port" / "p.ply").read_text() == (tmp_path / "jax" / "p.ply").read_text()

    jv, tv = _videos()
    n_want = jviz.export_map(jv, str(tmp_path / "jax"))
    n_got = tviz.export_map(tv, str(tmp_path / "port"))
    assert n_got == n_want > 0

    def read_ply(path):
        lines = path.read_text().splitlines()
        end = lines.index("end_header")
        return lines[: end + 1], np.loadtxt(lines[end + 1:], ndmin=2)

    want_head, want = read_ply(tmp_path / "jax" / "map.ply")
    got_head, got = read_ply(tmp_path / "port" / "map.ply")
    assert got_head == want_head
    assert _close(got[:, :3], want[:, :3]) and np.array_equal(got[:, 3:], want[:, 3:])
    for name in ("poses_c2w.npy",):
        assert os.path.exists(tmp_path / "port" / name)
        assert _close(np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name), 1e-6)


# tests/test_runtime.py::make_config
RUNTIME_CONFIG = dict(image_size=(64, 64), buffer=32, warmup=4, max_factors=16, inactive_pad=16,
                      window_pad=16, filter_thresh=-1.0, keyframe_thresh=0.0, frontend_window=8,
                      frontend_thresh=1e9, backend_thresh=1e9, compute_dtype="float32")


def _frames(n: int):
    r = np.random.default_rng(5432)
    intr = np.array([64.0, 64.0, 32.0, 32.0], np.float32)
    return [(t, r.integers(0, 255, (64, 64, 3), np.uint8), intr) for t in range(n)]


def _wait_for_update(vis, timeout: float = 30.0):
    deadline = time.time() + timeout
    while vis.updates == 0 and time.time() < deadline:
        time.sleep(0.05)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_visualizer_thread_during_tracking_and_across_terminate(fused):
    d = Droid(DroidConfig(**RUNTIME_CONFIG), device="cpu", fused=fused)
    clouds = []
    vis = tviz.VisualizerThread(d, refresh_hz=20.0, sink=lambda p, c: clouds.append((p, c)))
    try:
        for t, img, intr in _frames(8):
            d.track(t, img, intrinsics=intr)
        _wait_for_update(vis)
    finally:
        vis.close()
    assert vis.updates > 0 and not vis._thread.is_alive()
    points, colors = vis.latest
    assert points.ndim == 2 and points.shape[1] == 3 and colors.shape == points.shape
    assert len(clouds) == vis.updates
    assert vis.latest_frusta[0].shape[0] % 8 == 0 and len(vis.latest_frusta[0]) > 0

    # terminate stops the poller before global BA and then pushes one
    # refresh of the optimised map to the sink
    d.visualizer = vis
    n_before = vis.updates
    traj = d.terminate()
    assert not vis._thread.is_alive()
    assert vis.updates == n_before + 1 and len(clouds) == vis.updates
    assert np.isfinite(traj).all() and traj.shape == (d.counter, 7)
    assert not d.video.dirty[: d.counter].any()  # the final refresh drew every keyframe


def test_visualizer_filter_keys_and_droid_visualize():
    # Droid(visualize=True) starts the thread (headless without open3d);
    # the S/A keys scale the threshold and mark every keyframe dirty
    d = Droid(DroidConfig(**RUNTIME_CONFIG), device="cpu", fused=False, visualize=True)
    vis = d.visualizer
    assert isinstance(vis, tviz.VisualizerThread) and vis._thread.is_alive()
    vis.refresh_hz = 20.0
    for t, img, intr in _frames(5):
        d.track(t, img, intrinsics=intr)
    _wait_for_update(vis)
    assert vis.updates > 0
    assert vis.latest_frusta[0].shape[0] == 8 * d.counter or vis.latest_frusta[0].shape[0] > 0
    t0 = vis.filter_thresh
    vis.scale_filter(2.0)
    assert vis.filter_thresh == 2 * t0 and d.video.dirty[: d.counter].all()
    vis.scale_filter(0.5)
    assert vis.filter_thresh == t0
    d.terminate()
    assert not vis._thread.is_alive()
