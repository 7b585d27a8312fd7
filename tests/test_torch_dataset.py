"""Port parity for the training reader and the file readers, against the JAX
package on the same seeds and files:

* ``data/augmentation.py::RGBDAugmentor`` (no cv2) against the JAX
  augmentor (cv2): the colour within 1e-3 on the 0-255 scale, the crop's
  shape, the intrinsics and the nearest-resized inverse depths exactly, for
  seeds with and without the grayscale draw; the port runs with ``cv2``
  hidden. Its HSV conversions and resizes against cv2 directly.
* ``data/dataset.py::TartanAir`` on a scene written by ``chip_smoke.py``'s
  fixture writer (PNG by zlib): the ``scene_info`` poses exactly, the
  covisibility graphs' neighbour sets equal and their distances within
  1e-4 (relative; the fixture keeps every distance away from the fmin and
  fmax of the clip walk and from max_flow), ``ds[i]`` and ``clips(2)`` with
  one seed against the JAX dataset, with and without augmentation.
* ``eval/ate.py``'s ground-truth loaders and ``data/rgbd_utils.py``'s TUM
  readers on written files.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import chip_smoke
from droid_slam_tpu.data import augmentation as jaug
from droid_slam_tpu.data import dataset as jdataset
from droid_slam_tpu.data import rgbd_utils as jrgbd
from droid_slam_tpu.eval import ate as jate
from droid_slam_tpu_torch.data import augmentation as aug
from droid_slam_tpu_torch.data import dataset
from droid_slam_tpu_torch.data import rgbd_utils
from droid_slam_tpu_torch.data.synthetic import render_sequence
from droid_slam_tpu_torch.eval import ate

torch.set_num_threads(2)

COLOR_TOL = 1e-3  # on the 0-255 scale


# -----------------------------------------------------------------------------
# the augmentor
# -----------------------------------------------------------------------------


def _clip(seed, n=3, h=60, w=80):
    rng = np.random.default_rng(100 + seed)
    images = (rng.random((n, h, w, 3)) * 255).astype(np.float32)
    disps = (0.2 + rng.random((n, h, w))).astype(np.float32)
    poses = rng.standard_normal((n, 7)).astype(np.float32)
    intrinsics = np.tile(np.array([70.0, 71.0, 40.0, 30.0], np.float32), (n, 1))
    return images, poses, disps, intrinsics


# seeds 3 and 5 draw the grayscale conversion; 0, 1, 2 do not
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("crop", [(48, 64), (56, 72)])
def test_augmentor_matches_jax(seed, crop, monkeypatch):
    images, poses, disps, intrinsics = _clip(seed)
    want = jaug.RGBDAugmentor(crop_size=crop, seed=seed)(images.copy(), poses, disps, intrinsics)
    monkeypatch.setitem(sys.modules, "cv2", None)  # the port's augmentor needs no cv2
    got = aug.RGBDAugmentor(crop_size=crop, seed=seed)(images.copy(), poses, disps, intrinsics)
    g_img, g_pose, g_disp, g_intr = got
    w_img, w_pose, w_disp, w_intr = want
    assert g_img.shape == w_img.shape == (3, *crop, 3) and g_img.dtype == np.float32
    assert np.abs(g_img - w_img).max() <= COLOR_TOL
    assert np.array_equal(g_pose, w_pose)
    assert g_disp.dtype == w_disp.dtype and np.array_equal(g_disp, w_disp)
    assert g_intr.dtype == w_intr.dtype and np.array_equal(g_intr, w_intr)
    if seed in (3, 5):
        assert np.array_equal(g_img[..., 0], g_img[..., 1])


def test_hsv_conversions_match_cv2():
    rng = np.random.default_rng(0)
    x = rng.random((40, 50, 3)).astype(np.float32)
    x[:4] = 0.5  # gray: S = 0, H = 0
    x[4:8, :, 1] = x[4:8, :, 0]  # ties of the largest channel
    x[8:10] = 0.0
    hsv = aug.rgb_to_hsv(x)
    want = cv2.cvtColor(x, cv2.COLOR_RGB2HSV)
    assert np.abs(hsv[..., 0] - want[..., 0]).max() <= 1e-4  # degrees
    assert np.abs(hsv[..., 1:] - want[..., 1:]).max() <= 1e-6
    assert hsv[..., 0].min() >= 0 and hsv[..., 0].max() < 360
    for shift in (0.0, 47.3, 359.9):
        h = want.copy()
        h[..., 0] = (h[..., 0] + shift) % 360.0
        assert np.abs(aug.hsv_to_rgb(h) - cv2.cvtColor(h, cv2.COLOR_HSV2RGB)).max() <= 1e-6


@pytest.mark.parametrize("size", [(48, 64), (50, 67), (57, 76), (71, 95), (40, 53), (1, 1)])
def test_resizes_match_cv2(size):
    """INTER_LINEAR within a few float32 ulps on the 0-255 scale, INTER_NEAREST
    exact, over the augmentor's scale range (about 0.8-1.19)."""
    rng = np.random.default_rng(1)
    img = (rng.random((60, 80, 3)) * 255).astype(np.float32)
    h, w = size
    want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    assert np.abs(aug.resize_linear(img, size) - want).max() <= 1e-4
    d = rng.random((60, 80)).astype(np.float32)
    assert np.array_equal(aug.resize_nearest(d, size), cv2.resize(d, (w, h), interpolation=cv2.INTER_NEAREST))


# -----------------------------------------------------------------------------
# TartanAir
# -----------------------------------------------------------------------------

SIZE, FOCAL, FRAMES = (96, 128), 64.0, 14
FMIN, FMAX = 8.0, 75.0  # the reader's defaults


@pytest.fixture(scope="module")
def tartan(tmp_path_factory):
    root = tmp_path_factory.mktemp("files")
    fx = chip_smoke.write_file_fixtures(np, render_sequence, root, 0, SIZE, FRAMES, FOCAL)
    return fx


def _pair(tartan, tmp_path, **kw):
    args = dict(datapath=str(tartan["tartan_root"]), n_frames=4, **kw)
    ds = dataset.TartanAir(cache_dir=str(tmp_path / "port"), **args)
    jds = jdataset.TartanAir(cache_dir=str(tmp_path / "jax"), **args)
    return ds, jds


def test_fixture_pngs_decode_to_the_rendered_frames(tartan):
    """chip_smoke.py's zlib PNG writer: cv2 and the native decoder read
    back the rendered frames exactly."""
    from droid_slam_tpu_torch.data import native_loader

    for k in (0, FRAMES - 1):
        path = tartan["scene"] / "image_left" / f"{k:06d}_left.png"
        assert np.array_equal(cv2.imread(str(path))[..., ::-1], tartan["seq"]["images"][k])
        assert np.array_equal(native_loader.imread(str(path)), tartan["seq"]["images"][k])
        assert np.array_equal(np.load(path.with_suffix(".npy")), tartan["seq"]["images"][k])
    assert sorted(p.name for p in tartan["imagedir"].iterdir())[0] == "000000.png"


def test_tartanair_scene_info_and_graph(tartan, tmp_path):
    ds, jds = _pair(tartan, tmp_path, do_aug=False)
    scene = str(tartan["scene"])
    info, jinfo = ds.scene_info[scene], jds.scene_info[scene]
    assert info["images"] == jinfo["images"] and info["depths"] == jinfo["depths"]
    assert np.array_equal(info["poses"], jinfo["poses"])
    # the poses are the rendered camera-to-world ones again (NED order and
    # the depth scale undone)
    np.testing.assert_allclose(info["poses"], tartan["seq"]["poses"], atol=1e-6)
    np.testing.assert_array_equal(np.asarray(info["intrinsics"]), np.asarray(jinfo["intrinsics"]))
    graph, jgraph = info["graph"], jinfo["graph"]
    assert list(graph) == list(jgraph)
    walk = 0
    for i in graph:
        assert np.array_equal(graph[i][0], jgraph[i][0])
        np.testing.assert_allclose(graph[i][1], jgraph[i][1], rtol=1e-4, atol=1e-4)
        d = jgraph[i][1]
        # no distance near the walk's bounds: one ulp there would change a draw
        assert np.abs(d - FMIN).min() > 1e-2 and np.abs(d - FMAX).min() > 1e-2
        walk += int(((d > FMIN) & (d < FMAX)).sum())
    assert walk > FRAMES  # the walk has forward frames to choose from
    assert ds.dataset_index == jds.dataset_index and len(ds) >= 4


@pytest.mark.parametrize("do_aug", [False, True])
def test_tartanair_items_and_clips(tartan, tmp_path, do_aug):
    kw = dict(do_aug=do_aug, crop_size=(64, 96), seed=3)
    ds, jds = _pair(tartan, tmp_path, **kw)
    for i in (0, len(ds) - 1):
        got, want = ds[i], jds[i]
        for k, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape and a.dtype == b.dtype
            if k == 0 and do_aug:
                assert np.abs(a - b).max() <= COLOR_TOL
            else:
                assert np.array_equal(a, b), k
    clips, jclips = ds.clips(2), jds.clips(2)
    for _ in range(2):
        got, want = next(clips), next(jclips)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].shape == want[k].shape
            if k == "images" and do_aug:
                assert np.abs(got[k] - want[k]).max() <= COLOR_TOL
            else:
                assert np.array_equal(got[k], want[k]), k
    assert got["images"].shape == ((2, 4, 64, 96, 3) if do_aug else (2, 4, *SIZE, 3))


def test_tartanair_cache_and_factory(tartan, tmp_path):
    ds = dataset.dataset_factory(["tartan"], datapath=str(tartan["tartan_root"]), n_frames=4, do_aug=False,
                                 cache_dir=str(tmp_path))
    assert isinstance(ds, dataset.TartanAir)
    (cached,) = list(tmp_path.glob("TartanAir-*.pickle"))
    mtime = cached.stat().st_mtime_ns
    again = dataset.TartanAir(datapath=str(tartan["tartan_root"]), n_frames=4, do_aug=False,
                              cache_dir=str(tmp_path))
    assert cached.stat().st_mtime_ns == mtime and again.dataset_index == ds.dataset_index
    # another root gets its own pickle, not this one's graphs
    other = tmp_path / "other"
    other.mkdir()
    empty = dataset.TartanAir(datapath=str(other), n_frames=4, do_aug=False, cache_dir=str(tmp_path))
    assert len(empty) == 0 and len(list(tmp_path.glob("TartanAir-*.pickle"))) == 2
    assert dataset.TARTAN_TEST_SCENES == jdataset.TARTAN_TEST_SCENES
    assert dataset.TartanAir.is_test_scene("x/" + dataset.TARTAN_TEST_SCENES[0])
    with pytest.raises(ValueError):
        dataset.dataset_factory(["kitti"], datapath=str(other))
    with pytest.raises(ValueError, match="batch"):
        next(empty.clips(2))


def test_default_cache_dir_is_gitignored():
    ignored = (Path(__file__).resolve().parent.parent / ".gitignore").read_text().split()
    assert "droid_slam_tpu_torch/data/cache/" in ignored
    assert Path(dataset.DEFAULT_CACHE_DIR) == Path(dataset.__file__).parent / "cache"


# -----------------------------------------------------------------------------
# the file readers
# -----------------------------------------------------------------------------


def _same_traj(a, b):
    for k in ("tstamps", "positions", "quats"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_ate_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    tum = tmp_path / "gt.txt"
    rows = np.concatenate([1305031100.0 + 0.1 * np.arange(9)[:, None], rng.standard_normal((9, 7))], 1)
    tum.write_text("# timestamp tx ty tz qx qy qz qw\n" + "\n".join(" ".join(f"{x:.9f}" for x in r) for r in rows))
    _same_traj(ate.Trajectory.load_tum(str(tum)), jate.Trajectory.load_tum(str(tum)))
    _same_traj(ate.Trajectory.load(str(tum)), jate.Trajectory.load(str(tum)))
    pose_left = tmp_path / "pose_left.txt"
    np.savetxt(pose_left, rng.standard_normal((6, 7)), delimiter=" ")
    t = ate.Trajectory.load_tartanair(str(pose_left))
    _same_traj(t, jate.Trajectory.load_tartanair(str(pose_left)))
    assert np.array_equal(t.tstamps, np.arange(6.0))
    csv = tmp_path / "data.csv"
    data = np.concatenate([1403636579763555584 + 5e6 * np.arange(5)[:, None], rng.standard_normal((5, 16))], 1)
    csv.write_text("#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z, ...\n"
                   + "\n".join(",".join(repr(float(x)) for x in r) for r in data))
    e = ate.Trajectory.load(str(csv))
    _same_traj(e, jate.Trajectory.load_euroc_csv(str(csv)))
    assert np.array_equal(e.quats, data[:, [5, 6, 7, 4]])
    out = tmp_path / "est.txt"
    e.save_tum(str(out))
    _same_traj(ate.Trajectory.load_tum(str(out)), jate.Trajectory.load_tum(str(out)))


def test_rgbd_readers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    ti, td, tp = (np.sort(rng.random(n)) * 10 for n in (40, 37, 55))
    for args in ((ti, td, tp), (ti, td)):
        assert rgbd_utils.associate_frames(*args, max_dt=0.08) == jrgbd.associate_frames(*args, max_dt=0.08)
    # a TUM-format sequence
    stamps = 1305031100.0 + 0.033 * np.arange(30)
    (tmp_path / "rgb.txt").write_text("\n".join(f"{t:.6f} rgb/{t:.6f}.png" for t in stamps))
    (tmp_path / "depth.txt").write_text("\n".join(f"{t + 0.004:.6f} depth/{t:.6f}.png" for t in stamps[::2]))
    gt = np.concatenate([stamps[:, None] + 0.002, rng.standard_normal((30, 7))], 1)
    (tmp_path / "groundtruth.txt").write_text("# t tx ty tz qx qy qz qw\n"
                                              + "\n".join(" ".join(f"{x:.6f}" for x in r) for r in gt))
    np.savetxt(tmp_path / "calibration.txt", [[525.0, 525.0, 319.5, 239.5]], delimiter=" ")
    got, want = rgbd_utils.loadtum(str(tmp_path)), jrgbd.loadtum(str(tmp_path))
    assert got[0] == want[0] and got[1] == want[1] and len(got[0]) == 6
    for a, b in zip(got[2:], want[2:]):
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert rgbd_utils.loadtum(str(tmp_path / "missing")) == (None,) * 5
    assert np.array_equal(rgbd_utils.parse_list(str(tmp_path / "rgb.txt")), jrgbd.parse_list(str(tmp_path / "rgb.txt")))
    pose = np.eye(4)
    pose[:3, :3] = cv2.Rodrigues(np.array([0.1, -0.2, 0.3]))[0]
    pose[:3, 3] = [1.0, 2.0, 3.0]
    assert np.array_equal(rgbd_utils.pose_matrix_to_quaternion(pose), jrgbd.pose_matrix_to_quaternion(pose))
