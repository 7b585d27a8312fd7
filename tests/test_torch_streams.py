"""Port parity for the image streams (``data/streams.py``) against the JAX
package's ``data/streams.py`` on the same files written at test time: every
stream and ``*_times`` helper gives the same t (the original frame index,
stride·k), the same images bit for bit, the same intrinsics and depths,
through the native library (the port's build against the JAX package's)
and through the cv2 fallback (``available`` patched false in both
packages); EuRoC in mono and stereo, with a missing right image skipped.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from droid_slam_tpu.data import streams as jstreams
from droid_slam_tpu_torch.data import streams

torch.set_num_threads(2)

BACKENDS = ["native", "cv2"]


def _write_png(path, h, w, seed):
    """A smooth random image (so the bilinear resizes do real work)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 255, (h // 16, w // 16, 3), np.uint8)
    cv2.imwrite(str(path), cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC))


@pytest.fixture
def backend(request, monkeypatch):
    if request.param == "cv2":
        monkeypatch.setattr(streams._nl, "available", lambda: False)
        monkeypatch.setattr(jstreams._nl, "available", lambda: False)
    else:
        assert streams._nl.available() and jstreams._nl.available()
    return request.param


def _same(items, jitems):
    assert len(items) == len(jitems) > 0
    for got, want in zip(items, jitems):
        assert len(got) == len(want)
        assert got[0] == want[0] and type(got[0]) is type(want[0])
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tum")
    (d / "rgb").mkdir()
    base = 1305031102.175304  # epoch seconds, 33 ms apart: one float32 ulp is 128 s
    for k in range(5):
        _write_png(d / "rgb" / f"{base + 0.033 * k:.6f}.png", 480, 640, k)
    return str(d)


@pytest.mark.parametrize("backend", BACKENDS, indirect=True)
@pytest.mark.parametrize("stride", [1, 2])
def test_tum_stream_and_times(tum_dir, backend, stride):
    items = list(streams.tum_stream(tum_dir, stride=stride))
    _same(items, list(jstreams.tum_stream(tum_dir, stride=stride)))
    assert [it[0] for it in items] == list(range(0, 5, stride))
    assert items[0][1].shape == (240, 320, 3)
    times = streams.tum_times(tum_dir, stride=stride)
    assert times.dtype == np.float64 and np.array_equal(times, jstreams.tum_times(tum_dir, stride=stride))
    assert len(times) == len(items)


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("euroc") / "MH_01"
    for cam in ("cam0", "cam1"):
        (d / "mav0" / cam / "data").mkdir(parents=True)
    base_ns = 1403636579763555584
    for k in range(4):
        name = f"{base_ns + k * 50_000_000}.png"
        _write_png(d / "mav0" / "cam0" / "data" / name, 480, 752, k)
        if k != 2:  # frame 2 has no right image: stereo skips it
            _write_png(d / "mav0" / "cam1" / "data" / name, 480, 752, 100 + k)
    return str(d)


@pytest.mark.parametrize("backend", BACKENDS, indirect=True)
@pytest.mark.parametrize("stereo", [False, True])
def test_euroc_stream_and_times(euroc_dir, backend, stereo):
    items = list(streams.euroc_stream(euroc_dir, image_size=(160, 256), stereo=stereo, stride=1))
    _same(items, list(jstreams.euroc_stream(euroc_dir, image_size=(160, 256), stereo=stereo, stride=1)))
    assert [it[0] for it in items] == ([0, 1, 3] if stereo else [0, 1, 2, 3])
    assert items[0][1].shape == ((2, 160, 256, 3) if stereo else (160, 256, 3))
    strided = list(streams.euroc_stream(euroc_dir, stereo=stereo, stride=2))
    _same(strided, list(jstreams.euroc_stream(euroc_dir, stereo=stereo, stride=2)))
    assert [it[0] for it in strided] == [0, 2][: 1 if stereo else 2]
    for stride in (1, 2):
        times = streams.euroc_times(euroc_dir, stride=stride)
        assert np.array_equal(times, jstreams.euroc_times(euroc_dir, stride=stride))
    assert abs(streams.euroc_times(euroc_dir)[0] - 1403636579.763555584) < 1e-6


@pytest.fixture(scope="module")
def eth3d_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("eth3d")
    (d / "rgb").mkdir()
    (d / "depth").mkdir()
    np.savetxt(str(d / "calibration.txt"), [500.0, 498.0, 320.5, 239.5])
    rng = np.random.default_rng(3)
    for k in range(3):
        _write_png(d / "rgb" / f"{1000.0 + 0.1 * k:.4f}.png", 300, 460, k)
        cv2.imwrite(str(d / "depth" / f"{1000.0 + 0.1 * k:.4f}.png"),
                    rng.integers(1000, 30000, (300, 460)).astype(np.uint16))
    return str(d)


@pytest.mark.parametrize("backend", BACKENDS, indirect=True)
@pytest.mark.parametrize("use_depth", [False, True])
def test_eth3d_stream_and_times(eth3d_dir, backend, use_depth):
    items = list(streams.eth3d_stream(eth3d_dir, use_depth=use_depth))
    _same(items, list(jstreams.eth3d_stream(eth3d_dir, use_depth=use_depth)))
    assert all(len(it) == (4 if use_depth else 3) for it in items)
    if use_depth:
        assert items[0][2].shape == items[0][1].shape[:2] and items[0][2].dtype == np.float32
    assert np.array_equal(streams.eth3d_times(eth3d_dir), jstreams.eth3d_times(eth3d_dir))


@pytest.fixture(scope="module")
def tartan_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("tartan")
    (d / "image_left").mkdir()
    (d / "image_right").mkdir()
    for k in range(4):
        _write_png(d / "image_left" / f"{k:06d}_left.png", 120, 160, k)
        _write_png(d / "image_right" / f"{k:06d}_right.png", 120, 160, 50 + k)
    return str(d)


@pytest.mark.parametrize("backend", BACKENDS, indirect=True)
@pytest.mark.parametrize("stereo", [False, True])
def test_tartanair_stream(tartan_scene, backend, stereo):
    items = streams.tartanair_stream(tartan_scene, image_size=(48, 64), stereo=stereo)
    _same(items, jstreams.tartanair_stream(tartan_scene, image_size=(48, 64), stereo=stereo))
    assert items[0][1].shape == ((2, 48, 64, 3) if stereo else (48, 64, 3))
    np.testing.assert_array_equal(items[0][2], 0.8 * np.array([320.0, 320.0, 320.0, 240.0], np.float32))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    (d / "frames").mkdir()
    for k in range(7):
        _write_png(d / "frames" / f"{k:04d}.png", 150, 210, k)
    (d / "plain.txt").write_text("180.0 178.0 105.0 74.0\n")
    (d / "distorted.txt").write_text("180.0 178.0 105.0 74.0 0.05 -0.02 0.001 0.0005\n")
    return d


@pytest.mark.parametrize("backend", BACKENDS, indirect=True)
@pytest.mark.parametrize("calib,stride,area", [("plain.txt", 1, 96 * 128), ("plain.txt", 3, 384 * 512),
                                               ("distorted.txt", 2, 96 * 128)])
def test_image_stream(image_dir, backend, calib, stride, area):
    args = (str(image_dir / "frames"), str(image_dir / calib), stride, area)
    items = list(streams.image_stream(*args))
    _same(items, list(jstreams.image_stream(*args)))
    assert [it[0] for it in items] == list(range(len(range(0, 7, stride))))
    h, w = items[0][1].shape[:2]
    assert h % 8 == 0 and w % 8 == 0


def test_native_and_cv2_paths_agree_on_a_plain_resize(image_dir, monkeypatch):
    """Without distortion both backends decode the same PNG and resize it
    bilinearly: within bilinear rounding of each other."""
    args = (str(image_dir / "frames"), str(image_dir / "plain.txt"), 1, 96 * 128)
    native = list(streams.image_stream(*args))
    monkeypatch.setattr(streams._nl, "available", lambda: False)
    fallback = list(streams.image_stream(*args))
    for (ta, ia, ka), (tb, ib, kb) in zip(native, fallback):
        assert ta == tb and ia.shape == ib.shape
        assert np.array_equal(ka, kb)
        assert np.abs(ia.astype(int) - ib.astype(int)).max() <= 2
