"""Port parity for the native host loader (``data/native_loader.py``): the
port's ctypes wrapper over ``native/droid_native.cc``, built by the port
into ``droid_slam_tpu_torch/_build/``, against the JAX package's wrapper
over the same source (built by ``make -C native``).

* The port's library lands in ``_build/``, named by a hash of the source
  and the flags, and the port's wrapper never builds into ``native/``.
* PNG, JPEG and 16-bit depth PNG decode, ``resize``, ``resize_nearest``,
  ``remap``, ``undistort`` and ``build_undistort_rectify_map`` give the JAX
  wrapper's results bit for bit on the same files and arrays.
* ``Pipeline`` yields its frames in order, resized as ``resize`` does, and
  skips frames that do not decode (``tests/test_native_loader.py:93-199``).
* A failed build (the source pointed at a header that does not exist)
  leaves ``available()`` false and the compiler's error in
  ``build_error()``.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from droid_slam_tpu.data import native_loader as jnl
from droid_slam_tpu_torch.data import native_loader as nl

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _smooth_image(rng, h, w):
    """A low-frequency random RGB image (JPEG stays close to it)."""
    small = rng.integers(0, 255, (h // 8, w // 8, 3), np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(5432)
    img = _smooth_image(rng, 48, 64)
    cv2.imwrite(str(d / "x.png"), img[..., ::-1])
    cv2.imwrite(str(d / "x.jpg"), img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
    depth = rng.integers(0, 60000, (40, 52), np.uint16)
    cv2.imwrite(str(d / "d.png"), depth)
    return d, img, depth


def test_port_builds_into_its_own_build_dir():
    assert nl.available(), nl.build_error()
    lib = nl.library_path()
    assert lib.exists()
    assert lib.parent == nl.BUILD_DIR
    assert nl.BUILD_DIR == REPO / "droid_slam_tpu_torch" / "_build"
    assert nl.SOURCE == REPO / "native" / "droid_native.cc"
    assert nl.build_error() is None
    assert nl.decoder_headers() == {"png.h": True, "jpeglib.h": True}


def test_decode_matches_jax_wrapper(files):
    d, img, depth = files
    assert jnl.available()
    png = nl.imread(str(d / "x.png"))
    assert np.array_equal(png, img) and png.flags.writeable
    assert np.array_equal(png, jnl.imread(str(d / "x.png")))
    jpg = nl.imread(str(d / "x.jpg"))
    assert jpg.shape == img.shape and np.array_equal(jpg, jnl.imread(str(d / "x.jpg")))
    d16 = nl.imread(str(d / "d.png"))
    assert d16.dtype == np.uint16 and np.array_equal(d16, depth)
    assert np.array_equal(d16, jnl.imread(str(d / "d.png")))
    assert nl.imread(str(d / "missing.png")) is None


@pytest.mark.parametrize("size", [(30, 40), (61, 83), (48, 64)])
def test_resizes_match_jax_wrapper(files, size):
    _, img, _ = files
    assert np.array_equal(nl.resize(img, size), jnl.resize(img, size))
    depth = np.random.default_rng(1).random((48, 64)).astype(np.float32)
    assert np.array_equal(nl.resize_nearest(depth, size), jnl.resize_nearest(depth, size))


def test_maps_remap_and_undistort_match_jax_wrapper(files):
    _, img, _ = files
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    dist = [0.1, -0.05, 0.001, -0.002, 0.01]
    R = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
    P = np.array([[45.0, 0, 30.0], [0, 45.0, 25.0], [0, 0, 1]])
    for kw in ({}, {"R": R, "P": P}):
        got = nl.build_undistort_rectify_map(K, dist, (64, 48), **kw)
        want = jnl.build_undistort_rectify_map(K, dist, (64, 48), **kw)
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and np.array_equal(a, b)
        assert np.array_equal(nl.remap(img, *got), jnl.remap(img, *want))
    assert np.array_equal(nl.undistort(img, K, dist), jnl.undistort(img, K, dist))
    # the rectify map is cv2.initUndistortRectifyMap's formula
    mx_cv, my_cv = cv2.initUndistortRectifyMap(K, np.asarray(dist), R, P, (64, 48), cv2.CV_32FC1)
    mx, my = nl.build_undistort_rectify_map(K, dist, (64, 48), R=R, P=P)
    assert np.abs(mx - mx_cv).max() < 1e-2 and np.abs(my - my_cv).max() < 1e-2


def test_pipeline_order_resize_crop_and_corrupt_frames(tmp_path):
    rng = np.random.default_rng(7)
    paths, imgs = [], []
    for i in range(10):
        p = tmp_path / f"{i:03d}.png"
        if i in (3, 7):
            p.write_bytes(b"\x89PNG\r\n\x1a\ngarbage")
        else:
            img = _smooth_image(rng, 40, 48)
            cv2.imwrite(str(p), img[..., ::-1])
            imgs.append(img)
        paths.append(str(p))
    pipe = nl.Pipeline(paths, resize_hw=(24, 32), crop=(2, 4, 2, 4), n_threads=3, window=4)
    outs = list(pipe)
    pipe.close()
    assert len(outs) == len(imgs) == 8
    for img, out in zip(imgs, outs):
        assert np.array_equal(out, nl.resize(img, (24, 32))[2:-2, 4:-4])
    jouts = list(jnl.Pipeline(paths, resize_hw=(24, 32), crop=(2, 4, 2, 4), n_threads=2, window=4))
    assert all(np.array_equal(a, b) for a, b in zip(outs, jouts))


def test_corrupt_files_return_none(tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0garbage-not-a-jpeg")
    assert nl.imread(str(bad)) is None
    bad_png = tmp_path / "bad.png"
    bad_png.write_bytes(b"\x89PNG\r\n\x1a\ngarbage")
    assert nl.imread(str(bad_png)) is None


def test_failed_build_records_the_compiler_error(tmp_path):
    """A source that includes a missing header: no library, available()
    false, the compiler's message in build_error(); the port's own library
    loads again after the source is restored."""
    src = nl.SOURCE.read_text().replace("#include <png.h>", "#include <no_such_decoder_header.h>")
    bad = tmp_path / "droid_native.cc"
    bad.write_text(src)
    saved = nl.SOURCE, nl.BUILD_DIR
    try:
        nl.SOURCE, nl.BUILD_DIR = bad, tmp_path / "_build"
        nl.reset()
        assert not nl.available()
        err = nl.build_error()
        assert err and "no_such_decoder_header.h" in err
        assert nl.imread(str(tmp_path / "x.png")) is None
        with pytest.raises(RuntimeError, match="no_such_decoder_header"):
            nl.resize(np.zeros((4, 4, 3), np.uint8), (2, 2))
        assert not list((tmp_path / "_build").glob("*.so"))
    finally:
        nl.SOURCE, nl.BUILD_DIR = saved
        nl.reset()
    assert nl.available() and nl.build_error() is None


def test_data_layer_and_apps_import_no_cv2():
    """Importing the port's data layer imports no cv2."""
    import subprocess
    import sys

    code = ("import sys; import droid_slam_tpu_torch.data.streams, droid_slam_tpu_torch.data.dataset, "
            "droid_slam_tpu_torch.data.augmentation, droid_slam_tpu_torch.apps.demo, "
            "droid_slam_tpu_torch.apps.evaluate, droid_slam_tpu_torch.apps.train; print('cv2' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
