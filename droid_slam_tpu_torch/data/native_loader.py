"""ctypes bindings for the native host data pipeline (``native/droid_native.cc``).

The port's counterpart of the JAX package's ``data/native_loader.py``. The
C++ library decodes images (libjpeg, libpng), remaps them bilinearly by
precomputed float maps (undistortion, stereo rectification), resizes them,
and runs a multithreaded prefetch pipeline that yields the frames in
order. It is the host side of the streams and the training reader; nothing
here touches the GPU.

The library is built from ``native/droid_native.cc`` with ``g++`` at first
use (never at import) into the port's gitignored ``_build/`` directory,
named by a hash of the source and the flags, as ``ops/kernels.py`` builds
the CUDA kernels. A failed build leaves the compiler's output in
:func:`build_error`, and :func:`available` turns false: the streams then
decode with ``cv2`` (imported only there). :func:`decoder_headers` says
whether the compiler finds ``png.h`` and ``jpeglib.h``, without building.

The undistort and rectify maps are numpy (``build_undistort_rectify_map``,
the formula of ``cv2.initUndistortRectifyMap``): they are computed once per
stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "droid_native.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
LIBS = ["-ljpeg", "-lpng", "-lz", "-lpthread"]
HEADERS = ("png.h", "jpeglib.h")
BUILD_TIMEOUT_S = 300

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


class _DNImage(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("h", ctypes.c_int32),
        ("w", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bytes_per_channel", ctypes.c_int32),
    ]


_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def _cxx() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path() -> Path:
    """The library of the current source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"droid_native-{digest.hexdigest()[:16]}.so"


def decoder_headers() -> Dict[str, bool]:
    """{header: found} for ``png.h`` and ``jpeglib.h`` on the C++ compiler's
    include path (a preprocessor run; nothing is built). All false without
    a compiler."""
    cxx = _cxx()
    found = {}
    for header in HEADERS:
        ok = False
        if cxx is not None:
            proc = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                                  input=f"#include <{header}>\n", capture_output=True, text=True,
                                  timeout=60)
            ok = proc.returncode == 0
        found[header] = ok
    return found


def _build() -> Path:
    """Compile SOURCE into BUILD_DIR unless its library exists; raises with
    the compiler's output on a failure."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError(f"no C++ compiler: {os.environ.get('CXX', 'g++')} is not on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, lib)  # atomic: concurrent builds each write their own tmp
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dn_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(_DNImage)]
    lib.dn_decode.restype = ctypes.c_int
    lib.dn_free.argtypes = [ctypes.c_void_p]
    lib.dn_remap_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _F32P, _F32P, _U8P, ctypes.c_int, ctypes.c_int]
    lib.dn_resize_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int]
    lib.dn_resize_nearest_f32.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, _F32P, ctypes.c_int, ctypes.c_int]
    lib.dn_pipeline_create.argtypes = [ctypes.c_char_p, ctypes.c_int, _F32P, _F32P] + [ctypes.c_int] * 10
    lib.dn_pipeline_create.restype = ctypes.c_void_p
    lib.dn_pipeline_peek.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.dn_pipeline_peek.restype = ctypes.c_int
    lib.dn_pipeline_pop.argtypes = [ctypes.c_void_p, _U8P]
    lib.dn_pipeline_pop.restype = ctypes.c_int
    lib.dn_pipeline_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None (with the reason in
    :func:`build_error`) if it does not build or load. Tried once per
    process, until :func:`reset`."""
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        _lib = _declare(ctypes.CDLL(str(_build())))
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        _error = str(e)
    return _lib


def reset() -> None:
    """Forget the loaded library and the last build error, so that the next
    call builds or loads again (after SOURCE or BUILD_DIR changed)."""
    global _lib, _tried, _error
    _lib, _tried, _error = None, False, None


def build_error() -> Optional[str]:
    """Why the library is unavailable: the compiler's output of the failed
    build, or the loader's error; None if it loaded or was not tried."""
    return _error


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {build_error()}")
    return lib


def imread(path: str) -> Optional[np.ndarray]:
    """Decode an image: u8 RGB [H, W, 3], or u16 [H, W] for a 16-bit depth
    PNG; None if the file does not decode or the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    img = _DNImage()
    if lib.dn_decode(path.encode(), ctypes.byref(img)) != 0:
        return None
    n = img.h * img.w * img.channels * img.bytes_per_channel
    out = np.empty(n, np.uint8)  # a writable copy, as cv2's arrays are
    ctypes.memmove(out.ctypes.data, img.data, n)
    lib.dn_free(img.data)
    if img.bytes_per_channel == 2:
        return out.view(np.uint16).reshape(img.h, img.w)
    return out.reshape(img.h, img.w, img.channels)


def remap(image: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """Bilinear remap of u8 RGB by float32 coordinate maps (zero border)."""
    lib = _require()
    image = np.ascontiguousarray(image, np.uint8)
    mapx = np.ascontiguousarray(mapx, np.float32)
    mapy = np.ascontiguousarray(mapy, np.float32)
    dh, dw = mapx.shape
    out = np.empty((dh, dw, 3), np.uint8)
    lib.dn_remap_u8(image.ctypes.data_as(_U8P), image.shape[0], image.shape[1], mapx.ctypes.data_as(_F32P),
                    mapy.ctypes.data_as(_F32P), out.ctypes.data_as(_U8P), dh, dw)
    return out


def resize(image: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of u8 RGB to (H, W)."""
    lib = _require()
    image = np.ascontiguousarray(image, np.uint8)
    dh, dw = size_hw
    out = np.empty((dh, dw, 3), np.uint8)
    lib.dn_resize_u8(image.ctypes.data_as(_U8P), image.shape[0], image.shape[1], out.ctypes.data_as(_U8P), dh, dw)
    return out


def resize_nearest(depth: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize of a float32 depth map to (H, W)."""
    lib = _require()
    depth = np.ascontiguousarray(depth, np.float32)
    dh, dw = size_hw
    out = np.empty((dh, dw), np.float32)
    lib.dn_resize_nearest_f32(depth.ctypes.data_as(_F32P), depth.shape[0], depth.shape[1],
                              out.ctypes.data_as(_F32P), dh, dw)
    return out


def build_undistort_rectify_map(
    K: np.ndarray,
    dist: Sequence[float],
    size_wh: Tuple[int, int],
    R: Optional[np.ndarray] = None,
    P: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.initUndistortRectifyMap`` in numpy: each rectified output pixel
    is unprojected with P, rotated by R⁻¹, distorted (k1 k2 p1 p2 k3) and
    projected with K → float32 source-coordinate maps [h, w]."""
    w, h = size_wh
    K = np.asarray(K, np.float64).reshape(3, 3)
    d = np.zeros(5)
    d[: len(dist)] = dist
    k1, k2, p1, p2, k3 = d
    Pm = K if P is None else np.asarray(P, np.float64).reshape(3, 3)
    Rm = np.eye(3) if R is None else np.asarray(R, np.float64).reshape(3, 3)

    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (xs - Pm[0, 2]) / Pm[0, 0]
    y = (ys - Pm[1, 2]) / Pm[1, 1]
    pts = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.linalg.inv(Rm).T
    x = pts[..., 0] / pts[..., 2]
    y = pts[..., 1] / pts[..., 2]

    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y

    mapx = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    mapy = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return mapx, mapy


def undistort(image: np.ndarray, K: np.ndarray, dist: Sequence[float]) -> np.ndarray:
    """``cv2.undistort``'s counterpart: a remap with no rectification (the
    border is zero, where cv2 replicates)."""
    h, w = image.shape[:2]
    mapx, mapy = build_undistort_rectify_map(K, dist, (w, h))
    return remap(image, mapx, mapy)


class Pipeline:
    """Multithreaded prefetch, decode → [remap] → [resize] → [crop]: yields
    the u8 RGB frames in the order of ``paths`` while C++ workers run up to
    ``window`` frames ahead; a frame that does not decode is skipped.
    ``crop`` is (top, left, bottom, right)."""

    def __init__(
        self,
        paths: List[str],
        maps: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        resize_hw: Optional[Tuple[int, int]] = None,
        crop: Tuple[int, int, int, int] = (0, 0, 0, 0),
        n_threads: int = 4,
        window: int = 32,
    ):
        self._handle = None
        self._lib = _require()
        if maps is not None:
            self._mapx = np.ascontiguousarray(maps[0], np.float32)
            self._mapy = np.ascontiguousarray(maps[1], np.float32)
            mx, my = self._mapx.ctypes.data_as(_F32P), self._mapy.ctypes.data_as(_F32P)
            rh, rw = self._mapx.shape
        else:
            mx = my = ctypes.cast(None, _F32P)
            rh = rw = 0
        oh, ow = resize_hw if resize_hw else (0, 0)
        self._n = len(paths)
        self._handle = self._lib.dn_pipeline_create("\n".join(paths).encode(), self._n, mx, my, rh, rw, oh, ow,
                                                    *crop, n_threads, window)

    def __iter__(self) -> Iterator[np.ndarray]:
        h, w = ctypes.c_int(), ctypes.c_int()
        for _ in range(self._n):
            status = self._lib.dn_pipeline_peek(self._handle, ctypes.byref(h), ctypes.byref(w))
            if status == -2:
                return
            if status == -1:  # did not decode: drop it, keep the order
                self._lib.dn_pipeline_pop(self._handle, ctypes.cast(None, _U8P))
                continue
            out = np.empty((h.value, w.value, 3), np.uint8)
            self._lib.dn_pipeline_pop(self._handle, out.ctypes.data_as(_U8P))
            yield out

    def close(self) -> None:
        if self._handle:
            self._lib.dn_pipeline_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
