"""Build, load and count the port's hand-written CUDA kernels.

Each kernel has a plain C entry point in a ``csrc/*.cu`` file (one file
may hold several kernels; shared device code lives in ``csrc/*.cuh``). A
source is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``droid_slam_tpu_torch/_build/`` (named by a hash of the source, every
header and the flags, so an edited source or header rebuilds) and loaded
with ``ctypes``. Nothing is built when a module is
imported: the first wrapper call that needs a kernel builds its source,
and :func:`build` builds several at once, one ``nvcc`` process per
source, all started together.

``LAUNCHES`` counts, per kernel, the launches its wrapper made, and
``DTYPE_LAUNCHES`` the same launches by kernel and feature type
(``"corr_level_f32"``, ``"corr_level_bf16"``, ...) where the wrapper names
one: a wrapper launches through :func:`launch`, which adds one per launch
and is the only place that does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int

# kernel name → (source file, C entry point, argtypes)
KERNELS = {
    "corr_level": (
        "corr_level.cu",
        "corr_level_launch",
        [_VOIDP] * 5 + [_INT] * 12 + [_VOIDP],
    ),
    "corr_slab": (
        "corr_split.cu",
        "corr_slab_launch",
        [_VOIDP] * 5 + [_INT] * 12 + [_VOIDP],
    ),
    "corr_window": (
        "corr_split.cu",
        "corr_window_launch",
        [_VOIDP] * 3 + [_INT] * 5 + [_VOIDP],
    ),
    "corr_backward": (
        "corr_backward.cu",
        "corr_backward_launch",
        [_INT] + [_VOIDP] * 9 + [_INT] * 6 + [ctypes.c_longlong, _INT, _VOIDP],
    ),
    # the set kernel of an IF node, captured into a CUDA graph
    # (runtime/graph.py): one launch per node captured
    "graph_cond": (
        "graph_cond.cu",
        "graph_if_begin",
        [_VOIDP] * 3,
    ),
}

# entry points that launch no kernel: source → {entry: argtypes}
HELPERS = {
    "graph_cond.cu": {
        "graph_if_end": [_VOIDP],
        "graph_stream_create": [ctypes.POINTER(_VOIDP)],
        "graph_cond_load": [],
    },
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
DTYPE_LAUNCHES: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    DTYPE_LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    """A copy of the counts so far, by kernel and by kernel and feature
    type in one dict; the difference of two copies counts what ran between
    them without resetting anyone else's counts."""
    return {**LAUNCHES, **DTYPE_LAUNCHES}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches made since ``before`` (a :func:`launch_counts` copy)."""
    now = launch_counts()
    return {k: n - before.get(k, 0) for k, n in now.items() if n - before.get(k, 0)}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    from torch.utils.cpp_extension import CUDA_HOME  # honours $CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")


def _library_path(source: str) -> Path:
    """The library of one source, named by a hash of the source, every
    ``csrc/*.cuh`` header (sorted by name) and the flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile the source of every named kernel whose library is missing,
    all in parallel.

    Returns {source: compiler output} (ptxas register / shared-memory
    report) for the sources compiled by this call. Raises if any compile
    fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in dict.fromkeys(KERNELS[name][0] for name in names):
        lib = _library_path(source)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            lib,
        )
    logs, failed = {}, []
    for source, (proc, tmp, lib) in procs.items():
        logs[source] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(source)
            continue
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(logs[source])
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def sass_counts(names: Iterable[str] = tuple(KERNELS), opcodes=("HMMA", "HGMMA")) -> Dict[str, Dict[str, int]]:
    """{function: {opcode: count}} of the SASS in the built libraries of the
    named kernels (``cuobjdump -sass``, from the toolkit that holds nvcc):
    which functions run on the tensor cores. Builds what is missing."""
    build(names)
    cuobjdump = str(Path(_nvcc()).with_name("cuobjdump"))
    counts: Dict[str, Dict[str, int]] = {}
    for source in dict.fromkeys(KERNELS[name][0] for name in names):
        text = subprocess.run([cuobjdump, "-sass", str(_library_path(source))],
                              capture_output=True, text=True, check=True).stdout
        func = None
        for line in text.splitlines():
            if "Function :" in line:
                func = line.split("Function :", 1)[1].strip()
                counts[func] = {op: 0 for op in opcodes}
            elif func is not None:
                for op in opcodes:
                    if f" {op}." in line or f" {op} " in line:
                        counts[func][op] += 1
    return counts


def library(name: str) -> ctypes.CDLL:
    """The loaded library holding one kernel, built first if needed, with
    the argument types of every entry point it holds declared."""
    source = KERNELS[name][0]
    lib = _LIBS.get(source)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(source)))
        for src, entry, argtypes in KERNELS.values():
            if src == source:
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        for entry, argtypes in HELPERS.get(source, {}).items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib


def launch(name: str, device, *args, dtype: Optional[str] = None) -> None:
    """Call kernel ``name``'s C entry point with ``args`` on the current
    stream of ``device``; raise on a non-zero CUDA error, else count the
    launch (and under ``name_dtype`` when ``dtype`` is given)."""
    import torch

    fn = getattr(library(name), KERNELS[name][1])
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    if dtype is not None:
        key = f"{name}_{dtype}"
        DTYPE_LAUNCHES[key] = DTYPE_LAUNCHES.get(key, 0) + 1
