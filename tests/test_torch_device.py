"""Port device rules: the port runs on CUDA unless told otherwise, the
kernel wrappers take their plain versions only for CPU tensors, and neither
the package nor chip_smoke.py imports JAX or the JAX package."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.ops import corr, kernels
from droid_slam_tpu_torch.runtime import Droid, DroidConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "optax", "orbax", "chex", "droid_slam_tpu")


def _small_config():
    return DroidConfig(image_size=(64, 64), buffer=8, warmup=4, max_factors=24,
                       inactive_pad=16, window_pad=16, compute_dtype="float32")


def test_droid_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Droid(_small_config())


def test_droid_cpu_tracks_on_request():
    d = Droid(_small_config(), device="cpu")
    img = np.random.default_rng(0).integers(0, 255, (64, 64, 3), np.uint8)
    d.track(0.0, img, intrinsics=np.array([64.0, 64.0, 32.0, 32.0], np.float32))
    assert d.counter == 1
    assert d.poses.device.type == "cpu"
    traj = d.terminate()
    assert traj.shape == (1, 7)
    assert np.isfinite(traj).all()


def test_corr_level_cpu_uses_plain_version_without_launch():
    kernels.reset_launches()
    r = np.random.default_rng(1)
    f1 = torch.from_numpy(r.standard_normal((2, 12, 32)).astype(np.float32))
    f2 = torch.from_numpy(r.standard_normal((2, 3, 4, 32)).astype(np.float32))
    coords = torch.from_numpy((r.random((2, 12, 2)) * 4).astype(np.float32))
    out = corr.corr_level(f1, f2, coords)
    assert torch.equal(out, corr.corr_level_ref(f1, f2, coords))
    assert kernels.LAUNCHES["corr_level"] == 0


def test_corr_level_split_cpu_uses_plain_versions_without_launch():
    kernels.reset_launches()
    r = np.random.default_rng(2)
    f1 = torch.from_numpy(r.standard_normal((2, 12, 32)).astype(np.float32))
    f2 = torch.from_numpy(r.standard_normal((2, 3, 4, 32)).astype(np.float32))
    coords = torch.from_numpy((r.random((2, 12, 2)) * 4).astype(np.float32))
    out = corr.corr_level_split(f1, f2, coords)
    assert torch.equal(out, corr.corr_level_split_ref(f1, f2, coords))
    assert kernels.LAUNCHES["corr_slab"] == 0
    assert kernels.LAUNCHES["corr_window"] == 0


def test_segment_sum_cpu_uses_plain_version_and_no_atomics_elsewhere(monkeypatch):
    """On the CPU segment_sum is index_add_; off the CPU it never reaches
    index_add_ (atomic adds on a CUDA tensor). Meta tensors stand in for
    CUDA ones."""
    from droid_slam_tpu_torch.ops import segment

    r = np.random.default_rng(3)
    idx = torch.from_numpy(r.integers(-1, 6, 40))
    src = torch.from_numpy(r.standard_normal((40, 3, 4)).astype(np.float32))
    assert torch.equal(segment.segment_sum(idx, src, 5), segment.segment_sum_ref(idx, src, 5))

    def no_index_add(*args, **kwargs):
        raise AssertionError("index_add_ off the CPU")

    monkeypatch.setattr(torch.Tensor, "index_add_", no_index_add)
    out = segment.segment_sum(idx.to("meta"), src.to("meta"), 5)
    assert out.shape == (5, 3, 4) and out.dtype == torch.float32


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """An edit to a shared csrc/*.cuh header renames every library, so a
    build cache cannot load code compiled from the old header."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers
    before = {src: kernels._library_path(src) for src, _, _ in kernels.KERNELS.values()}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {src: kernels._library_path(src) for src in before}
    assert all(before[src] != after[src] for src in before)
    assert after == {src: kernels._library_path(src) for src in before}  # stable


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "droid_slam_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(REPO)), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad
