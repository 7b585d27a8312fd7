"""Port parity for the tools (``droid_slam_tpu_torch/tools/``) other than the
long loop, the probe and the multi-process backend, on the CPU.

* ``eval_sweep``: the shipped weights listed twice × seed 7 at 96×128, 16
  frames, f32. Each row equals the port's ``run_slam`` run directly on the
  same inputs (keyframes, ATE and scale), and holds to the JAX repo's
  ``tools/eval_sweep.py`` row for the same weights and seed (run once: a
  JAX session costs 20-50 s on the CPU): the same keyframes, ATE within
  1e-3.
* ``prime``: without nvcc and CUDA it exits non-zero, names both, and
  builds nothing.
* ``euroc_groundtruth``: the same TUM file as the JAX repo's tool.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.apps import evaluate
from droid_slam_tpu_torch.ops import kernels
from droid_slam_tpu_torch.runtime import DroidConfig
from droid_slam_tpu_torch.tools import euroc_groundtruth, eval_sweep, prime

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SHIPPED = str(REPO / "weights" / "droid_synth.msgpack")


def _jax_tool(name: str, monkeypatch, tmp_path):
    """The JAX repo's ``tools/<name>.py`` as a module (its compile-cache
    default pointed into ``tmp_path``)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_sweep_rows(monkeypatch, tmp_path, capsys):
    out = tmp_path / "port.jsonl"
    with torch.backends.mkldnn.flags(enabled=False):
        rows = eval_sweep.main(["--weights", SHIPPED, SHIPPED, "--seeds", "7", "--frames", "16",
                                "--image_size", "96", "128", "--device", "cpu", "--json", str(out)])
        track, fill, ref = evaluate.synthetic_streams(7, 16, (96, 128))
        config = DroidConfig(image_size=(96, 128), buffer=96, warmup=8, compute_dtype="float32")
        traj, droid, _ = evaluate.run_slam(config, SHIPPED, track, fill, device="cpu")
    direct = evaluate.score(ref, np.arange(16, dtype=np.float64), traj, correct_scale=True)
    assert [json.loads(line) for line in out.read_text().splitlines()] == rows
    assert len(rows) == 2
    for row in rows:
        assert row["weights"] == SHIPPED and row["seed"] == 7 and row["dtype"] == "float32"
        assert row["kf"] == droid.counter
        assert row["ate_rmse"] == direct["ate_rmse"] and row["scale_fit"] == direct["scale"]
        assert row["ate"] == round(direct["ate_rmse"], 4) and row["scale"] == round(float(direct["scale"]), 3)

    jtool = _jax_tool("eval_sweep", monkeypatch, tmp_path)
    jout = tmp_path / "jax.jsonl"
    monkeypatch.setattr(sys, "argv", ["eval_sweep.py", "--weights", SHIPPED, "--seeds", "7",
                                      "--frames", "16", "--image_size", "96", "128", "--json", str(jout)])
    jtool.main()
    (w,) = [json.loads(line) for line in jout.read_text().splitlines()]
    for got in rows:
        assert {k: got[k] for k in ("weights", "seed", "dtype", "kf")} == {k: w[k] for k in
                                                                           ("weights", "seed", "dtype", "kf")}
        assert set(w) <= set(got)
        assert abs(got["ate_rmse"] - w["ate"]) < 1e-3


def test_prime_refuses_without_nvcc_and_cuda(capsys):
    assert not torch.cuda.is_available()
    built = sorted(kernels.BUILD_DIR.glob("*")) if kernels.BUILD_DIR.exists() else []
    assert prime.main([]) == 1
    err = capsys.readouterr().err
    assert "nothing primed" in err and "nvcc not found" in err and "no CUDA device" in err
    assert (sorted(kernels.BUILD_DIR.glob("*")) if kernels.BUILD_DIR.exists() else []) == built
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "droid_slam_tpu_torch.tools.prime"], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode != 0 and "nvcc not found" in proc.stderr and not proc.stdout


def test_euroc_groundtruth_matches_the_jax_tool(monkeypatch, tmp_path):
    rng = np.random.default_rng(0)
    csv = tmp_path / "mav0" / "state_groundtruth_estimate0" / "data.csv"
    csv.parent.mkdir(parents=True)
    q = rng.standard_normal((20, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = np.concatenate([(1403636579763555584 + 5_000_000 * np.arange(20))[:, None].astype(np.float64),
                           rng.standard_normal((20, 3)), q, rng.standard_normal((20, 9))], axis=1)
    lines = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []"]
    lines += [",".join([str(int(r[0]))] + [repr(float(x)) for x in r[1:]]) for r in rows]
    csv.write_text("\n".join(lines) + "\n")

    got = euroc_groundtruth.main([str(tmp_path), str(tmp_path / "port.txt")])
    assert got == str(tmp_path / "port.txt")
    assert euroc_groundtruth.convert(str(csv)) == str(csv.parent / "groundtruth_tum.txt")
    jtool = _jax_tool("euroc_groundtruth", monkeypatch, tmp_path)
    monkeypatch.setattr(sys, "argv", ["euroc_groundtruth.py", str(tmp_path), str(tmp_path / "jax.txt")])
    jtool.main()
    port = (tmp_path / "port.txt").read_text()
    assert port == (tmp_path / "jax.txt").read_text()
    assert port == (csv.parent / "groundtruth_tum.txt").read_text()
    assert len(port.splitlines()) == 20
