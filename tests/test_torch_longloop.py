"""Port parity for the long loop session (``droid_slam_tpu_torch/tools/longloop.py``).

The 240-frame courtyard loop is rendered at 96×128 (its per-frame motion
depends on the frame count, as tests/test_longloop.py notes), and its first
20 frames go through the port's ``run_sequence`` and through the JAX
package's fused ``Droid`` with the JAX tool's steps (track every frame,
sync, the keyframe ATE, ``warm_terminate`` at the tracked keyframe count,
``terminate`` with every frame as the fill stream, the scale-corrected ATE
with ``max_dt`` 0.25), both in f32 with the shipped weights and the JAX
tool's config (buffer = frames + 24, warmup 8). Gates: the same keyframe
timestamps after every frame; poses within 5e-3 and disparities within
1e-2 after tracking (tests/test_engine_equivalence.py's bounds); the
filled trajectory within 5e-3 (tests/test_torch_terminate.py's); the row's
ATEs within 1e-3. The port's convolutions take PyTorch's native path
(oneDNN off), as in tests/test_torch_trained.py.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import torch

from droid_slam_tpu.data.synthetic import render_loop_sequence as jrender_loop_sequence
from droid_slam_tpu.eval.ate import Trajectory as JTrajectory
from droid_slam_tpu.eval.ate import ate_rmse as jate_rmse
from droid_slam_tpu.ops import lie as jlie
from droid_slam_tpu.runtime import Droid as JDroid
from droid_slam_tpu.runtime import DroidConfig as JDroidConfig
from droid_slam_tpu_torch.data.synthetic import render_loop_sequence
from droid_slam_tpu_torch.runtime import DroidConfig
from droid_slam_tpu_torch.tools import longloop

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "weights", "droid_synth.msgpack")
SIZE = (96, 128)
K = 20  # frames taken from the 240-frame render
# the JAX tool's config for K frames
CONFIG = dict(image_size=SIZE, buffer=K + 24, warmup=8, compute_dtype="float32")

# the JAX tool's row (tools/longloop.py:103-116) less the seed, which run() adds
JAX_ROW_KEYS = {"frames", "image_size", "compute_dtype", "keyframes", "track_s", "track_fps", "terminate_s",
                "ate_rmse", "scale", "ate_kf_pre_terminate", "scale_kf_pre_terminate"}


@functools.lru_cache(maxsize=None)
def _render():
    return render_loop_sequence(np.random.default_rng(7), n_frames=240, image_size=SIZE)


def _traj(ts, poses):
    return JTrajectory(np.asarray(ts, np.float64), np.asarray(poses[:, :3], np.float64),
                       np.asarray(poses[:, 3:], np.float64))


@functools.lru_cache(maxsize=None)
def _run():
    seq = {k: v[:K] for k, v in _render().items()}
    stream = [(k, seq["images"][k], seq["intrinsics"][k]) for k in range(K)]
    ref = _traj(np.arange(K), seq["poses"])

    # the JAX tool's steps with the JAX package's Droid
    jd = JDroid(JDroidConfig(**CONFIG), weights=SHIPPED)
    hist = []
    for k in range(K):
        jd.track(k, jnp.asarray(seq["images"][k]), intrinsics=jnp.asarray(seq["intrinsics"][k]))
        st = jd._fused_state
        hist.append([float(x) for x in np.asarray(st.tstamp[: int(st.counter)])])
    jd.sync()
    kf = int(jd._fused_state.counter)
    jd._sync_fused_state()
    v = jd.video
    est = np.asarray(jlie.inv(v.poses[:kf]))
    pre = jate_rmse(ref, _traj(np.asarray(v.tstamp[:kf]), est), correct_scale=True, max_dt=0.25)
    want = dict(hist=hist, poses=np.asarray(v.poses[:kf]), disps=np.asarray(v.disps[:kf]), pre=pre)
    jd.warm_terminate(expected_keyframes=kf)
    want["traj"] = np.asarray(jd.terminate(iter(stream)))
    want["post"] = jate_rmse(ref, _traj(np.arange(K), want["traj"]), correct_scale=True, max_dt=0.25)
    want["keyframes"] = int(jd.video.counter)

    got = dict(hist=[])

    def on_frame(k, droid):
        got["hist"].append(droid.tstamps.tolist())
        if k == K - 1:
            got["poses"], got["disps"] = droid.poses.clone().numpy(), droid.disps.clone().numpy()

    with torch.backends.mkldnn.flags(enabled=False):
        got["row"], got["traj"] = longloop.run_sequence(seq, DroidConfig(**CONFIG), weights=SHIPPED,
                                                        device="cpu", on_frame=on_frame)
    return want, got


def test_loop_render_is_the_jax_render():
    want = jrender_loop_sequence(np.random.default_rng(7), n_frames=240, image_size=SIZE)
    got = _render()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_loop_session_same_keyframes_every_frame():
    want, got = _run()
    assert len(got["hist"]) == K
    for k in range(K):
        assert got["hist"][k] == want["hist"][k], f"frame {k}: port {got['hist'][k]}, jax {want['hist'][k]}"
    assert len(want["hist"][-1]) >= 8  # past the warmup: the frontend ran


def test_loop_session_tracked_state_matches_jax():
    want, got = _run()
    assert got["poses"].shape == want["poses"].shape
    assert np.abs(got["poses"] - want["poses"]).max() < 5e-3
    assert np.abs(got["disps"] - want["disps"]).max() < 1e-2


def test_loop_session_filled_trajectory_matches_jax():
    want, got = _run()
    assert got["traj"].shape == want["traj"].shape == (K, 7)
    assert np.isfinite(got["traj"]).all()
    assert np.abs(got["traj"] - want["traj"]).max() < 5e-3


def test_loop_session_row_matches_jax():
    want, got = _run()
    row = got["row"]
    assert JAX_ROW_KEYS <= set(row)
    assert row["frames"] == K and row["image_size"] == list(SIZE) and row["compute_dtype"] == "float32"
    assert row["keyframes"] == want["keyframes"]
    assert abs(row["ate_rmse"] - want["post"]["ate_rmse"]) < 1e-3
    assert abs(row["ate_kf_pre_terminate"] - want["pre"]["ate_rmse"]) < 1e-3
    # both global-BA passes ran over the keyframes, within the 16·t edge budget
    assert [r["steps"] for r in row["backend_runs"]] == [7, 12]
    for r in row["backend_runs"]:
        assert 0 < r["edges"] <= 16 * row["keyframes"] and r["chunks"] >= 1
    assert row["launches"] == {"track": {}, "terminate": {}}  # the CPU runs the plain versions
    assert row["peak_allocated_gb"] is None and row["warm_terminate_s"] is not None


def test_load_or_render_caches(tmp_path):
    """The first call renders (on 3 threads here, bit for bit the serial
    render) and caches; the second reads the cache."""
    first = longloop.load_or_render(3, 8, 32, 48, cache_dir=tmp_path, workers=3)
    serial = render_loop_sequence(np.random.default_rng(3), n_frames=8, image_size=(32, 48))
    assert all(first[k].dtype == serial[k].dtype and np.array_equal(first[k], serial[k]) for k in serial)
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["droid_longloop_3_8_32x48.npz"]
    again = longloop.load_or_render(3, 8, 32, 48, cache_dir=tmp_path)
    assert all(np.array_equal(first[k], again[k]) for k in first)
    assert first["images"].shape == (8, 32, 48, 3)


def test_longloop_cli_defaults_are_the_jax_tools(monkeypatch, tmp_path):
    """The JAX tool's flags and defaults (seed 7, 288 frames, 384×512,
    bf16), plus --device, --cache_dir, --weights and --no-capture, reach
    ``run``; --json appends the row."""
    seen = {}

    def fake_run(seed, frames, H, W, dtype, device=None, cache_dir=None, weights=None, capture=True):
        seen.update(seed=seed, frames=frames, size=(H, W), dtype=dtype, device=device, cache_dir=cache_dir,
                    weights=weights, capture=capture)
        return {"seed": seed}

    monkeypatch.setattr(longloop, "run", fake_run)
    out = tmp_path / "rows.jsonl"
    longloop.main(["--device", "cpu", "--json", str(out)])
    assert seen["capture"] is True
    longloop.main(["--seed", "3", "--frames", "10", "--image_size", "64", "80", "--compute_dtype", "float32",
                   "--cache_dir", str(tmp_path), "--weights", "w.pth", "--no-capture", "--json", str(out)])
    assert seen == dict(seed=3, frames=10, size=(64, 80), dtype="float32", device=None, cache_dir=str(tmp_path),
                        weights="w.pth", capture=False)
    assert out.read_text().splitlines() == ['{"seed": 7}', '{"seed": 3}']
