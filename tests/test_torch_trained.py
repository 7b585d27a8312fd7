"""Port parity with trained weights, and the port's synthetic protocol.

* Trained-weights replay: 24 rendered 64×96 frames (seed 11) tracked by the
  JAX fused ``Droid`` and by the port's ``Droid`` on the CPU, both loading
  ``weights/equivalence_fixture.msgpack`` (the port through its own
  reader), with the default motion-filter and keyframe thresholds (2.4 and
  4.0), so both keyframe branches decide for real: the motion probe skips
  frames and the keyframe test culls. The gates must have teeth (at least
  one skip and one cull), then after every frame the two must hold the
  same keyframe timestamps, and at the end the same active and inactive
  edges and poses within 5e-3 (the bound of
  tests/test_engine_equivalence.py). The fixture weights were chosen for
  their wide decision margins (tests/test_engine_equivalence.py).
* The port's copies of ``render_sequence`` and ``ate_rmse`` give the JAX
  package's results bit for bit (mono, stereo, RGB-D renders of one seed).
* ``apps/evaluate.py`` runs through ``main`` on the CPU at a small size.
* Marked slow: the six rows of tests/test_accuracy.py::SEED_GATES through
  the port on the CPU (48 frames at 192×256 each).
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.data import synthetic as jsynthetic
from droid_slam_tpu.eval import ate as jate
from droid_slam_tpu.runtime import Droid as JDroid
from droid_slam_tpu.runtime import DroidConfig as JDroidConfig
from droid_slam_tpu_torch.apps import evaluate
from droid_slam_tpu_torch.data import synthetic
from droid_slam_tpu_torch.eval import ate
from droid_slam_tpu_torch.runtime import Droid, DroidConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "weights", "equivalence_fixture.msgpack")
SHIPPED = os.path.join(REPO, "weights", "droid_synth.msgpack")

N_FRAMES = 24
CONFIG = dict(
    image_size=(64, 96),
    buffer=32,
    warmup=8,
    max_factors=48,
    inactive_pad=64,
    window_pad=32,
    schur_pair_floor=1024,
    filter_thresh=2.4,  # the default motion gate: the probe decides
    keyframe_thresh=4.0,  # the default cull threshold: the cull test decides
    frontend_window=16,
    frontend_thresh=16.0,
    compute_dtype="float32",
)


def _edge_set(ii, jj, valid):
    return {(int(i), int(j)) for i, j, v in zip(np.asarray(ii), np.asarray(jj), np.asarray(valid)) if v}


@functools.lru_cache(maxsize=None)
def _replay():
    seq = synthetic.render_sequence(np.random.default_rng(11), n_frames=N_FRAMES, image_size=(64, 96),
                                    t_sigma=0.25, r_sigma=0.02)
    jd = JDroid(JDroidConfig(**CONFIG), weights=FIXTURE)
    want_hist = []
    for t in range(N_FRAMES):
        jd.track(t, jnp.asarray(seq["images"][t]), intrinsics=jnp.asarray(seq["intrinsics"][t]))
        st = jd._fused_state
        want_hist.append([float(x) for x in np.asarray(st.tstamp[: int(st.counter)])])
    st = jd._fused_state
    n = int(st.counter)
    want = dict(hist=want_hist, poses=np.asarray(st.poses[:n]),
                edges=_edge_set(st.ii, st.jj, st.valid),
                inactive=_edge_set(st.inac_ii, st.inac_jj, st.inac_valid))

    pd = Droid(DroidConfig(**CONFIG), weights=FIXTURE, device="cpu")
    got_hist = []
    with torch.backends.mkldnn.flags(enabled=False):
        for t in range(N_FRAMES):
            pd.track(t, seq["images"][t], intrinsics=seq["intrinsics"][t])
            got_hist.append(pd.tstamps.tolist())
    got = dict(hist=got_hist, poses=pd.poses.numpy(), edges=pd.edges, inactive=pd.inactive_edges)
    return want, got


def test_trained_replay_gates_have_teeth():
    want, got = _replay()
    hist = want["hist"]
    skipped = [t for t in range(N_FRAMES) if float(t) not in hist[t]]
    culled = [t for t in range(1, N_FRAMES) if set(hist[t - 1]) - set(hist[t])]
    assert skipped, "every frame keyframed: the motion probe decided nothing"
    assert culled, "no keyframe culled: the cull test decided nothing"
    assert len(hist[-1]) >= 8  # past the warmup: the frontend ran


def test_trained_replay_same_keyframes_every_frame():
    want, got = _replay()
    for t in range(N_FRAMES):
        assert got["hist"][t] == want["hist"][t], f"frame {t}: port {got['hist'][t]}, jax {want['hist'][t]}"


def test_trained_replay_same_edges_and_poses():
    want, got = _replay()
    assert got["edges"] == want["edges"], (
        f"port-only {sorted(got['edges'] - want['edges'])}, "
        f"jax-only {sorted(want['edges'] - got['edges'])}"
    )
    assert got["inactive"] == want["inactive"]
    assert got["poses"].shape == want["poses"].shape
    assert np.abs(got["poses"] - want["poses"]).max() < 5e-3


@pytest.mark.parametrize("stereo", [False, True])
def test_render_sequence_bitwise_equal_to_jax(stereo):
    kw = dict(n_frames=3, image_size=(48, 64), t_sigma=0.25, r_sigma=0.02, stereo=stereo)
    want = jsynthetic.render_sequence(np.random.default_rng(5), **kw)
    got = synthetic.render_sequence(np.random.default_rng(5), **kw)
    # mono and RGB-D read the same render (images, depths); stereo adds the right images
    assert set(got) == set(want) == {"images", "poses", "depths", "intrinsics"} | (
        {"images_right"} if stereo else set())
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_render_loop_sequence_bitwise_equal_to_jax():
    kw = dict(n_frames=4, image_size=(32, 48))
    want = jsynthetic.render_loop_sequence(np.random.default_rng(2), **kw)
    got = synthetic.render_loop_sequence(np.random.default_rng(2), **kw)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("correct_scale", [False, True])
def test_ate_rmse_equal_to_jax(correct_scale):
    r = np.random.default_rng(3)
    t = np.arange(30, dtype=np.float64)
    gt = r.standard_normal((30, 7))
    est = 1.7 * gt[::-1].copy() + 0.05 * r.standard_normal((30, 7))
    # estimate stamps shifted and thinned, so the association matters
    est_t = t[::-1] + 0.1 * r.random(30)
    want = jate.ate_rmse(jate.Trajectory(t, gt[:, :3], gt[:, 3:]), jate.Trajectory(est_t, est[:, :3], est[:, 3:]),
                         correct_scale=correct_scale, max_dt=0.25)
    got = ate.ate_rmse(ate.Trajectory(t, gt[:, :3], gt[:, 3:]), ate.Trajectory(est_t, est[:, :3], est[:, 3:]),
                       correct_scale=correct_scale, max_dt=0.25)
    assert got == want
    assert (got["scale"] != 1.0) == correct_scale


def test_evaluate_main_synthetic_on_cpu(tmp_path, capsys):
    out = tmp_path / "traj.txt"
    with torch.backends.mkldnn.flags(enabled=False):
        result = evaluate.main(["--dataset", "synthetic", "--stereo", "--frames", "14", "--image_size", "64", "96",
                                "--compute_dtype", "float32", "--device", "cpu", "--save_traj", str(out)])
    assert result["device"] == "cpu" and result["frames"] == 14 and result["n_pairs"] == 14
    assert result["scale"] == 1.0  # stereo is metric: no scale correction
    assert np.isfinite(result["ate_rmse"]) and 1 <= result["keyframes"] <= 14
    assert np.loadtxt(out).shape == (14, 8)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed)["ate_rmse"] == result["ate_rmse"]


@pytest.mark.parametrize("dataset", ["tum", "euroc", "eth3d", "tartanair"])
def test_evaluate_file_datasets_wait_for_item_12(dataset, capsys):
    """The file protocols are ported (ROADMAP queue 1 item 2): without
    --datapath the app refuses for want of the sequence, no longer as not
    ported (tests/test_torch_apps_files.py runs them on files)."""
    with pytest.raises(SystemExit) as exc:
        evaluate.main(["--dataset", dataset, "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"--dataset {dataset} needs --datapath" in err and "not ported" not in err


# tests/test_accuracy.py::SEED_GATES: (seed, compute dtype, ATE bound)
SEED_GATES = [
    (7, "float32", 0.30),
    (11, "float32", 0.60),
    (23, "float32", 0.40),
    (5, "float32", 0.45),
    (42, "float32", 0.45),
    (11, "bfloat16", 0.45),
]


@pytest.mark.slow
@pytest.mark.parametrize("seed,dtype,bound", SEED_GATES)
def test_port_trained_weights_track_synthetic_sequence(seed, dtype, bound):
    """The port's copy of tests/test_accuracy.py's gates, on the CPU."""
    frames = 48
    track, fill, ref = evaluate.synthetic_streams(seed, frames, (192, 256))
    config = DroidConfig(image_size=(192, 256), buffer=96, warmup=8, compute_dtype=dtype)
    traj, droid, _ = evaluate.run_slam(config, SHIPPED, track, fill, device="cpu")
    assert 6 <= droid.counter <= frames - 4
    r = evaluate.score(ref, np.arange(frames, dtype=np.float64), traj, correct_scale=True)
    assert r["ate_rmse"] < bound, (seed, dtype, r)
    assert 0.25 < r["scale"] < 12.0, (seed, dtype, r)
