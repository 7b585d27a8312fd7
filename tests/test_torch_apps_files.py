"""The port's file-based entry points on the CPU, on files written at test
time from one rendered sequence (``data/synthetic.py``):

* ``apps/demo.py::main`` on frames 1-8 (``--t0 1 --t1 8``) of a 12-frame
  PNG folder (``chip_smoke.py``'s fixture writer) at a small area with the
  shipped weights: its trajectory
  equals, bit for bit, that of a port ``Droid`` of the same configuration
  fed the same frames in memory (resized as the stream resizes them); with
  ``--reconstruction_path`` it writes the five ``.npy`` files and with
  ``--profile`` a trace; ``--synthetic`` runs.
* ``apps/evaluate.py --dataset {tum,euroc,eth3d,tartanair}`` with ``--gt``
  (EuRoC: the sequence's own ``data.csv``), as ``tests/test_evaluate_cli.py``
  drives the JAX app: each protocol's real stream reads the files; its
  frames are then cut to 48x64 (TUM and ETH3D by subsampling, EuRoC and
  TartanAir through the stream's ``image_size``), which the CPU tracks in
  seconds; finite trajectories of every frame, the ATE over every frame.
* ``apps/train.py --datapath <TartanAir root> --device cpu`` for 2 steps
  at a small crop writes a checkpoint that ``load_weights`` reads.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import chip_smoke
from droid_slam_tpu_torch.apps import demo, evaluate
from droid_slam_tpu_torch.apps import train as train_app
from droid_slam_tpu_torch.data import streams
from droid_slam_tpu_torch.data.synthetic import render_sequence
from droid_slam_tpu_torch.models.droid_net import DroidNet
from droid_slam_tpu_torch.models.weights import load_weights
from droid_slam_tpu_torch.runtime import Droid

torch.set_num_threads(2)

WEIGHTS = str(Path(__file__).resolve().parent.parent / "weights" / "droid_synth.msgpack")
FRAMES = 12
SMALL = (48, 64)  # the working size of the evaluate runs
# the demo fixture's thresholds: the rendered motion is ~0.7 px at 1/8 of the
# 56x80 working size, so the filter and keyframe thresholds sit below it
DEMO_ARGS = ["--device", "cpu", "--image_size", "64", "80", "--compute_dtype", "float32", "--stride", "1",
             "--weights", WEIGHTS, "--filter_thresh", "0.3", "--keyframe_thresh", "0.5", "--warmup", "4",
             "--buffer", "16", "--frontend_window", "8"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("files")
    fx = chip_smoke.write_file_fixtures(np, render_sequence, root, 0, (120, 160), FRAMES, 80.0)
    seq = fx["seq"]
    bgr = [np.ascontiguousarray(im[..., ::-1]) for im in seq["images"]]

    def gt_lines(stamps):
        return "\n".join(" ".join(f"{x:.9f}" for x in (t, *p)) for t, p in zip(stamps, seq["poses"]))

    # TUM: rgb/<epoch s>.png at 640x480 and groundtruth.txt
    tum = root / "tum"
    (tum / "rgb").mkdir(parents=True)
    stamps = 1305031100.0 + 0.1 * np.arange(FRAMES)
    for t, im in zip(stamps, bgr):
        cv2.imwrite(str(tum / "rgb" / f"{t:.6f}.png"), cv2.resize(im, (640, 480)))
    (tum / "groundtruth.txt").write_text("# timestamp tx ty tz qx qy qz qw\n" + gt_lines(stamps))
    # EuRoC: mav0/cam{0,1}/data/<ns>.png at 752x480 and the ground truth's data.csv
    euroc = root / "euroc"
    ns = 1403636579763555584 + 50_000_000 * np.arange(FRAMES, dtype=np.int64)
    for cam in ("cam0", "cam1"):
        (euroc / "mav0" / cam / "data").mkdir(parents=True)
        for t, im in zip(ns, bgr):
            cv2.imwrite(str(euroc / "mav0" / cam / "data" / f"{t}.png"), cv2.resize(im, (752, 480)))
    gt = euroc / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir()
    p = seq["poses"].astype(np.float64)
    (gt / "data.csv").write_text("#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z\n" + "\n".join(
        ",".join([str(t)] + [repr(float(x)) for x in (*r[:3], r[6], *r[3:6])]) for t, r in zip(ns, p)))
    # ETH3D: rgb/ and depth/ (16-bit, metres x 5000), calibration.txt, groundtruth.txt
    eth = root / "eth3d"
    (eth / "rgb").mkdir(parents=True)
    (eth / "depth").mkdir()
    estamps = 1000.0 + 0.1 * np.arange(FRAMES)
    for t, im, d in zip(estamps, bgr, seq["depths"]):
        cv2.imwrite(str(eth / "rgb" / f"{t:.6f}.png"), im)
        cv2.imwrite(str(eth / "depth" / f"{t:.6f}.png"), np.clip(d * 5000.0, 0, 65535).astype(np.uint16))
    np.savetxt(eth / "calibration.txt", seq["intrinsics"][0][None], delimiter=" ")
    (eth / "groundtruth.txt").write_text(gt_lines(estamps))
    return dict(fx, tum=tum, euroc=euroc, eth3d=eth)


def test_demo_from_files_matches_in_memory_droid(files, tmp_path):
    recon, prof = tmp_path / "recon", tmp_path / "prof"
    argv = ["--imagedir", str(files["imagedir"]), "--calib", str(files["calib"]), *DEMO_ARGS, "--t0", "1",
            "--t1", "8", "--reconstruction_path", str(recon), "--profile", str(prof)]
    traj, rec = demo.main(argv)
    assert traj.shape == (8, 7) and np.isfinite(traj).all()
    assert rec["frames"] == 8 and rec["image_size"] == [56, 80]
    assert rec["keyframes"] >= 5  # the tracker initialised (warmup 4)

    args = demo.parser().parse_args(argv)
    args.upsample = True  # --reconstruction_path forces it
    calib = np.loadtxt(files["calib"], delimiter=" ")
    stream = []
    for k, image in enumerate(files["seq"]["images"][1:9]):
        image, (sx, sy) = streams._resize_to_area(image, 64 * 80)
        stream.append((k, image, np.array([calib[0] * sx, calib[1] * sy, calib[2] * sx, calib[3] * sy],
                                          np.float32)))
    droid = Droid(demo.config_for(args, stream[0][1].shape[:2]), weights=WEIGHTS, device="cpu")
    for t, image, intr in stream:
        droid.track(t, image, intrinsics=intr)
    assert droid.counter == rec["keyframes"]
    assert np.array_equal(traj, droid.terminate(iter(stream)))

    saved = {name: np.load(recon / f"{name}.npy") for name in chip_smoke.RECONSTRUCTION_FILES}
    assert len(saved["tstamps"]) == rec["keyframes"] == len(saved["poses"])
    assert saved["disps"].shape == (rec["keyframes"], 56, 80) and (saved["disps"] != 0).any()
    assert saved["images"].dtype == np.uint8 and saved["intrinsics"].shape == (rec["keyframes"], 4)
    assert json.loads((prof / "trace.json").read_text())["traceEvents"]


def test_demo_synthetic():
    traj, rec = demo.main(["--synthetic", "--device", "cpu", "--compute_dtype", "float32"])
    assert traj.shape == (24, 7) and np.isfinite(traj).all() and rec["keyframes"] == 24
    with pytest.raises(SystemExit):
        demo.main(["--device", "cpu"])  # neither a folder nor --synthetic


def _subsample(stream_fn, factor, offset=2):
    """A stream whose frames (and depths) are those of ``stream_fn``, every
    ``factor``-th pixel from ``offset``, with the intrinsics to match."""

    @functools.wraps(stream_fn)
    def wrapped(*args, **kwargs):
        for item in stream_fn(*args, **kwargs):
            t, *arrays, intr = item
            arrays = [a[offset::factor, offset::factor] for a in arrays]
            fx, fy, cx, cy = intr
            yield (t, *arrays, np.array([fx / factor, fy / factor, (cx - offset) / factor,
                                         (cy - offset) / factor], np.float32))

    return wrapped


@pytest.fixture
def small_streams(monkeypatch):
    monkeypatch.setattr(streams, "tum_stream", _subsample(streams.tum_stream, 5))  # 240x320 -> 48x64
    monkeypatch.setattr(streams, "eth3d_stream", _subsample(streams.eth3d_stream, 8))  # 384x512 -> 48x64
    monkeypatch.setattr(streams, "euroc_stream", functools.partial(streams.euroc_stream, image_size=SMALL))
    monkeypatch.setattr(streams, "tartanair_stream", functools.partial(streams.tartanair_stream,
                                                                       image_size=SMALL))


@pytest.mark.parametrize("dataset,extra,frames", [
    ("tum", ["--gt", "{root}/tum/groundtruth.txt"], FRAMES // 2),
    ("euroc", [], FRAMES),
    ("euroc", ["--stereo"], FRAMES),
    ("eth3d", ["--gt", "{root}/eth3d/groundtruth.txt"], FRAMES),
    ("eth3d", ["--mono"], FRAMES),
    ("tartanair", ["--gt", "{root}/tartan/env/env/Easy/P000/pose_left.txt"], FRAMES),
])
def test_evaluate_file_protocols(files, small_streams, tmp_path, dataset, extra, frames):
    root = files["imagedir"].parent.parent
    datapath = {"tartanair": files["scene"]}.get(dataset, files.get(dataset))
    argv = ["--dataset", dataset, "--datapath", str(datapath), "--device", "cpu", "--compute_dtype", "float32",
            "--save_traj", str(tmp_path / "est.txt"), *(a.format(root=root) for a in extra)]
    res = evaluate.main(argv)
    assert res["image_size"] == list(SMALL)
    assert res["trajectory"].shape == (frames, 7) and np.isfinite(res["trajectory"]).all()
    assert res["n_pairs"] == frames and np.isfinite(res["ate_rmse"])
    est = np.loadtxt(tmp_path / "est.txt")
    assert est.shape == (frames, 8)
    if dataset == "euroc":  # stamps from the file names, positions x 1.10
        np.testing.assert_allclose(est[:, 0], 1403636579.763555584 + 0.05 * np.arange(frames), atol=1e-6)
        np.testing.assert_allclose(est[:, 1:4], 1.10 * res["trajectory"][:, :3], rtol=1e-6)
    if dataset == "eth3d" and "--mono" not in extra:
        assert res["scale"] == 1.0  # RGB-D: metric, unscaled


def test_evaluate_argument_checks(files):
    for argv in (["--dataset", "tum"], ["--dataset", "tum", "--datapath", "x", "--stereo"],
                 ["--dataset", "euroc", "--datapath", "x", "--rgbd"], ["--dataset", "tum", "--datapath", "x", "--mono"],
                 ["--dataset", "euroc", "--datapath", "x", "--stereo", "--rgbd"]):
        with pytest.raises(SystemExit):
            evaluate.main(argv)


def test_train_app_on_tartanair_files(files, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    hist = train_app.main(["--datapath", str(files["tartan_root"]), "--device", "cpu", "--crop", "64", "96",
                           "--steps", "2", "--batch", "2", "--n_frames", "4", "--iters", "2", "--edges", "6",
                           "--ckpt_every", "2", "--seed", "0", "--name", "tartan", "--fmin", "2.0",
                           "--fmax", "40.0", "--cache_dir", str(tmp_path / "cache")])
    assert [h["step"] for h in hist] == [1, 2]
    assert all(h["grads_finite"] and np.isfinite(h["metrics"]["loss"]) for h in hist)
    assert list((tmp_path / "cache").glob("TartanAir-*.pickle"))
    params = load_weights(str(tmp_path / "checkpoints" / "tartan_000002.pth"))
    DroidNet().load_state_dict(params)
    with pytest.raises(SystemExit):
        train_app.main(["--datapath", str(files["tartan_root"]), "--synthetic", "--device", "cpu"])
