"""The harness on the CPU: every cell's control flow at a tiny size (a dry
run, which prints no device metric), the command's refusal without a
card, the contract of BENCHMARK.json, and a cell, a configuration and a
metric added by files alone."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from slam_bench import harness, run
from slam_bench.tests.conftest import ROOT, tiny

SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_dry_run_of_every_cell(torch_cpu, name):
    cell = tiny(name, frames=16 if "track" in name else 20)
    # float32: on the CPU the program is then the reference bit for bit,
    # whatever the cell's limits (set for bf16 at full size)
    cell.config["droid_config"]["compute_dtype"] = "float32"
    res = run.measure(cell, 2**31 + 99, 0.5, False, torch_cpu, torch.device("cpu"), t0=time.perf_counter())
    assert res["metrics"] == {} and "refused" in res
    assert res["device"]["platform"] == "cpu"
    assert res["correct"] is True, res["check"]
    assert res["attempted"] >= 1
    assert list(res)[-1] == "check"
    assert set(res["check"]) == set(cell.workload["check"])


def test_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "slam_bench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_command_refuses_an_unknown_cell():
    assert run.main(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1"]) == 2


NAME = harness.NAME


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["slam_bench"] and SPEC["command"][1].startswith("slam_bench/")
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("slam_bench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in names
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        cell = harness.Cell.load(w["name"])
        assert (cell.workload["config"], cell.workload["traffic"]) == (w["config"], w["traffic"])
        reported = [m["name"] for m in harness.cell_metrics(SPEC, w["name"], "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(SPEC, w["name"], "per_layer")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", CELLS):
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_a_cell_config_and_metric_added_by_files_alone(tmp_path):
    # a copy of the benchmark's folder and BENCHMARK.json, with new files
    # and new entries only
    shutil.copytree(harness.BENCH_DIR, tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((harness.BENCH_DIR / "configs" / "tum_mono_240x320.json").read_text())
    cfg["droid_config"].update(image_size=[48, 64], buffer=40, warmup=8)
    (tmp_path / "slam_bench" / "configs" / "fixture_cfg.json").write_text(json.dumps(cfg))
    cell = json.loads((harness.BENCH_DIR / "workloads" / "tum-track-allkf.json").read_text())
    cell.update(config="fixture_cfg", traffic="fixture_traffic")
    cell["generator_args"]["frames"] = 12
    cell["driver_args"].update(warm_frames=10, check_frames=12)
    (tmp_path / "slam_bench" / "workloads" / "fixture-cell.json").write_text(json.dumps(cell))
    (tmp_path / "slam_bench" / "metrics" / "fixture.host_ms_max.py").write_text(
        "def read(trace):\n    return max(trace.host_ms) if trace.host_ms else None\n")
    spec["configs"].append({"name": "fixture_cfg", "source": "fixture", "file": "slam_bench/configs/fixture_cfg.json",
                            "reduced": [], "why": "fixture"})
    spec["workloads"].append({"name": "fixture-cell", "config": "fixture_cfg", "traffic": "fixture_traffic",
                              "chips": 1, "why": "fixture"})
    spec["per_layer"].append({"name": "fixture.host_ms_max", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "fixture", "moves": "setup_s",
                              "workloads": ["fixture-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    weights = tmp_path / "weights"
    weights.mkdir()
    (weights / "droid_synth.msgpack").symlink_to(ROOT / "weights" / "droid_synth.msgpack")
    (tmp_path / "droid_slam_tpu_torch").symlink_to(ROOT / "droid_slam_tpu_torch")
    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "torch.set_num_threads(2)\n"
        "from slam_bench import harness, run\n"
        "assert harness.ROOT == __import__('pathlib').Path(sys.argv[1])\n"
        "cell = harness.Cell.load('fixture-cell')\n"
        "res = run.measure(cell, 5, 0.3, False, torch, torch.device('cpu'), t0=time.perf_counter())\n"
        "assert res['correct'], res\n"
        "m = harness.cell_metrics(harness.benchmark_spec(), 'fixture-cell', 'per_layer')\n"
        "t = harness.Trace(kind='track', stretch=harness.Stretch([], 0, 1, 1), host_ms=[1.0, 4.0])\n"
        "assert harness.read_metrics(t, m)['fixture.host_ms_max']['value'] == 4.0\n"
    )
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], check=True, timeout=600, cwd=tmp_path)
