"""The harness's own arithmetic and contract, on the CPU: cells found by
name from files alone, the rate over whole units, the idle union, the
result line's keys, and a run without a card."""

import json
import shutil
import subprocess
import sys

import pytest

from harness import cli, profiling, record, spec

BENCH = spec.BENCH_DIR
ROOT = BENCH.parent


def bench_json() -> dict:
    return spec.load_json(ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("name", [w["name"] for w in bench_json()["workloads"]])
def test_cell_found_by_name(name):
    cell = spec.find_cell(bench_json(), name)
    assert cell.traffic["loop"] == "uhc_train"
    assert cell.traffic["limits"]
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_new_cell_from_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries, with no file of the harness edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH / "configs", bench / "configs")
    shutil.copytree(BENCH / "traffic", bench / "traffic")
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    b = bench_json()
    cfg = json.loads((BENCH / "configs" / "uhc.json").read_text())
    cfg["name"] = "uhc_copy"
    (bench / "configs" / "uhc_copy.json").write_text(json.dumps(cfg))
    tr = json.loads((BENCH / "traffic" / "uhc_train.e1024.json").read_text())
    tr.update(name="uhc_train.e4096", n_envs=4096, rollout_steps=12)
    (bench / "traffic" / "uhc_train.e4096.json").write_text(json.dumps(tr))
    (bench / "metrics" / "uhc_train.units.py").write_text(
        "def read(run):\n    return float(len(run.units)) or None\n")
    b["configs"].append(dict(b["configs"][0], name="uhc_copy",
                             file="benchmark/configs/uhc_copy.json"))
    b["workloads"].append(dict(b["workloads"][0], name="uhc_copy.train.e4096",
                               config="uhc_copy", traffic="uhc_train.e4096"))
    b["per_layer"].append(dict(b["per_layer"][0], name="uhc_train.units",
                               workloads=["uhc_copy.train.e4096"]))
    cell = spec.find_cell(b, "uhc_copy.train.e4096", bench_dir=bench)
    assert cell.traffic["n_envs"] == 4096 and cell.config["name"] == "uhc_copy"
    assert [m["name"] for m in cell.per_layer] == ["uhc_train.units"]
    run = record.Run(config=cell.config, traffic=cell.traffic, seconds=1,
                     trace=True, units=[record.Unit(0, 1, 10)] * 3)
    assert spec.reader("uhc_train.units", bench_dir=bench)(run) == 3.0


def test_rate_counts_a_stall():
    """Work of whole units over the time from the window's start to the
    end of the last unit: a stall between units lowers the rate."""
    units = [record.Unit(0.0, 1.0, 100), record.Unit(1.0, 2.0, 100)]
    steady = record.Run({}, {}, 2, False, window_t0=0.0, units=units)
    stalled = record.Run({}, {}, 2, False, window_t0=0.0, units=[
        units[0], record.Unit(3.0, 4.0, 100)])
    late = record.Run({}, {}, 2, False, window_t0=-1.0, units=units)
    profiled = record.Run({}, {}, 2, False, window_t0=0.0, units=units + [
        record.Unit(2.0, 9.0, 100, profiled=True)])
    assert steady.rate() == 100.0
    assert profiled.rate() == 100.0
    assert stalled.rate() == 50.0
    assert late.rate() == pytest.approx(200 / 3)
    assert record.Run({}, {}, 2, False).rate() is None


def test_idle_union():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.6)]
    assert profiling.busy_us(iv) == 4
    assert profiling.idle_gaps(iv, -1, 8) == [(-1, 0), (3, 5), (6, 8)]
    assert profiling.busy_us([]) == 0


class _Loop:
    attempted, failed = 3, 0


def _line(trace: bool):
    cell = spec.find_cell(bench_json(), "uhc.train.e1024")
    run = record.Run(cell.config, cell.traffic, 1, trace, setup_s=2.0,
                     window_t0=0.0, units=[record.Unit(0, 1, 49152, 48)],
                     counters=dict(n_envs=1024, steps=48, contact_blocks=18,
                                   contact_iters=20, flop_per_unit=1e12))
    run.profile = profiling.Summary(window_s=1.0, busy_s=0.25)
    run.profile.busy_tag.update(rollout=0.15, update=0.1)
    run.profile.steps.update(rollout=3)
    checks = [("step_state", 1e-4, 1e-2)]
    return cli.result_line(cell, run, _Loop(), checks, 10, {"platform": "gpu"})


def test_result_line_keys():
    """The five keys the driver reads, then the compared numbers under a
    key of their own, last; with a trace also the breakdown."""
    line = _line(False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"uhc_train_device_s_per_iter", "setup_s"}
    assert line["metrics"]["uhc_train_device_s_per_iter"]["value"] == \
        pytest.approx(0.15 / 3 * 48 + 0.1)
    assert "busy_s" not in line["device"]
    traced = _line(True)
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert traced["device"]["busy_s"] == 0.25
    assert "uhc_train.device_idle" in traced["metrics"]
    assert traced["metrics"]["uhc_train.host_samples_per_s"]["value"] == 49152


def test_a_missing_limit_is_not_correct():
    cell = spec.find_cell(bench_json(), "uhc.train.e1024")
    run = record.Run(cell.config, cell.traffic, 1, False)
    line = cli.result_line(cell, run, _Loop(), [("x", 0.0, float("nan"))], 0,
                           {})
    assert line["correct"] is False


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints no result:
    no measurement falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "uhc.train.e1024", "--seed", "3000000019",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_bare_directory_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's own
    files has no program to run: non-zero, no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "uhc.train.e1024", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_whole_names():
    assert cli.forbidden_modules(["kinpoly_tpu_torch.rl.ppo", "torch"]) == []
    assert cli.forbidden_modules(["kinpoly_tpu.physics", "jaxlib.xla"]) == [
        "jaxlib", "kinpoly_tpu"]
    assert cli.forbidden_modules(["jaxtyping", "optax_like", "flax"]) == ["flax"]
