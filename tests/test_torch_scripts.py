"""CPU drives of the port's UHC scripts on the real bank
(``data_bank/clips24.pkl``), and of the AR evaluation on the wild bank
(``data_bank/wild_takes_r5.pkl``), at tiny sizes: what each prints and
writes."""

import json
import os
import pickle
import re

import joblib
import numpy as np
import torch

from kinpoly_tpu_torch.data import banks
from kinpoly_tpu_torch.scripts import eval_ar_policy, eval_uhc, gen_states, train_uhc

# many tiny torch ops: one intra-op thread per process keeps several test
# workers from oversubscribing the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS24 = os.path.join(ROOT, "data_bank/clips24.pkl")
HARD = os.path.join(ROOT, "data_bank/hard_states_getup.pkl")
WILD = os.path.join(ROOT, "data_bank/wild_takes_r5.pkl")
AR_MODELS = os.path.join(ROOT, "results_r5/statear/kin_poly/models")
UHC_CKPT = os.path.join(ROOT, "results/motion_im/uhc/models/iter_13000.p")


def test_train_uhc_on_the_real_bank_with_hard_states(tmp_path, capsys):
    train_uhc.main(["--device", "cpu", "--data", CLIPS24, "--hard-states", HARD,
                    "--clips", "4", "--frames", "10", "--max-iters", "1",
                    "--n-envs", "2", "--rollout-steps", "3",
                    "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "reactive_v 2 with 982 hard states" in out
    assert re.search(r"iter 0  R [0-9.]+  fail", out)
    run = tmp_path / "motion_im" / "uhc"
    assert (run / "models" / "iter_0001.p").is_file()
    log = (run / "log.txt").read_text()
    assert "iter 0  R" in log and "saved final checkpoint" in log
    lines = (run / "models" / "uhc_uhc_metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["step"] == 0 and np.isfinite(rec["reward_mean"])
    assert {f"reward_components/{i}" for i in range(5)} <= set(rec)


def test_train_uhc_quatv2_one_iteration(tmp_path, capsys):
    train_uhc.main(["--device", "cpu", "--cfg", "uhc_quatv2", "--data", CLIPS24,
                    "--clips", "2", "--frames", "6", "--max-iters", "1",
                    "--n-envs", "2", "--rollout-steps", "2",
                    "--out", str(tmp_path)])
    assert "iter 0  R" in capsys.readouterr().out
    models = tmp_path / "motion_im" / "uhc_quatv2" / "models"
    assert (models / "iter_0001.p").is_file()
    rec = json.loads((models / "uhc_uhc_quatv2_metrics.jsonl").read_text())
    assert np.isfinite(rec["reward_mean"]) and rec["reward_mean"] > 0


def test_eval_uhc_band_and_metrics(capsys):
    eval_uhc.main(["--device", "cpu", "--data", CLIPS24, "--clips", "2",
                   "--frames", "3", "--seeds", "2", "--metrics",
                   "--out", os.path.join(ROOT, "results")])
    out = capsys.readouterr().out
    assert re.search(r"proc-00: (OK|FAIL)  tracked", out)
    assert re.search(r"coverage_det [0-9.]+ over 2 clips.* 5 control steps x 3 "
                     r"runs", out)
    assert re.search(r"coverage_mean [0-9.]+ \+- [0-9.]+ over 2 seeds", out)
    mean = re.search(r"MEAN  (.*)", out).group(1)
    vals = dict(kv.split(":") for kv in mean.split())
    assert list(vals) == ["root_dist", "head_dist", "mpjpe", "accel_dist",
                          "vel_dist", "slide_pred", "slide_gt", "pen_pred",
                          "pen_gt"]
    assert all(np.isfinite(float(v)) for v in vals.values())


def test_gen_states_writes_a_bank_both_readers_take(tmp_path, capsys):
    path = str(tmp_path / "hard.pkl")
    gen_states.main(["--device", "cpu", "--data", CLIPS24, "--n-envs", "3",
                     "--steps", "2", "--rounds", "1", "--min-z", "0.0",
                     "--out", path])
    k = int(re.search(r"wrote (\d+) hard states", capsys.readouterr().out).group(1))
    for got in (banks.read_bank(path), joblib.load(path)):
        assert list(got) == ["qpos", "qvel"]
        assert got["qpos"].shape == (k, 76) and got["qvel"].shape == (k, 75)
        assert got["qpos"].dtype == got["qvel"].dtype == np.float32


def test_eval_ar_policy_wild_fail_safe(tmp_path, capsys):
    """iter_0800.p (linked into a fresh output root) with iter_13000.p as
    the controller on the first 2 wild takes, cut to 4 frames."""
    models = tmp_path / "statear" / "kin_poly" / "models"
    models.parent.mkdir(parents=True)
    os.symlink(AR_MODELS, models)
    eval_ar_policy.main(["--device", "cpu", "--wild", "--fail-safe",
                         "--data", WILD, "--takes", "2", "--frames", "4",
                         "--iter", "800", "--uhc-checkpoint", UHC_CKPT,
                         "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "not found" not in out
    assert re.search(r"2 takes, 3 control steps on cpu", out)
    assert re.search(r"take 0 wild-sit-00 \[sit\]: pct [0-9.]+ fs \d+ root_dist", out)
    mean = re.search(r"MEAN  (.*)", out).group(1)
    vals = dict(kv.split(":") for kv in mean.split())
    assert list(vals) == ["root_dist", "head_dist", "mpjpe", "accel_dist",
                          "vel_dist", "slide_pred", "slide_gt", "pen_pred",
                          "pen_gt", "percent", "fail_safe", "succ"]
    assert all(np.isfinite(float(v)) for v in vals.values())
    assert re.search(r"succ\[sit\]: [0-9.]+ \(2 takes\)", out)
    assert re.search(r"coverage: [0-9.]+ over 2 takes", out)
    res = tmp_path / "statear" / "kin_poly" / "results"
    for i in range(2):
        with open(res / f"0800_wild_take{i}_coverage_full.pkl", "rb") as f:
            rec = pickle.load(f)
        assert rec["action"] == "sit" and rec["pred"].shape[1] == 76
        assert rec["obj_pose"].shape[1:] == (5, 7)
        assert rec["gt"].shape == rec["pred"].shape
