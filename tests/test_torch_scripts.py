"""CPU drives of the port's UHC scripts on the real bank
(``data_bank/clips24.pkl``), of the AR evaluation on the wild bank
(``data_bank/wild_takes_r5.pkl``), and of AR training
(``train_ar_policy``, ``exp_arnet``) on ``data_bank/ar_train_56.pkl`` and
on the seeded standing take with small nets, at tiny sizes: what each
prints and writes."""

import dataclasses
import json
import os
import pickle
import re

import joblib
import numpy as np
import pytest
import torch

from kinpoly_tpu_torch.data import banks
from kinpoly_tpu_torch.config.defaults import KinPolyConfig
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.scripts import (eval_ar_policy, eval_uhc, exp_arnet,
                                       gen_states, train_ar_policy, train_uhc)

# many tiny torch ops: one intra-op thread per process keeps several test
# workers from oversubscribing the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS24 = os.path.join(ROOT, "data_bank/clips24.pkl")
HARD = os.path.join(ROOT, "data_bank/hard_states_getup.pkl")
WILD = os.path.join(ROOT, "data_bank/wild_takes_r5.pkl")
AR_MODELS = os.path.join(ROOT, "results_r5/statear/kin_poly/models")
UHC_CKPT = os.path.join(ROOT, "results/motion_im/uhc/models/iter_13000.p")
AR_TRAIN = os.path.join(ROOT, "data_bank/ar_train_56.pkl")


def small_kin_config(**policy_specs) -> KinPolyConfig:
    """kin_poly.yml with small nets and batches."""
    cfg = KinPolyConfig.named("kin_poly")
    return dataclasses.replace(
        cfg, fr_num=12, batch_size=3, n_envs=2, rollout_steps=2,
        model_specs=dict(cfg.model_specs, rnn_hdim=16, mlp_hsize=[16]),
        policy_specs=dict(cfg.policy_specs, num_optim_epoch=1,
                          num_step_update=1, **policy_specs))


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


@pytest.mark.parametrize("script", [train_ar_policy, exp_arnet])
def test_ar_training_scripts_need_a_device(script, tmp_path):
    """Without --device cpu the scripts run on CUDA, and raise here."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(["--out", str(tmp_path)], cfg=small_kin_config())


def test_train_ar_policy_warm_start_then_resume(tmp_path, capsys):
    """A warm start on the 56-take bank and one composite epoch with the
    joint controller; then a resume of that checkpoint on the seeded take
    with BC only (and toward the simulated pose), no compaction."""
    cfg = small_kin_config()
    train_ar_policy.main(
        ["--device", "cpu", "--data", AR_TRAIN, "--uhc-checkpoint", UHC_CKPT,
         "--init-steps", "2", "--full-steps", "1", "--max-epochs", "1",
         "--joint-controller", "--out", str(tmp_path)], cfg=cfg)
    out = capsys.readouterr().out
    assert "init step 0: loss" in out and "full step 0: loss" in out
    assert "warm start: 2 init-state and 1 full-AR steps" in out
    assert re.search(r"epoch 0  R [0-9.]+  bc [0-9.]+  ppo -?[0-9.]+", out)
    models = tmp_path / "statear" / "kin_poly" / "models"
    for it in (0, 1):
        assert (models / f"iter_{it:04d}.p").is_file()
    ck = weights.read_checkpoint(str(models / "iter_0001.p"))
    assert ck["epoch"] == 1 and ck["cc_params"] is not None
    assert sum(len(v) for v in ck["freq"].values()) > 0
    train_ar_policy.main(
        ["--device", "cpu", "--iter", "1", "--skip-init", "--max-epochs", "2",
         "--no-rl-update", "--step-update-dyna", "--no-compact",
         "--out", str(tmp_path)], cfg=cfg)
    out = capsys.readouterr().out
    assert "resumed" in out and "a seeded standing take" in out
    assert re.search(r"epoch 1  R [0-9.]+  bc [0-9.]+  ppo 0.0000", out)
    ck = weights.read_checkpoint(str(models / "iter_0002.p"))
    assert ck["epoch"] == 2 and ck["cc_params"] is None
    lines = (models / "ar_kin_poly_metrics.jsonl").read_text().splitlines()
    recs = [json.loads(x) for x in lines]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r[k]) for r in recs for k in
               ("reward_mean", "bc_loss", "ppo_loss", "value_loss", "cc_loss",
                "fail_frac", "ratio_dev", "ppo_grad_norm", "adv_std",
                "bc_nan_frac", "T_iter"))
    assert recs[0]["ppo_grad_norm"] > 0 and recs[1]["ppo_grad_norm"] == 0
    assert "saved final checkpoint" in (tmp_path / "statear" / "kin_poly"
                                        / "log.txt").read_text()


def test_exp_arnet_trains_and_tests(tmp_path, capsys):
    """Two epochs on the seeded take (a checkpoint at 2), then --test of
    that checkpoint: one take's pose metrics and the MEAN row."""
    cfg = small_kin_config(save_model_interval=2)
    _, losses = exp_arnet.main(["--device", "cpu", "--epochs", "2",
                                "--out", str(tmp_path)], cfg=cfg)
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert re.search(r"epoch 0 fr 80 gt 0.30 loss [0-9.]+", out)
    assert "2 epochs in" in out
    ck = tmp_path / "statear" / "kin_poly" / "models" / "arnet_iter_0002.p"
    with open(ck, "rb") as f:
        blob = pickle.load(f)
    assert blob["epoch"] == 2 and sorted(blob["params"]["params"]) == [
        "action_fc", "action_gru", "action_mlp", "context_fc", "context_gru",
        "context_mlp"]
    _, rows = exp_arnet.main(["--device", "cpu", "--test", "--iter", "2",
                              "--out", str(tmp_path)], cfg=cfg)
    out = capsys.readouterr().out
    assert len(rows) == 1 and all(np.isfinite(v) for v in rows[0].values())
    assert re.search(r"take 0: root_dist:[0-9.]+ head_dist", out)
    assert "MEAN  root_dist" in out
