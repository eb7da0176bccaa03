"""The paper's metric table from saved AR evaluation records (port of
``scripts/eval_pose_all.py``).

    python -m kinpoly_tpu_torch.scripts.eval_pose_all --iter 800 --wild \\
        --out results_r5 [--cfg kin_poly] [--device cpu]

Reads the ``<iter>_[wild_]*_coverage_full.pkl`` records that
``eval_ar_policy`` writes under ``<out>/statear/<cfg>/results/`` (through
``data.banks.read_bank``, no joblib), and for each take computes the pose
metrics of its predicted against its ground-truth qpos on the synthetic
humanoid with static objects (root_dist, head_dist, mpjpe, accel_dist,
vel_dist, slide, penetration at the model's contact candidates), its
tracked percent and its success: the record's ``succ``, else
``action_success`` of its ``action`` and ``obj_pose`` (fail-safe counted as
failure; head poses from FK, which the avoid rule reads), else tracked to
the end. Logs one line per take, the success per action and the mean
row.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import synthetic_spec
from kinpoly_tpu_torch.config.defaults import (NAMED_KIN_CONFIGS,
                                               KinPolyConfig,
                                               uhc_control_params)
from kinpoly_tpu_torch.data.banks import read_bank
from kinpoly_tpu_torch.metrics import pose_metrics
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.physics import fk as fklib
from kinpoly_tpu_torch.utils.logger import create_logger


def build_model(device, dtype=torch.float32) -> eng.PhysicsModel:
    """The synthetic humanoid with its objects as static geometry."""
    spec = synthetic_spec(with_objects=True)
    return eng.build_model(spec, uhc_control_params(spec), device=device,
                           dtype=dtype, with_objects=True)


def record_files(cfg: KinPolyConfig, out_root: str, iter_: int,
                 wild: bool) -> list[str]:
    tag = "wild_" if wild else ""
    return sorted(glob.glob(os.path.join(
        cfg.out_dir(out_root), "results", f"{iter_:04d}_{tag}*_coverage_full.pkl")))


@torch.no_grad()
def record_row(model: eng.PhysicsModel, res: dict) -> dict:
    """The metric row {name: float} of one record."""
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=model.dtype,
                                  device=model.device)
    pred, gt = t(res["pred"]), t(res["gt"])
    T = min(len(pred), len(gt))
    pred, gt = pred[:T], gt[:T]
    m = {k: float(v) for k, v in pose_metrics.evaluate_pair(model, pred, gt).items()}
    m["percent"] = float(res.get("percent", 1.0))
    if "succ" in res:
        m["succ"] = float(res["succ"])
    elif "action" in res and "obj_pose" in res:
        head = model.spec.body_index("Head")
        m["succ"] = float(pose_metrics.action_success(
            model, pred, t(res["obj_pose"]), res["action"],
            head_pose_pred=fklib.fk(model.st, pred).xpos[:, head],
            head_pose_gt=fklib.fk(model.st, gt).xpos[:, head],
            fail_safe_used=bool(res.get("fail_safe"))))
    else:
        m["succ"] = float(m["percent"] >= 1.0)
    return m


def table(model: eng.PhysicsModel, files: list[str]) -> tuple[list, dict, dict]:
    """(rows, success per action {action: [succ, ...]}, mean row)."""
    rows, per_action = [], {}
    for path in files:
        res = read_bank(path)
        m = record_row(model, res)
        per_action.setdefault(res.get("action", "None"), []).append(m["succ"])
        rows.append(m)
    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    return rows, per_action, mean


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", default="kin_poly", choices=sorted(NAMED_KIN_CONFIGS))
    p.add_argument("--iter", type=int, required=True)
    p.add_argument("--algo", default="kin_poly")
    p.add_argument("--wild", action="store_true")
    p.add_argument("--out", default="results")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    log = create_logger()
    cfg = KinPolyConfig.named(args.cfg)
    files = record_files(cfg, args.out, args.iter, args.wild)
    if not files:
        log.info(f"no result files match {cfg.out_dir(args.out)}/results/"
                 f"{args.iter:04d}_{'wild_' if args.wild else ''}"
                 f"*_coverage_full.pkl")
        return None
    rows, per_action, mean = table(build_model(resolve_device(args.device)), files)
    for path, m in zip(files, rows):
        log.info(os.path.basename(path) + "  " +
                 " ".join(f"{k}:{v:.3f}" for k, v in m.items()))
    for a in sorted(per_action):
        log.info(f"succ[{a}]: {np.mean(per_action[a]):.3f} "
                 f"({len(per_action[a])} takes)")
    log.info("".join(f"{k}:{v:.3f} \t " for k, v in mean.items()) +
             f"--{args.cfg} | {args.iter} | {args.algo} | wild? {args.wild}")
    return mean


if __name__ == "__main__":
    main()
