"""Kinematic-policy evaluation on the port (port of
``scripts/eval_ar_policy.py``).

    python -m kinpoly_tpu_torch.scripts.eval_ar_policy --wild \\
        --data data_bank/wild_takes_r5.pkl --out results_r5 --iter 800 \\
        --uhc-checkpoint results/motion_im/uhc/models/iter_13000.p \\
        [--fail-safe] [--device cpu] [--takes N --frames F]
    python -m kinpoly_tpu_torch.scripts.eval_ar_policy --cfg use_of --wild \\
        --data data_bank/wild_takes_r5_of.pkl --out results_r4 --iter 0 \\
        --uhc-checkpoint results/motion_im/uhc/models/iter_13000.p

Loads ``<out>/statear/<cfg>/models/iter_<iter>.p`` (fresh seeded weights
if it is missing) of the named config ``--cfg`` (use_of: the takes'
optical-flow features in the context and the observation, the residual
policy of policy_v 2), builds the AR env on the synthetic humanoid with its
five movable objects (contact plan, LTDL, active-set compaction (16, 8):
kernels K1, K2 and K3 on CUDA) and the frozen UHC controller of
``--uhc-checkpoint`` (a fresh one without it), and evaluates one env per
take of ``--data`` (a bank that ``data/statear.load_annotations`` reads;
without it, one seeded take: the standing pose with a cumulative joint
walk). The context is the policy's open-loop AR rollout over each take
(smoothed, feet fixed); the policy then drives the physics with mean
actions for the longest take's length - 1 control steps. With
``--fail-safe`` a failing env teleports to the AR rollout and runs on to
the end of its take.

Writes one ``<iter>_[wild_]take<i>_coverage_full.pkl`` per take under
``<out>/statear/<cfg>/results/`` and logs per take its tracked percent,
fail-safe teleports, pose metrics and success, the MEAN row, the success
per action and the coverage (takes tracked to the end without a
teleport). ``--takes N --frames F`` cut the bank to its first N takes and
F frames (CPU drives).
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from dataclasses import dataclass

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import standing_pose, synthetic_spec
from kinpoly_tpu_torch.config.defaults import (NAMED_KIN_CONFIGS,
                                               KinPolyConfig, UHCConfig,
                                               uhc_control_params)
from kinpoly_tpu_torch.data import statear
from kinpoly_tpu_torch.envs.humanoid_ar import ARContext, HumanoidAREnv
from kinpoly_tpu_torch.metrics import pose_metrics
from kinpoly_tpu_torch.models import nets
from kinpoly_tpu_torch.models.traj_ar import ClipData
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.physics import fk as fklib
from kinpoly_tpu_torch.rl import rollout_ar as roa
from kinpoly_tpu_torch.rl import running_norm as rn
from kinpoly_tpu_torch.rl.agent_ar import AgentAR, load_uhc
from kinpoly_tpu_torch.utils.logger import create_logger

def standing_take(spec, n_frames: int = 120, seed: int = 0,
                  action: str = "sit", walk: float = 0.003) -> dict:
    """A seeded take: the standing pose with a cumulative uniform walk of
    the joint angles (+-`walk` rad per frame), the action's object 1 m
    ahead."""
    q = standing_pose(spec)[0].astype(np.float32)
    rng = np.random.RandomState(seed)
    seq = np.repeat(q[None], n_frames, 0)
    seq[:, 7:] += np.cumsum(rng.uniform(-walk, walk, (n_frames, 69)),
                            0).astype(np.float32)
    obj = np.zeros((n_frames, 7), np.float32)
    obj[:, :3] = [1.0, 0.5, 0.4]
    obj[:, 3] = 1
    return statear.derive_features(spec, seq, obj, action=action)


def get_takes(spec, data: str | None, n_takes: int | None = None,
              n_frames: int | None = None) -> list[dict]:
    """The takes of `data` (the first `n_takes`, each cut to its first
    `n_frames` frames), or the seeded standing take."""
    if not data:
        return [standing_take(spec, n_frames or 120)]
    takes = statear.load_annotations(data, spec=spec)[:n_takes]
    if n_frames:
        takes = [{k: (v[:n_frames] if isinstance(v, np.ndarray)
                      and v.shape[:1] == t["qpos"].shape[:1] else v)
                  for k, v in t.items()} for t in takes]
    return takes


@dataclass
class AREval:
    """What one evaluation runs on."""
    model: eng.PhysicsModel
    env: HumanoidAREnv
    agent: AgentAR
    batch: ClipData           # the padded whole takes, tensors
    ctx: ARContext
    names: list
    loaded: bool              # the checkpoint was found

    @property
    def n_takes(self) -> int:
        return len(self.names)


def build_eval(takes: list[dict], iter_: int, device, dtype=torch.float32,
               uhc_checkpoint: str | None = None, out_root: str = "results",
               cfg: KinPolyConfig | None = None) -> AREval:
    """The AR env over `takes` with the policy of checkpoint `iter_`, and
    the context bank (the AR rollout of every take)."""
    device = resolve_device(device)
    cfg = cfg or KinPolyConfig()
    spec = synthetic_spec(with_objects=True)
    model = eng.build_model(spec, uhc_control_params(spec), device=device,
                            dtype=dtype, with_objects=True,
                            movable_objects=True, compact_k=(16, 8))
    if uhc_checkpoint:
        cc_policy, cc_norm = load_uhc(uhc_checkpoint, device, dtype)
    else:
        cc_policy = nets.init_flax_(nets.PolicyMCP(784, 75),
                                    torch.Generator().manual_seed(0))
        cc_policy = cc_policy.to(device=device, dtype=dtype)
        cc_norm = rn.init(784, device)
    ps = cfg.policy_specs
    env = HumanoidAREnv(
        model, cfg.traj_ar_config(), UHCConfig().env_config(),
        cfg.reward_weights(), None, cc_policy, cc_norm, mode="test",
        body_diff_thresh=ps.get("body_diff_thresh", 10.0),
        policy_v=ps.get("policy_v", 1))
    t_max = max(t["qpos"].shape[0] for t in takes)
    dataset = statear.StateARDataset(takes, fr_num=t_max)
    agent = AgentAR(env, dataset, cfg.train_config())
    ckpt = os.path.join(cfg.model_dir(out_root), f"iter_{iter_:04d}.p")
    loaded = os.path.exists(ckpt)
    if loaded:
        agent.load_checkpoint(ckpt)
    batch = statear.clip_tensors(statear.stack_clips([
        dataset.whole_take(i, use_of=cfg.use_of, pad_to=t_max)
        for i in range(dataset.n_takes)]), dtype, device)
    env.ctx = agent.build_context(batch, fix_height=True)
    return AREval(model=model, env=env, agent=agent, batch=batch,
                  ctx=env.ctx, loaded=loaded,
                  names=[t.get("name", f"take_{i}") for i, t in enumerate(takes)])


def rollout(ev: AREval, n_steps: int, fail_safe: bool = False):
    """`n_steps` control steps of one env per take from its reset, mean
    actions: the trajectory (T, N, ...)."""
    run = roa.make_ar_rollout(ev.env, ev.agent.policy, n_steps,
                              fail_safe=fail_safe)
    carry = roa.init_ar_rollout_state(
        ev.env, ev.agent.policy, torch.arange(ev.n_takes, device=ev.model.device))
    return run(carry)[1]


@torch.no_grad()
def take_rows(ev: AREval, traj: roa.ARTrajectory) -> tuple[list, list]:
    """Per take, up to its first termination (and its true length - 1):
    (metric rows {name: float}, result records for the coverage pickles)."""
    model, batch = ev.model, ev.batch
    masks = traj.masks.cpu().numpy()
    head = model.spec.body_index("Head")
    rows, records = [], []
    for i in range(ev.n_takes):
        done = np.nonzero(masks[:, i] == 0)[0]
        end = int(done[0]) + 1 if len(done) else masks.shape[0]
        end = min(end, int(batch.length[i]) - 1)
        percent = float(traj.percents[end - 1, i])
        fs_count = int(traj.fails[:end, i].sum())
        pred = traj.res_qpos[:end, i]
        gt = batch.qpos[i, 1:end + 1]
        m = {k: float(v) for k, v in pose_metrics.evaluate_pair(
            model, pred, gt).items()}
        m["percent"] = percent
        m["fail_safe"] = fs_count
        a_oh = batch.action_one_hot[i, 0]
        action = (pose_metrics.ACTIONS[int(a_oh.argmax())]
                  if float(a_oh.sum()) > 0 else "None")
        obj_i = traj.obj_qpos[:end, i]
        succ = pose_metrics.action_success(
            model, pred, obj_i, action,
            head_pose_pred=fklib.fk(model.st, pred).xpos[:, head],
            head_pose_gt=fklib.fk(model.st, gt).xpos[:, head],
            fail_safe_used=fs_count > 0, verts=model.cand_verts,
            vert_body=model.cand_body)
        m["succ"] = float(succ)
        rows.append(m)
        records.append(dict(pred=pred.cpu().numpy(), gt=gt.cpu().numpy(),
                            percent=percent, fail_safe=fs_count > 0,
                            action=action, obj_pose=obj_i.cpu().numpy(),
                            succ=bool(succ)))
    return rows, records


def summary(rows: list, records: list) -> dict:
    """MEAN row, success per action and coverage (fail-safe counts as a
    failure)."""
    per_action = {}
    for r, rec in zip(rows, records):
        per_action.setdefault(rec["action"], []).append(r["succ"])
    return dict(
        mean={k: float(np.mean([r[k] for r in rows])) for k in rows[0]},
        succ={a: float(np.mean(v)) for a, v in sorted(per_action.items())},
        n_action={a: len(v) for a, v in sorted(per_action.items())},
        coverage=float(np.mean([r["percent"] >= 1.0 and r["fail_safe"] == 0
                                for r in rows])))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", default="kin_poly", choices=sorted(NAMED_KIN_CONFIGS))
    p.add_argument("--iter", type=int, required=True)
    p.add_argument("--data", default=None)
    p.add_argument("--uhc-checkpoint", default=None)
    p.add_argument("--wild", action="store_true")
    p.add_argument("--fail-safe", action="store_true")
    p.add_argument("--out", default="results")
    p.add_argument("--device", default="cuda")
    p.add_argument("--takes", type=int, default=None,
                   help="evaluate the first N takes of --data")
    p.add_argument("--frames", type=int, default=None,
                   help="cut every take to its first F frames")
    args = p.parse_args(argv)

    log = create_logger()
    cfg = KinPolyConfig.named(args.cfg)
    spec = synthetic_spec(with_objects=True)
    takes = get_takes(spec, args.data, args.takes, args.frames)
    t0 = time.perf_counter()
    ev = build_eval(takes, args.iter, args.device,
                    uhc_checkpoint=args.uhc_checkpoint, out_root=args.out,
                    cfg=cfg)
    if not ev.loaded:
        log.info(f"checkpoint iter {args.iter} not found under "
                 f"{cfg.model_dir(args.out)}; evaluating fresh weights")
    sync = (torch.cuda.synchronize if ev.model.device.type == "cuda"
            else lambda: None)
    sync()
    t_ctx = time.perf_counter() - t0
    n_steps = int(ev.batch.qpos.shape[1]) - 1
    t0 = time.perf_counter()
    traj = rollout(ev, n_steps, args.fail_safe)
    sync()
    t_run = time.perf_counter() - t0
    log.info(f"{ev.n_takes} takes, {n_steps} control steps on "
             f"{ev.model.device}: set-up and context {t_ctx:.2f} s, rollout "
             f"{t_run:.2f} s ({t_run / n_steps * 1e3:.1f} ms per control step)")

    rows, records = take_rows(ev, traj)
    res_dir = os.path.join(cfg.out_dir(args.out), "results")
    os.makedirs(res_dir, exist_ok=True)
    tag = "wild_" if args.wild else ""
    for i, (m, rec) in enumerate(zip(rows, records)):
        with open(os.path.join(res_dir, f"{args.iter:04d}_{tag}take{i}"
                               f"_coverage_full.pkl"), "wb") as f:
            pickle.dump(rec, f)
        log.info(f"take {i} {ev.names[i]} [{rec['action']}]: pct "
                 f"{m['percent']:.2f} fs {m['fail_safe']} " + " ".join(
                     f"{k}:{v:.3f}" for k, v in m.items() if k != "fail_safe"))
    s = summary(rows, records)
    log.info("MEAN  " + " ".join(f"{k}:{v:.3f}" for k, v in s["mean"].items()))
    for a, v in s["succ"].items():
        log.info(f"succ[{a}]: {v:.3f} ({s['n_action'][a]} takes)")
    log.info(f"coverage: {s['coverage']:.4f} over {ev.n_takes} takes "
             f"(fail-safe counted as failure)")


if __name__ == "__main__":
    main()
