"""Train the dynamics-regulated kinematic policy on the port (port of
``scripts/train_ar_policy.py``).

    python -m kinpoly_tpu_torch.scripts.train_ar_policy \\
        --data data_bank/ar_train_56.pkl \\
        --uhc-checkpoint results/motion_im/uhc/models/iter_13000.p --out DIR \\
        [--iter 800 --skip-init --joint-controller] [--max-epochs N] \\
        [--init-steps K --full-steps K] [--device cpu]

Builds the AR env (mode "train") on the synthetic humanoid with its five
movable objects (contact plan, LTDL, active-set compaction (16, 8) unless
``--no-compact``: kernels K1, K2 and K3 on CUDA) and the UHC controller
of ``--uhc-checkpoint`` (a fresh one without it), over the takes of
``--data`` (without it, one seeded take: the standing pose with a
cumulative joint walk). Resumes ``<out>/statear/<cfg>/models/
iter_<iter>.p`` when ``--iter`` is given or ``iter_0000.p`` exists (with
``--force-init`` the warm start runs again after it); otherwise, unless
``--skip-init``, runs the supervised warm start, guarded by the liveness
check, and saves ``iter_0000.p``. Then composite epochs up to
``--max-epochs`` (the config's max_iter_num by default), one metrics line
each to ``ar_<cfg>_metrics.jsonl`` beside the checkpoints, and a final
checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import synthetic_spec
from kinpoly_tpu_torch.config.defaults import (KinPolyConfig, UHCConfig,
                                               uhc_control_params)
from kinpoly_tpu_torch.data import statear
from kinpoly_tpu_torch.envs.humanoid_ar import HumanoidAREnv
from kinpoly_tpu_torch.models import nets
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.rl import running_norm as rn
from kinpoly_tpu_torch.rl.agent_ar import AgentAR, ARTrainConfig, load_uhc
from kinpoly_tpu_torch.scripts.eval_ar_policy import standing_take
from kinpoly_tpu_torch.utils.liveness import (NAN_FRAC_WARN,
                                              check_supervised_liveness)
from kinpoly_tpu_torch.utils.logger import create_logger
from kinpoly_tpu_torch.utils.metrics_log import MetricsLogger


def get_takes(spec, data: str | None) -> list[dict]:
    """The takes of `data`, or one seeded standing take of 240 frames (a
    cumulative +-0.005 rad joint walk)."""
    if data:
        return statear.load_annotations(data, spec=spec)
    return [standing_take(spec, 240, walk=0.005)]


def build_agent(takes: list[dict], cfg: KinPolyConfig, tc: ARTrainConfig,
                device, dtype=torch.float32, uhc_checkpoint: str | None = None,
                compact: bool = True, out_dir: str | None = None) -> AgentAR:
    """The AR trainer over `takes`: the env in mode "train" with the
    config's thresholds and reward, the controller of `uhc_checkpoint`
    (a fresh seeded one without it)."""
    device = resolve_device(device)
    spec = synthetic_spec(with_objects=True)
    model = eng.build_model(spec, uhc_control_params(spec), device=device,
                            dtype=dtype, with_objects=True,
                            movable_objects=True,
                            compact_k=(16, 8) if compact else None)
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
        cfg.reward_weights(), None, cc_policy, cc_norm, mode="train",
        body_diff_thresh=ps.get("body_diff_thresh", 10.0),
        body_diff_gt_thresh=ps.get("body_diff_gt_thresh", 12.0),
        policy_v=ps.get("policy_v", 1))
    dataset = statear.StateARDataset(takes, fr_num=cfg.fr_num)
    return AgentAR(env, dataset, tc, out_dir=out_dir)


def run_train_init(agent: AgentAR, init_steps: int, full_steps: int,
                   log, log_every: int = 10) -> dict:
    """The warm start with the silent-freeze watchdog: each phase's loss
    curve must drop (``check_supervised_liveness``), and a step whose
    gradient held non-finite leaves is warned about. Returns the sampled
    (losses, nan fractions) per phase."""
    phases = {}
    t0 = time.perf_counter()
    for tag, i, loss, nan_frac in agent.train_init(
            init_steps=init_steps, full_steps=full_steps, log_every=log_every):
        phases.setdefault(tag, ([], []))
        phases[tag][0].append(loss)
        phases[tag][1].append(nan_frac)
        extra = (f"  [WARN zero_nans hit {nan_frac:.0%} of grad leaves]"
                 if nan_frac > NAN_FRAC_WARN else "")
        log.info(f"  {tag} step {i}: loss {loss:.4f}{extra}")
    peak = (f", peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if agent.device.type == "cuda" else "")
    log.info(f"warm start: {init_steps} init-state and {full_steps} full-AR "
             f"steps in {time.perf_counter() - t0:.1f} s{peak}")
    for tag, (losses, nfs) in phases.items():
        check_supervised_liveness(losses, phase=f"train_init/{tag}",
                                  nan_fracs=nfs)
    return phases


def main(argv=None, cfg: KinPolyConfig | None = None):
    """The script; `cfg` replaces the named config (small nets in tests)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", default="kin_poly")
    p.add_argument("--data", default=None)
    p.add_argument("--uhc-checkpoint", default=None)
    p.add_argument("--iter", type=int, default=0)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--skip-init", action="store_true")
    p.add_argument("--no-compact", action="store_true",
                   help="no contact active-set compaction")
    p.add_argument("--force-init", action="store_true",
                   help="run the warm start even after resuming a checkpoint")
    p.add_argument("--init-steps", type=int, default=500)
    p.add_argument("--full-steps", type=int, default=50)
    p.add_argument("--n-envs", type=int, default=None)
    p.add_argument("--rollout-steps", type=int, default=None)
    p.add_argument("--joint-controller", action="store_true",
                   help="tune the UHC controller jointly")
    p.add_argument("--no-rl-update", action="store_true",
                   help="no PPO half of the composite update (BC only)")
    p.add_argument("--step-update-dyna", action="store_true",
                   help="add BC toward the simulated result pose")
    p.add_argument("--out", default="results")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = cfg or KinPolyConfig.named(args.cfg)
    log = create_logger(os.path.join(cfg.out_dir(args.out), "log.txt"))
    model_dir = cfg.model_dir(args.out)
    tc = cfg.train_config()
    over = dict(n_envs=args.n_envs, rollout_steps=args.rollout_steps)
    tc = dataclasses.replace(tc, **{k: v for k, v in over.items() if v})
    if args.joint_controller:
        tc = dataclasses.replace(tc, joint_controller=True)
    if args.step_update_dyna:
        tc = dataclasses.replace(tc, step_update_dyna=True)
    if args.no_rl_update:
        tc = dataclasses.replace(tc, rl_update=False)

    spec = synthetic_spec(with_objects=True)
    if not args.data:
        log.info("no --data; a seeded standing take")
    if not args.uhc_checkpoint:
        log.info("no --uhc-checkpoint; a fresh (untrained) UHC policy")
    agent = build_agent(get_takes(spec, args.data), cfg, tc, device,
                        uhc_checkpoint=args.uhc_checkpoint,
                        compact=not args.no_compact, out_dir=model_dir)

    ckpt = os.path.join(model_dir, f"iter_{args.iter:04d}.p")
    if args.iter > 0 or os.path.exists(ckpt):
        agent.load_checkpoint(ckpt)
        log.info(f"resumed {ckpt} (epoch {agent.epoch})")
        if args.force_init:
            log.info("supervised continuation (train_init on resume)...")
            run_train_init(agent, args.init_steps, args.full_steps, log)
            agent.save_checkpoint(os.path.join(model_dir,
                                               f"iter_{agent.epoch:04d}.p"))
    elif not args.skip_init:
        log.info("supervised warm start (train_init)...")
        run_train_init(agent, args.init_steps, args.full_steps, log)
        log.info(f"saved warm-start checkpoint "
                 f"{agent.save_checkpoint(os.path.join(model_dir, 'iter_0000.p'))}")

    max_epochs = (args.max_epochs if args.max_epochs is not None
                  else cfg.policy_specs.get("max_iter_num", 20000))
    with MetricsLogger(model_dir, run_name=f"ar_{cfg.name}") as mlog:
        for i in range(agent.epoch, max_epochs):
            m = agent.optimize_policy()
            mlog.log(i, m)
            nan_warn = (f"  [WARN zero_nans hit {m['bc_nan_frac']:.0%} of BC "
                        f"grad leaves]" if m["bc_nan_frac"] > NAN_FRAC_WARN
                        else "")
            log.info(
                f"epoch {i}  R {m['reward_mean']:.4f}  bc {m['bc_loss']:.4f}  "
                f"ppo {m['ppo_loss']:.4f}  fail {m['fail_frac']:.3f}  "
                f"|r-1| {m['ratio_dev']:.4f}  pg {m['ppo_grad_norm']:.2f}  "
                f"advs {m['adv_std']:.3f}  T {m['T_iter']:.2f}s{nan_warn}")
    # a run that ends between save_model_interval marks keeps its last epoch
    if agent.epoch % tc.save_model_interval != 0:
        log.info(f"saved final checkpoint {agent.save_checkpoint()}")
    return agent


if __name__ == "__main__":
    main()
