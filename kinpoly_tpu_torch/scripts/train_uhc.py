"""Train the UHC controller with PPO on the port (port of
``scripts/train_uhc.py``).

    python -m kinpoly_tpu_torch.scripts.train_uhc --data data_bank/clips24.pkl \\
        [--cfg uhc_quatv2 | --cfg my_explicit.yml] \\
        [--hard-states data_bank/hard_states_getup.pkl] \\
        [--max-iters 100] [--iter 100]
    python -m kinpoly_tpu_torch.scripts.train_uhc --device cpu --max-iters 1 \\
        --n-envs 2 --rollout-steps 3 --data data_bank/clips24.pkl --out /tmp/uhc

``--cfg`` is a named config or a path to a UHC YAML (named after its
basename), whose control parameters the physics takes: the residual-force
scale and limit, implicit or explicit residual forces (their bodies and
torques) and meta-PD; the policy's action width follows them. Builds the
UHC env of ``--cfg`` (LTDL solver, as the JAX script uses on an
accelerator) on the synthetic SMPL humanoid over the takes of ``--data``
(a dict of takes with ``qpos`` (T, 76), or one take), then trains from the
current epoch up to iteration ``--max-iters`` (default: the config's
``max_iter_num``) with the adaptive schedules. ``--hard-states`` (a
``{"qpos", "qvel"}`` bank, e.g. from ``gen_states``) sets ``reactive_v`` 2:
training resets start from those states at ``reactive_rate``. Logs one line
per iteration to stdout and ``<out>/motion_im/<cfg>/log.txt``, every
iteration's metrics to ``<out>/motion_im/<cfg>/models/uhc_<cfg>_metrics.jsonl``
(and TensorBoard, if it imports), a coverage evaluation every 200
iterations, and checkpoints beside the stream: every
``save_model_interval`` iterations and at the end of the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import standing_pose, synthetic_spec
from kinpoly_tpu_torch.config.defaults import UHCConfig
from kinpoly_tpu_torch.data.banks import load_hard_states
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, make_bank
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.rl.agent_uhc import UHCAgent
from kinpoly_tpu_torch.scripts.eval_uhc import get_takes
from kinpoly_tpu_torch.utils.logger import create_logger
from kinpoly_tpu_torch.utils.metrics_log import MetricsLogger

EPILOG = """Without --data the takes are --clips seeded clips of --frames
frames (the JAX script's standing fixture needs the reference assets).
wandb logging is not ported."""


def build_trainer(takes: dict, cfg: UHCConfig, n_envs: int | None = None,
                  rollout_steps: int | None = None, hard_states=None,
                  reactive_rate: float | None = None, device=None,
                  dtype=torch.float32, out_root: str = "results",
                  **model_kw) -> UHCAgent:
    """A fresh UHC agent of `cfg` on a training env over `takes`, its
    physics built from ``cfg.control_params`` (as the JAX trainer's); with
    `hard_states` (qpos (K, 76), qvel (K, 75)) the env resets with
    reactive_v 2. `model_kw` goes to ``engine.build_model`` (e.g.
    ``use_pallas_chol=True`` for the dense configuration)."""
    device = resolve_device(device)
    tc = cfg.train_config()
    if n_envs:
        tc.n_envs = n_envs
    if rollout_steps:
        tc.rollout_steps = rollout_steps
    spec = synthetic_spec()
    model = eng.build_model(spec, cfg.control_params(spec), device=device,
                            dtype=dtype, **model_kw)
    bank = make_bank(spec, model, list(takes.values()))
    env_cfg = cfg.env_config()
    if hard_states is not None:
        env_cfg = dataclasses.replace(env_cfg, reactive_v=2)
    if reactive_rate is not None:
        env_cfg = dataclasses.replace(env_cfg, reactive_rate=reactive_rate)
    q0, v0 = standing_pose(spec)
    env = HumanoidImEnv(model, env_cfg, bank, q0, v0, mode="train",
                        hard_states=hard_states)
    return UHCAgent(env, tc, out_dir=cfg.model_dir(out_root))


def train(agent: UHCAgent, cfg: UHCConfig, max_iters: int,
          mlog: MetricsLogger, log) -> None:
    """Iterations agent.epoch .. max_iters - 1, each logged as a line and a
    metrics record, with a coverage evaluation every 200."""
    for i in range(agent.epoch, max_iters):
        m = agent.train_epoch(adaptive=cfg.adaptive_params(i))
        mlog.log(i, m)
        log.info(f"iter {i}  R {m['reward_mean']:.4f}  fail {m['fail_frac']:.3f}  "
                 f"policy_loss {m['policy_loss']:.4g}  value_loss "
                 f"{m['value_loss']:.4g}  T {m['T_iter']:.2f}s")
        if (i + 1) % 200 == 0:
            cov, detail = agent.eval_coverage()
            tracked = float(detail["percent"].mean())
            mlog.log(i, dict(coverage=cov, mean_tracked=tracked), prefix="eval/")
            log.info(f"iter {i}  coverage {cov:.3f}  mean tracked {tracked:.1%}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                epilog=EPILOG)
    p.add_argument("--cfg", default="uhc",
                   help="a named config (uhc, uhc_quatv2) or a UHC YAML path")
    p.add_argument("--data", default=None,
                   help="expert bank (data_bank/*.pkl); default: seeded clips")
    p.add_argument("--hard-states", default=None,
                   help="reactive_v 2 start bank {'qpos': (K, 76), "
                        "'qvel': (K, 75)}, e.g. from gen_states")
    p.add_argument("--reactive-rate", type=float, default=None)
    p.add_argument("--max-iters", type=int, default=None,
                   help="train up to this iteration (default: max_iter_num)")
    p.add_argument("--iter", type=int, default=0,
                   help="resume from checkpoint iter_<iter>.p")
    p.add_argument("--n-envs", type=int, default=None)
    p.add_argument("--rollout-steps", type=int, default=None)
    p.add_argument("--clips", type=int, default=None,
                   help="seeded clips (24), or the first takes of --data")
    p.add_argument("--frames", type=int, default=None,
                   help="frames of the seeded clips (120), or the first "
                        "frames of each take of --data")
    p.add_argument("--seed", type=int, default=0, help="seed of the clips")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="results")
    args = p.parse_args(argv)

    cfg = UHCConfig.load(args.cfg)
    log = create_logger(os.path.join(cfg.out_dir(args.out), "log.txt"))
    hard_states = None
    if args.hard_states:
        hard_states = load_hard_states(args.hard_states)
        log.info(f"reactive_v 2 with {len(hard_states[0])} hard states from "
                 f"{args.hard_states}")
    agent = build_trainer(
        get_takes(args.data, args.clips, args.frames, args.seed), cfg,
        args.n_envs, args.rollout_steps, hard_states, args.reactive_rate,
        args.device, out_root=args.out)
    if args.iter > 0:
        agent.load_checkpoint(os.path.join(cfg.model_dir(args.out),
                                           f"iter_{args.iter:04d}.p"))
    with MetricsLogger(cfg.model_dir(args.out), run_name=f"uhc_{cfg.name}") as mlog:
        train(agent, cfg, args.max_iters or cfg.max_iter_num, mlog, log)
    # a run that ends between save_model_interval marks still leaves a
    # checkpoint to resume from
    if agent.epoch % agent.cfg.save_model_interval != 0:
        log.info(f"saved final checkpoint {agent.save_checkpoint()}")


if __name__ == "__main__":
    main()
