"""Train the UHC controller with PPO on the port (port of
``scripts/train_uhc.py``).

    python -m kinpoly_tpu_torch.scripts.train_uhc --device cuda --iters 100
    python -m kinpoly_tpu_torch.scripts.train_uhc --device cpu --iters 1 \\
        --n-envs 2 --rollout-steps 3 --clips 2 --frames 10

Builds the UHC env (uhc.yml, LTDL solver as the JAX script uses on an
accelerator) on the synthetic SMPL humanoid with ``--clips`` seeded clips of
``--frames`` frames (made as ``scripts/eval_uhc.py`` makes them), then runs
``--iters`` PPO iterations from the current epoch with the adaptive
schedules, logging one line per iteration, a coverage evaluation every 200
iterations, and checkpoints under ``<out>/motion_im/uhc/models``: every
``save_model_interval`` iterations and at the end of the run.
"""

from __future__ import annotations

import argparse
import os

import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import standing_pose, synthetic_spec
from kinpoly_tpu_torch.config.defaults import UHCConfig, uhc_control_params
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, make_bank
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.rl.agent_uhc import UHCAgent
from kinpoly_tpu_torch.scripts.eval_uhc import make_clips

EPILOG = """Not yet: --data and --hard-states (the expert bank and the
reactive_v 2 start bank) wait for a reader of the joblib banks in
data_bank/; wandb logging is not ported."""


def build_trainer(n_envs: int | None = None, rollout_steps: int | None = None,
                  n_clips: int = 24, n_frames: int = 120, seed: int = 0,
                  device=None, dtype=torch.float32, out_root: str = "results",
                  **model_kw) -> tuple[UHCAgent, UHCConfig]:
    """A fresh UHC agent (uhc.yml widths) on an env of `n_clips` seeded
    clips, and its config. `model_kw` goes to ``engine.build_model`` (e.g.
    ``use_pallas_chol=True`` for the dense configuration)."""
    device = resolve_device(device)
    cfg = UHCConfig()
    tc = cfg.train_config()
    if n_envs:
        tc.n_envs = n_envs
    if rollout_steps:
        tc.rollout_steps = rollout_steps
    spec = synthetic_spec()
    model = eng.build_model(spec, uhc_control_params(spec), device=device,
                            dtype=dtype, **model_kw)
    bank = make_bank(spec, model, make_clips(spec, n_clips, n_frames, seed))
    q0, v0 = standing_pose(spec)
    env = HumanoidImEnv(model, cfg.env_config(), bank, q0, v0, mode="train")
    return UHCAgent(env, tc, out_dir=cfg.model_dir(out_root)), cfg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                epilog=EPILOG)
    p.add_argument("--iters", type=int, required=True,
                   help="iterations to run from the current epoch")
    p.add_argument("--iter", type=int, default=0,
                   help="resume from checkpoint iter_<iter>.p")
    p.add_argument("--n-envs", type=int, default=None)
    p.add_argument("--rollout-steps", type=int, default=None)
    p.add_argument("--clips", type=int, default=24)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--seed", type=int, default=0, help="seed of the clips")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="results")
    args = p.parse_args(argv)

    agent, cfg = build_trainer(args.n_envs, args.rollout_steps, args.clips,
                               args.frames, args.seed, args.device,
                               out_root=args.out)
    if args.iter > 0:
        agent.load_checkpoint(os.path.join(cfg.model_dir(args.out),
                                           f"iter_{args.iter:04d}.p"))
    start = agent.epoch
    for i in range(start, start + args.iters):
        m = agent.train_epoch(adaptive=cfg.adaptive_params(i))
        print(f"iter {i}  R {m['reward_mean']:.4f}  fail {m['fail_frac']:.3f}  "
              f"policy_loss {m['policy_loss']:.4g}  value_loss "
              f"{m['value_loss']:.4g}  T {m['T_iter']:.2f}s", flush=True)
        if (i + 1) % 200 == 0:
            cov, detail = agent.eval_coverage()
            print(f"iter {i}  coverage {cov:.3f}  mean tracked "
                  f"{float(detail['percent'].mean()):.1%}", flush=True)
    # a run that ends between save_model_interval marks still leaves a
    # checkpoint to resume from
    if agent.epoch % agent.cfg.save_model_interval != 0:
        path = agent.save_checkpoint()
        print(f"saved final checkpoint {path}", flush=True)


if __name__ == "__main__":
    main()
