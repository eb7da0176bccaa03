"""Harvest hard start states for reactive_v 2 training (port of
``scripts/gen_states.py``).

    python -m kinpoly_tpu_torch.scripts.gen_states --data data_bank/clips24.pkl \\
        [--checkpoint results/motion_im/uhc/models/iter_13000.p] \\
        [--n-envs 256] [--steps 64] [--rounds 4] [--out data_bank/hard_states.pkl]

Runs the policy (fresh weights, or ``--checkpoint``'s) with exploration
over the takes of ``--data`` in training rollouts of ``--n-envs`` envs x
``--steps`` control steps, ``--rounds`` times, and keeps the simulated
states at the steps where an env failed: finite, pelvis above ``--min-z``,
every |qvel| < 25. Writes up to ``--max-states`` of them as
``{"qpos": (K, 76), "qvel": (K, 75)}`` float32, a plain pickle (protocol
4) that ``data.banks.read_bank`` and ``joblib.load`` both read, for
``train_uhc --hard-states``.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import standing_pose, synthetic_spec
from kinpoly_tpu_torch.config.defaults import uhc_control_params
from kinpoly_tpu_torch.data.banks import load_takes
from kinpoly_tpu_torch.envs.humanoid_im import EnvConfig, HumanoidImEnv, make_bank
from kinpoly_tpu_torch.models import nets, weights
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.rl import rollout as ro
from kinpoly_tpu_torch.rl import running_norm as rn
from kinpoly_tpu_torch.utils.logger import create_logger

MAX_ABS_QVEL = 25.0


def harvest(env: HumanoidImEnv, policy, norm: rn.RunningNorm, n_envs: int,
            steps: int, rounds: int, min_z: float,
            generator: torch.Generator, log):
    """(qpos (K, 76), qvel (K, 75)) float32 numpy of the kept failure
    states of `rounds` rollouts, in rollout order; one `log` line a round."""
    device = env.model.device
    probs = torch.full((env.n_clips,), 1.0 / env.n_clips,
                       dtype=env.model.dtype, device=device)
    rollout = ro.make_rollout(env, policy, steps, noise_rate=1.0)
    carry = ro.init_rollout_state(env, generator, n_envs, probs)
    hard_q, hard_v = [], []
    for r in range(rounds):
        carry, traj = rollout(carry, norm, probs, generator)
        fails = traj.fails
        q, v = traj.qpos[fails], traj.qvel[fails]
        keep = (torch.isfinite(q).all(1) & torch.isfinite(v).all(1)
                & (q[:, 2] > min_z) & (v.abs().max(1).values < MAX_ABS_QVEL))
        hard_q.append(q[keep].cpu().numpy())
        hard_v.append(v[keep].cpu().numpy())
        log.info(f"round {r}: {int(fails.sum())} failure steps, kept "
                 f"{int(keep.sum())} states")
    return (np.concatenate(hard_q).astype(np.float32),
            np.concatenate(hard_v).astype(np.float32))


def write_states(path: str, qpos: np.ndarray, qvel: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(dict(qpos=qpos, qvel=qvel), f, protocol=4)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True, help="expert bank (data_bank/*.pkl)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--n-envs", type=int, default=256)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--max-states", type=int, default=4096)
    p.add_argument("--min-z", type=float, default=0.3,
                   help="pelvis-height floor for kept states; ~0.05 to keep "
                        "supine and get-up failures")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="data_bank/hard_states.pkl")
    args = p.parse_args(argv)

    log = create_logger()
    device = resolve_device(args.device)
    spec = synthetic_spec()
    model = eng.build_model(spec, uhc_control_params(spec), device=device)
    bank = make_bank(spec, model, list(load_takes(args.data).values()))
    q0, v0 = standing_pose(spec)
    env = HumanoidImEnv(model, EnvConfig(), bank, q0, v0)
    generator = torch.Generator(device=device).manual_seed(0)
    policy = nets.PolicyMCP(env.obs_dim, env.action_dim).to(device=device)
    norm = rn.init(env.obs_dim, device)
    if args.checkpoint:
        ck = weights.load_uhc_checkpoint(args.checkpoint)
        policy.load_state_dict(ck["policy"])
        norm = rn.RunningNorm(*(x.to(device) for x in ck["norm"]))
    else:
        nets.init_flax_(policy, generator)
    hq, hv = harvest(env, policy, norm, args.n_envs, args.steps, args.rounds,
                     args.min_z, generator, log)
    hq, hv = hq[:args.max_states], hv[:args.max_states]
    write_states(args.out, hq, hv)
    log.info(f"wrote {len(hq)} hard states to {args.out}")


if __name__ == "__main__":
    main()
