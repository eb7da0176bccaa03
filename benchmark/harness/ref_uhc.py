"""The UHC side of the frozen reference (``refimpl``, a float64 copy of the
port's plain paths): the imitation env, the MCP policy and value net of a
checkpoint, and the training iteration's update, built from the cell's
configuration file and the raw files the traffic names. Imports nothing of
the program."""

from __future__ import annotations

import dataclasses

import torch

from harness import probe
from refimpl.anim.spec import standing_pose, synthetic_spec
from refimpl.config.defaults import UHCConfig
from refimpl.data.banks import load_hard_states, load_takes
from refimpl.envs.humanoid_im import HumanoidImEnv, make_bank
from refimpl.models import nets, weights
from refimpl.physics import engine as eng
from refimpl.rl import gae, ppo
from refimpl.rl import running_norm as rn
from refimpl.rl.agent_uhc import make_policy


def config_from_file(values: dict) -> UHCConfig:
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in values.items()}
    return UHCConfig(**kw)


def build_env(values: dict, traffic: dict, root, device, dtype=torch.float64):
    """The training env of the configuration over the traffic's bank (the
    hard-state bank, if the traffic names one, sets reactive_v 2)."""
    cfg = config_from_file(values)
    spec = synthetic_spec()
    model = eng.build_model(spec, cfg.control_params(spec), device=device,
                            dtype=dtype)
    takes = load_takes(str(root / traffic["bank"]))
    bank = make_bank(spec, model, list(takes.values()))
    env_cfg = cfg.env_config()
    hard = None
    if traffic.get("hard_states"):
        hard = load_hard_states(str(root / traffic["hard_states"]))
        env_cfg = dataclasses.replace(env_cfg, reactive_v=2)
    q0, v0 = standing_pose(spec)
    return HumanoidImEnv(model, env_cfg, bank, q0, v0, mode="train",
                         hard_states=hard), cfg


def load_nets(cfg: UHCConfig, path: str, obs_dim: int, action_dim: int,
              device, dtype=torch.float64):
    """(policy, value, norm) of a UHC checkpoint; the norm as saved."""
    tc = cfg.train_config()
    ck = weights.load_uhc_checkpoint(path)
    policy = make_policy(tc, obs_dim, action_dim)
    policy.load_state_dict(ck["policy"])
    value = nets.Value(obs_dim, tc.value_hsize)
    value.load_state_dict(ck["value"])
    norm = rn.RunningNorm(*(x.to(device) for x in ck["norm"]))
    return (policy.to(device=device, dtype=dtype),
            value.to(device=device, dtype=dtype), norm, tc)


def to_ref(x, device, dtype=torch.float64):
    if x is None:
        return None
    if isinstance(x, tuple):
        return probe._same(x, (to_ref(y, device, dtype) for y in x))
    y = x.to(device)
    return y.to(dtype) if y.is_floating_point() else y


def ppo_iteration(policy, value, tc, norm0, traj, carry_obs, gen_state,
                  snap_policy, snap_value, device, patch):
    """What one iteration's update does after its rollout, on the program's
    recorded trajectory: the running-norm update, GAE over the reference's
    values and the PPO update, its minibatches drawn from a generator in
    the state the program's generator was in after its rollout. Returns
    (new norm, metrics)."""
    dt = torch.float64
    raw = traj["raw_obs"].to(device, dt)
    obs_n = rn.apply(norm0, raw)
    norm1 = rn.update_batch(norm0, raw)
    T, N = traj["rewards"].shape
    with torch.no_grad():
        values = value(obs_n)
        bootstrap = value(rn.apply(norm0, carry_obs.to(device, dt)))
    adv, ret = gae.estimate_advantages(
        traj["rewards"].to(device, dt), traj["masks"].to(device, dt), values,
        tc.gamma, tc.tau, bootstrap)
    cfg = ppo.PPOConfig(
        clip_epsilon=tc.clip_epsilon, num_optim_epoch=tc.num_optim_epoch,
        mini_batch_size=tc.mini_batch_size, policy_lr=tc.policy_lr,
        value_lr=tc.value_lr, gamma=tc.gamma, tau=tc.tau,
        max_grad_norm=tc.max_grad_norm)
    popt, vopt = ppo.make_optimizers(policy, value, cfg)
    snap_policy.attach(popt, patch)
    snap_value.attach(vopt, patch)
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    flat = lambda x: x.reshape((T * N,) + x.shape[2:])
    metrics = ppo.ppo_update(
        policy, value, cfg, popt, vopt, gen, flat(obs_n),
        flat(traj["actions"].to(device, dt)), flat(adv), flat(ret),
        flat(traj["log_probs"].to(device, dt)))
    return norm1, {k: float(v) for k, v in metrics.items()}
