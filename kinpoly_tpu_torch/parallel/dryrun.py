"""The data-parallel training steps (port of ``__graft_entry__.py``
``dryrun_multichip`` and of the AR update under ``shard_map``): W ranks,
each stepping its own block of envs, with replicated nets and optimiser
states and gradients averaged across the ranks.

    python -m kinpoly_tpu_torch.parallel.dryrun --ranks 2 [--device cpu]

runs one UHC step on tiny nets (``dryrun_multichip``) and prints
``dryrun_multichip OK on <n> ranks; norm count=<c>``. On CUDA (the default)
several ranks share the card over gloo; NCCL is taken only with one card
per rank.

The UHC step (``dp_train_step``): the rank's rollout, then ``dp_update``:
- the observation norm merged across ranks by the JAX step's formula
  (``merge_norm``), which leaves out Chan's between-group term
  ``(mean_b - mean)^2 n n_b / (n + n_b)``: equal to ``update_batch`` over
  the union on the first step, smaller from the second on (kept for
  parity with the reference);
- GAE on the rank's block, bootstrapped under the old norm, its
  advantages normalised over the block;
- one value and one policy step on the whole block, through
  ``ppo._step`` with the gradients averaged across the ranks.

Random streams differ from JAX's (each rank seeds its own generator from
the seed and its rank, where JAX folds the rank into its key); the losses
and metrics a rank returns are its own, as JAX's ``out_specs=P()``.

The job functions (``*_job``) run inside the ranks of a
``parallel.ranks.RankPool``.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from kinpoly_tpu_torch import native, resolve_device
from kinpoly_tpu_torch.models import nets
from kinpoly_tpu_torch.parallel.mesh import (pmean_grads_, psum_, replica_gap,
                                             replicate_, shard_batch)
from kinpoly_tpu_torch.parallel.ranks import RankPool
from kinpoly_tpu_torch.rl import gae, ppo
from kinpoly_tpu_torch.rl import rollout as ro
from kinpoly_tpu_torch.rl import running_norm as rn


# the dry run: JAX's tiny nets, envs and control steps per rank
HIDDEN, COMPOSER_HIDDEN = (64, 64), (32, 32)
ENVS_PER_RANK, N_STEPS = 4, 2


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The rank's own generator (the counterpart of JAX's
    ``fold_in(key, axis_index)``)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + rank)


def merge_norm(norm: rn.RunningNorm, raw_obs: torch.Tensor,
               group) -> rn.RunningNorm:
    """`norm` with every rank's `raw_obs` (T, N, d) folded in, as the JAX
    step merges them: the ranks' own stats combined exactly by psum, then
    added to `norm` without the between-group term."""
    local = rn.update_batch(rn.init(raw_obs.shape[-1], raw_obs.device),
                            raw_obs)
    tot = psum_(local.count.clone(), group)
    mean = psum_(local.mean * local.count, group) / tot
    m2 = psum_(local.m2 + local.count * (local.mean - mean) ** 2, group)
    n = norm.count + tot
    return rn.RunningNorm(n, (norm.mean * norm.count + mean * tot) / n,
                          norm.m2 + m2)


def dp_update(policy, value, pol_opt, val_opt, norm: rn.RunningNorm,
              traj: ro.Trajectory, last_obs: torch.Tensor,
              cfg: ppo.PPOConfig, group):
    """The step after the rank's rollout `traj` (T, N, ...), `last_obs` its
    raw observation after the last step: the merged norm, GAE, one value
    and one policy step with the gradients averaged across `group`.
    Returns (merged norm, the rank's losses)."""
    merged = merge_norm(norm, traj.raw_obs, group)
    with torch.no_grad():
        values = value(traj.obs)
        bootstrap = value(rn.apply(norm, last_obs))
    adv, ret = gae.estimate_advantages(traj.rewards, traj.masks, values,
                                       cfg.gamma, cfg.tau, bootstrap)
    T, N = traj.rewards.shape

    def flat(x):
        return x.reshape((T * N,) + x.shape[2:])

    obs = flat(traj.obs)
    vl = torch.mean((value(obs) - flat(ret)) ** 2)
    ppo._step(val_opt, vl, cfg.max_grad_norm, group=group)
    mean, log_std = policy(obs)
    ratio = torch.exp(nets.gaussian_log_prob(flat(traj.actions), mean, log_std)
                      - flat(traj.log_probs))
    a = flat(adv)
    eps = cfg.clip_epsilon
    pl = -torch.mean(torch.minimum(ratio * a,
                                   torch.clamp(ratio, 1 - eps, 1 + eps) * a))
    ppo._step(pol_opt, pl, cfg.max_grad_norm, group=group)
    return merged, {"value_loss": vl.detach(), "policy_loss": pl.detach()}


@dataclass
class UHCReplica:
    """What a rank holds between UHC steps: its env and rollout, the
    replicated nets, optimisers and norm, its carry and generator."""
    env: object
    policy: torch.nn.Module
    value: torch.nn.Module
    pol_opt: torch.optim.Optimizer
    val_opt: torch.optim.Optimizer
    norm: rn.RunningNorm
    rollout: Callable
    carry: ro.RolloutState
    clip_probs: torch.Tensor
    generator: torch.Generator
    cfg: ppo.PPOConfig


def make_replica(env, policy, value, cfg: ppo.PPOConfig, n_envs: int,
                 n_steps: int, seed: int, rank: int, group) -> UHCReplica:
    """A rank's replica: rank 0's nets broadcast over the rank's own,
    fresh Adams, an empty norm, `n_envs` envs reset with the rank's
    generator on uniform clip probabilities."""
    device = env.model.device
    replicate_([policy, value], group)
    pol_opt, val_opt = ppo.make_optimizers(policy, value, cfg)
    gen = rank_generator(seed, rank, device)
    probs = torch.full((env.n_clips,), 1.0 / env.n_clips,
                       dtype=env.model.dtype, device=device)
    return UHCReplica(
        env=env, policy=policy, value=value, pol_opt=pol_opt, val_opt=val_opt,
        norm=rn.init(env.obs_dim, device),
        rollout=ro.make_rollout(env, policy, n_steps),
        carry=ro.init_rollout_state(env, gen, n_envs, probs),
        clip_probs=probs, generator=gen, cfg=cfg)


def dp_train_step(rep: UHCReplica, group) -> dict:
    """The rank's rollout, then ``dp_update``; updates `rep` in place and
    returns the rank's losses."""
    rep.carry, traj = rep.rollout(rep.carry, rep.norm, rep.clip_probs,
                                  rep.generator)
    rep.norm, losses = dp_update(rep.policy, rep.value, rep.pol_opt,
                                 rep.val_opt, rep.norm, traj, rep.carry.obs,
                                 rep.cfg, group)
    return losses


def standing_env(device, dtype):
    """The counterpart of ``__graft_entry__._build_env`` on the synthetic
    humanoid: two clips of the standing pose held 8 frames, padded to
    16."""
    from kinpoly_tpu_torch.anim.spec import standing_pose, synthetic_spec
    from kinpoly_tpu_torch.config.defaults import uhc_control_params
    from kinpoly_tpu_torch.data import expert as exlib
    from kinpoly_tpu_torch.envs.humanoid_im import EnvConfig, HumanoidImEnv
    from kinpoly_tpu_torch.physics import engine as eng

    spec = synthetic_spec()
    model = eng.build_model(spec, uhc_control_params(spec), device=device,
                            dtype=dtype)
    q0, v0 = standing_pose(spec)
    seq = torch.as_tensor(np.repeat(np.asarray(q0)[None], 8, axis=0),
                          dtype=dtype, device=device)
    clip = exlib.from_qpos(spec, model.st, seq, dt=model.control_dt,
                           pad_to=16)
    return HumanoidImEnv(model, EnvConfig(env_episode_len=100000),
                         exlib.stack_bank([clip, clip]), q0, v0)


def _sync(device: torch.device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def _run_steps(rk, rep: UHCReplica, steps: int) -> dict:
    """`steps` DP steps with the launch counters and the clock around
    them: per step the norm count, the losses and the replicas' gap; the
    rollouts' seconds apart."""
    sync = _sync(rk.device)
    start = [p.detach().clone() for p in rep.policy.parameters()]
    out = dict(counts=[], losses=[], gaps=[], step_s=[], rollout_s=0.0)
    rollout = rep.rollout

    def timed(*a, **kw):
        sync()
        t = time.perf_counter()
        res = rollout(*a, **kw)
        sync()
        out["rollout_s"] += time.perf_counter() - t
        return res

    rep.rollout = timed
    if rk.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    native.LAUNCHES.clear()
    for _ in range(steps):
        t = time.perf_counter()
        losses = dp_train_step(rep, rk.group)
        sync()
        out["step_s"].append(time.perf_counter() - t)
        out["counts"].append(float(rep.norm.count))
        out["losses"].append({k: float(v) for k, v in losses.items()})
        out["gaps"].append(replica_gap([rep.policy, rep.value], rk.group))
    out["launches"] = dict(native.LAUNCHES)
    out["moved"] = max(float((p.detach() - s).abs().max())
                       for p, s in zip(rep.policy.parameters(), start))
    out["finite"] = all(
        bool(torch.isfinite(x).all()) for x in
        [*rep.policy.parameters(), *rep.value.parameters(), *rep.norm,
         rep.carry.obs, rep.carry.env_state.sim.qpos])
    out["finite"] = out["finite"] and bool(np.isfinite(
        [v for d in out["losses"] for v in d.values()]).all())
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if rk.device.type == "cuda" else None)
    out["policy"] = {k: v.cpu() for k, v in rep.policy.state_dict().items()}
    return out


def dryrun_job(rk, steps: int, dtype) -> dict:
    """A rank of ``dryrun_multichip``."""
    env = standing_env(rk.device, dtype)
    gen = torch.Generator().manual_seed(0)
    policy = nets.init_flax_(nets.PolicyMCP(
        env.obs_dim, env.action_dim, hidden=HIDDEN,
        composer_hidden=COMPOSER_HIDDEN), gen).to(rk.device, dtype)
    value = nets.init_flax_(nets.Value(env.obs_dim, HIDDEN), gen).to(
        rk.device, dtype)
    cfg = ppo.PPOConfig(num_optim_epoch=2, mini_batch_size=64)
    rep = make_replica(env, policy, value, cfg, ENVS_PER_RANK, N_STEPS, 0,
                       rk.rank, rk.group)
    return _run_steps(rk, rep, steps)


def uhc_job(rk, takes: dict, n_envs: int, n_steps: int, steps: int) -> dict:
    """A rank of the UHC step at uhc.yml's widths on the bank `takes`
    ({name: qpos}), `n_envs` envs of `n_steps` control steps, `steps`
    steps; the launch counters cover the steps."""
    from kinpoly_tpu_torch.config.defaults import UHCConfig
    from kinpoly_tpu_torch.scripts.train_uhc import build_trainer

    cfg = UHCConfig()
    agent = build_trainer(takes, cfg, n_envs, n_steps, device=rk.device)
    rep = make_replica(agent.env, agent.policy, agent.value, agent.ppo_cfg,
                       n_envs, n_steps, agent.cfg.seed, rk.rank, rk.group)
    return _run_steps(rk, rep, steps)


def pmean_check_job(rk, seed: int) -> dict:
    """``pmean_grads_`` against the ranks' mean: each rank fills the
    gradients of a (512, 256) value net (its last bias left None) from
    its own seed; the mean is gathered by all-reducing a zero buffer that
    holds the rank's gradients in its own slot. Returns the largest error
    relative to max |mean|."""
    net = nets.Value(784, (512, 256)).to(rk.device)
    params = list(net.parameters())
    gen = torch.Generator(device=rk.device).manual_seed(seed + rk.rank)
    for p in params[:-1]:
        p.grad = torch.randn(p.shape, generator=gen, device=rk.device)
    local = torch.cat([p.grad.reshape(-1) for p in params[:-1]])
    slots = torch.zeros((rk.world_size,) + local.shape, device=rk.device)
    slots[rk.rank] = local
    psum_(slots, rk.group)
    want = slots.double().mean(dim=0)
    pmean_grads_(params, rk.group)
    got = torch.cat([p.grad.reshape(-1) for p in params[:-1]]).double()
    return dict(rel_err=float((got - want).abs().max() / want.abs().max()),
                none_kept=params[-1].grad is None, n=int(local.numel()))


def dp_ar_step(agent, group) -> tuple[dict, tuple[float, float]]:
    """One data-parallel composite AR step: the same `n_envs` windows on
    every rank (each rank's window sampler holds the same seed), the
    context built on every rank and then replaced by rank 0's, the rank's
    block of envs rolled out on it (clips ``arange(n_envs)[block] %
    n_windows``) and ``update`` with the gradients averaged across
    `group`. Returns (the rank's metrics, the largest difference between
    the ranks' own contexts before the broadcast, and after it)."""
    from kinpoly_tpu_torch.rl import rollout_ar as roa

    cfg = agent.cfg
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    with agent._phase("context"):
        ctx = agent.build_context(agent._get_batch(cfg.n_envs))
        before = replica_gap(ctx, group)
        replicate_(ctx, group)
        gaps = (before, replica_gap(ctx, group))
    clips = shard_batch(torch.arange(cfg.n_envs, device=agent.device), rank,
                        world) % ctx.qpos.shape[0]
    carry = roa.init_ar_rollout_state(agent.env, agent.policy, clips, ctx)
    agent.group = group
    _, _, metrics = agent._rl_and_step_update(carry, ctx)
    return metrics, gaps


def ar_job(rk, takes: list, uhc_checkpoint: str, ar_checkpoint: str,
           n_envs: int, n_steps: int, steps: int) -> dict:
    """A rank of the AR step: ``train_ar_policy``'s agent at
    kin_poly.yml's widths with the joint controller, resumed from
    `ar_checkpoint`, `n_envs` envs over all ranks, `n_steps` control
    steps, `steps` steps; the launch counters cover the steps."""
    from kinpoly_tpu_torch.config.defaults import KinPolyConfig
    from kinpoly_tpu_torch.scripts import train_ar_policy as tap

    cfg = KinPolyConfig()
    tc = cfg.train_config()
    tc.n_envs, tc.rollout_steps, tc.joint_controller = n_envs, n_steps, True
    agent = tap.build_agent(takes, cfg, tc, rk.device,
                            uhc_checkpoint=uhc_checkpoint)
    agent.load_checkpoint(ar_checkpoint)
    agent.generator = rank_generator(tc.seed, rk.rank, rk.device)
    agent.time_phases = True
    nets_ = [agent.policy.parameters(), agent.value, agent.cc_policy]
    replicate_(nets_, rk.group)
    cc0 = [p.detach().clone() for p in agent.cc_policy.parameters()]
    sync = _sync(rk.device)
    out = dict(metrics=[], ctx_gaps=[], gaps=[], step_s=[])
    if rk.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    native.LAUNCHES.clear()
    for _ in range(steps):
        t = time.perf_counter()
        metrics, ctx_gap = dp_ar_step(agent, rk.group)
        sync()
        out["step_s"].append(time.perf_counter() - t)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["ctx_gaps"].append(ctx_gap)
        out["gaps"].append(replica_gap(nets_, rk.group))
    out["launches"] = dict(native.LAUNCHES)
    out["phase_s"] = dict(agent.phase_s)
    out["cc_moved"] = max(float((p.detach() - s).abs().max())
                          for p, s in zip(agent.cc_policy.parameters(), cc0))
    out["finite"] = bool(np.isfinite(
        [v for m in out["metrics"] for v in m.values()]).all())
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if rk.device.type == "cuda" else None)
    return out


def dryrun_multichip(n_ranks: int, device=None, steps: int = 1) -> list[dict]:
    """The UHC training step data-parallel over `n_ranks` spawned ranks on
    `device` (CUDA unless asked for the CPU; float32 on CUDA, float64 on
    the CPU), `steps` times, on JAX's tiny nets and the standing clips:
    ENVS_PER_RANK envs of N_STEPS control steps per rank. Ranks share a
    card over gloo; NCCL is taken with one card per rank. Raises unless
    every step leaves the ranks' nets bitwise equal, counts every rank's
    samples in the norm and stays finite. Returns each rank's record."""
    device = resolve_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    nccl = device.type == "cuda" and torch.cuda.device_count() >= n_ranks
    with RankPool(n_ranks, "nccl" if nccl else "gloo", device.type) as pool:
        res = pool.run(dryrun_job, steps, dtype)
    per_step = n_ranks * ENVS_PER_RANK * N_STEPS
    for r in res:
        if r["counts"] != [per_step * (i + 1) for i in range(steps)]:
            raise RuntimeError(f"norm counts {r['counts']}, expected "
                               f"{per_step} per step")
        if any(g != 0.0 for g in r["gaps"]):
            raise RuntimeError(f"the ranks' nets differ: gaps {r['gaps']}")
        if not r["finite"]:
            raise RuntimeError("non-finite nets, norm, state or losses")
    print(f"dryrun_multichip OK on {n_ranks} ranks; "
          f"norm count={res[0]['counts'][-1]}", flush=True)
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
