"""Batched on-device rollout (port of ``kinpoly_tpu/rl/rollout.py``).

N envs step in lockstep for ``n_steps`` control steps in a Python loop
under ``torch.no_grad()``, writing into preallocated (T, N, ...) tensors.
Nothing is read back to the host inside the loop: as in JAX, every env is
reset at every step and the reset state is selected where an env is done,
so shapes stay fixed and the device never waits for the host. One
``torch.Generator`` on the env's device feeds every draw: which envs
explore (Bernoulli ``noise_rate``), the Gaussian action noise, the clips of
the reset envs (sampled from ``clip_probs``, the adaptive hard-clip mining
probabilities) and the training resets.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from kinpoly_tpu_torch.envs.humanoid_im import EnvState, HumanoidImEnv, select
from kinpoly_tpu_torch.models import nets
from kinpoly_tpu_torch.rl import running_norm as rn
from kinpoly_tpu_torch.utils.profiling import span, spanned


class Trajectory(NamedTuple):
    """(T, N, ...) rollout tensors (the reference TrajBatch)."""
    obs: torch.Tensor          # normalised obs as the policy saw them
    actions: torch.Tensor
    rewards: torch.Tensor
    masks: torch.Tensor        # 0 where the episode ended at this step
    exps: torch.Tensor         # 1 where the action was explored
    log_probs: torch.Tensor
    raw_obs: torch.Tensor      # un-normalised (for the running-norm update)
    fails: torch.Tensor
    ends: torch.Tensor
    percents: torch.Tensor     # episode progress at each step
    clips: torch.Tensor        # clip each env was tracking
    reward_info: torch.Tensor  # per-component reward decomposition
    qpos: torch.Tensor         # post-step sim state, before any auto-reset
    qvel: torch.Tensor


class RolloutState(NamedTuple):
    env_state: EnvState
    obs: torch.Tensor          # (N, O) raw obs


def sample_clips(clip_probs: torch.Tensor, n: int,
                 generator: torch.Generator) -> torch.Tensor:
    """n clip indices drawn from the categorical over ``clip_probs + 1e-12``
    (JAX's ``categorical(log(p + 1e-12))``), by inverse CDF."""
    cdf = torch.cumsum(clip_probs + 1e-12, dim=0)
    u = torch.rand(n, generator=generator, dtype=cdf.dtype,
                   device=cdf.device) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, max=clip_probs.shape[0] - 1)


def init_rollout_state(env: HumanoidImEnv, generator: torch.Generator,
                       n_envs: int, clip_probs: torch.Tensor) -> RolloutState:
    clips = sample_clips(clip_probs, n_envs, generator)
    env_state, obs = env.reset(clips, deterministic=False, generator=generator)
    return RolloutState(env_state=env_state, obs=obs)


def make_rollout(env: HumanoidImEnv, policy: Callable, n_steps: int,
                 noise_rate: float = 1.0):
    """`rollout(carry, norm, clip_probs, generator, noise_rate_t=None,
    mean_action=False)` -> (new carry, Trajectory). `policy(obs_n)` gives
    (mean, log_std); `noise_rate_t` overrides the construction-time noise
    rate (the adaptive schedules); with `mean_action` no action is explored
    (the draws are still made, so the generator's stream is the same)."""

    @torch.no_grad()
    @spanned("uhc.rollout")
    def rollout(carry: RolloutState, norm: rn.RunningNorm,
                clip_probs: torch.Tensor, generator: torch.Generator,
                noise_rate_t: float | None = None, mean_action: bool = False):
        nr = noise_rate if noise_rate_t is None else noise_rate_t
        traj = None
        for t in range(n_steps):
            with span("uhc.policy"):
                obs_n = rn.apply(norm, carry.obs)
                mean, log_std = policy(obs_n)
                n_envs = mean.shape[0]
                draw = dict(generator=generator, dtype=mean.dtype,
                            device=mean.device)
                explore = (torch.rand(n_envs, **draw) < nr) & (not mean_action)
                noise = torch.randn(mean.shape, **draw)
                action = (mean + explore[:, None].to(mean.dtype)
                          * torch.exp(log_std) * noise)
                log_prob = nets.gaussian_log_prob(action, mean, log_std)

            cur_clips = carry.env_state.clip_idx
            env_state, obs, reward, done, info = env.step(carry.env_state, action)
            step = dict(
                obs=obs_n, actions=action, rewards=reward,
                masks=(~done).to(reward.dtype), exps=explore.to(reward.dtype),
                log_probs=log_prob, raw_obs=carry.obs, fails=info.fail,
                ends=info.end, percents=info.percent, clips=cur_clips,
                reward_info=info.reward_info, qpos=env_state.sim.qpos,
                qvel=env_state.sim.qvel)
            if traj is None:
                traj = {k: torch.empty((n_steps,) + v.shape, dtype=v.dtype,
                                       device=v.device)
                        for k, v in step.items()}
            for k, v in step.items():
                traj[k][t] = v

            # auto-reset the envs that are done, with freshly sampled clips
            new_clips = sample_clips(clip_probs, n_envs, generator)
            reset_state, reset_obs = env.reset(new_clips, deterministic=False,
                                               generator=generator)
            carry = RolloutState(
                env_state=select(done, reset_state, env_state),
                obs=torch.where(done[:, None], reset_obs, obs))
        return carry, Trajectory(**traj)

    return rollout
