"""Batched rollout of the recurrent kinematic policy in the AR env (port of
``kinpoly_tpu/rl/rollout_ar.py``): the policy's mean actions (evaluation)
or samples of its Gaussian (training; a mean-action rollout would make the
PPO surrogate's gradient exactly zero).

N envs step in lockstep for ``n_steps`` control steps in a Python loop
under ``torch.no_grad()``. As in the UHC rollout, every env is reset at
every step and the reset state is taken where an env is done (the policy
GRU carry zeroed there), so nothing is read back to the host inside the
loop. With ``fail_safe`` a tracking failure teleports the sim to the AR
rollout's pose (``HumanoidAREnv.ar_fail_safe``) and the episode runs on to
the end of its take; the teleports are recorded in ``fails``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kinpoly_tpu_torch.envs.humanoid_ar import AREnvState, HumanoidAREnv
from kinpoly_tpu_torch.envs.humanoid_im import select
from kinpoly_tpu_torch.models import nets
from kinpoly_tpu_torch.models.policy_ar import PolicyAR
from kinpoly_tpu_torch.utils.profiling import span


class ARTrajectory(NamedTuple):
    """(T, N, ...) rollout tensors."""
    obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    masks: torch.Tensor        # 0 where the episode ended at this step
    log_probs: torch.Tensor
    gt_qpos: torch.Tensor      # the take's next frame
    curr_qpos: torch.Tensor    # sim qpos before the step
    res_qpos: torch.Tensor     # sim qpos after the step, before any reset
    cc_action: torch.Tensor
    cc_state: torch.Tensor
    fails: torch.Tensor
    ends: torch.Tensor
    percents: torch.Tensor
    clips: torch.Tensor
    obj_qpos: torch.Tensor | None = None   # (T, N, n_obj, 7) movable objects


class ARRolloutState(NamedTuple):
    env_state: AREnvState
    obs: torch.Tensor
    gru: torch.Tensor          # (N, H) policy GRU carry


def make_ar_rollout(env: HumanoidAREnv, policy: PolicyAR, n_steps: int,
                    fail_safe: bool = False):
    """`rollout(carry, ctx=None, mean_action=True, cc_policy=None,
    generator=None)` -> (new carry, ARTrajectory). With
    ``mean_action=False`` the action is mean + exp(log_std) N(0, 1) drawn
    from `generator`, and `log_probs` are the samples'. `cc_policy` and
    `generator` go on to ``env.step`` (the controller and its noise in
    mode "train")."""

    @torch.no_grad()
    def rollout(carry: ARRolloutState, ctx=None, mean_action: bool = True,
                cc_policy=None, generator: torch.Generator | None = None):
        the_ctx = env.ctx if ctx is None else ctx
        T_ctx = the_ctx.qpos.shape[1]
        traj = None
        for t in range(n_steps):
            with span("ar.kin_policy"):
                gru, mean = policy.action_mean(carry.gru, carry.obs)
                log_std = torch.full_like(mean, policy.log_std)
                action = mean if mean_action else mean + torch.exp(
                    log_std) * torch.randn(mean.shape, generator=generator,
                                           dtype=mean.dtype,
                                           device=mean.device)
                log_prob = nets.gaussian_log_prob(action, mean, log_std)
            es = carry.env_state
            gt_qpos = the_ctx.qpos[es.clip_idx,
                                   torch.clamp(es.cur_t + 1, max=T_ctx - 1)]
            env_state, obs, reward, done, info = env.step(
                es, action, ctx, cc_policy=cc_policy, generator=generator)
            fails = info.fail
            if fail_safe:
                # teleport on failure and roll on: only the take's end
                # terminates
                fails = info.fail & ~info.end
                env_state = select(fails, env.ar_fail_safe(env_state, ctx),
                                   env_state)
                obs = torch.where(fails[:, None], env.get_obs(env_state, ctx),
                                  obs)
                done = info.end
            step = dict(
                obs=carry.obs, actions=action, rewards=reward,
                masks=(~done).to(reward.dtype), log_probs=log_prob,
                gt_qpos=gt_qpos, curr_qpos=es.sim.qpos,
                res_qpos=env_state.sim.qpos, cc_action=info.cc_action,
                cc_state=info.cc_state, fails=fails, ends=info.end,
                percents=info.percent, clips=es.clip_idx,
                obj_qpos=env_state.sim.obj_qpos)
            if traj is None:
                traj = {k: None if v is None else torch.empty(
                    (n_steps,) + v.shape, dtype=v.dtype, device=v.device)
                    for k, v in step.items()}
            for k, v in step.items():
                if v is not None:
                    traj[k][t] = v
            reset_state, reset_obs = env.reset(es.clip_idx, ctx)
            carry = ARRolloutState(
                env_state=select(done, reset_state, env_state),
                obs=torch.where(done[:, None], reset_obs, obs),
                gru=gru * (~done)[:, None].to(gru.dtype))
        return carry, ARTrajectory(**traj)

    return rollout


def init_ar_rollout_state(env: HumanoidAREnv, policy: PolicyAR,
                          clip_indices: torch.Tensor, ctx=None) -> ARRolloutState:
    env_state, obs = env.reset(clip_indices, ctx)
    return ARRolloutState(env_state=env_state, obs=obs,
                          gru=policy.init_carry(obs.shape[0], obs))
