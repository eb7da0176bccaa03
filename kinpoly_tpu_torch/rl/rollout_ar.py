"""Batched rollout of the recurrent kinematic policy in the AR env (port of
``kinpoly_tpu/rl/rollout_ar.py``, mean actions).

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
    """`rollout(carry, ctx=None)` -> (new carry, ARTrajectory), with the
    policy's mean actions."""

    @torch.no_grad()
    def rollout(carry: ARRolloutState, ctx=None):
        the_ctx = env.ctx if ctx is None else ctx
        T_ctx = the_ctx.qpos.shape[1]
        traj = None
        for t in range(n_steps):
            gru, action = policy.action_mean(carry.gru, carry.obs)
            log_prob = nets.gaussian_log_prob(
                action, action, torch.full_like(action, policy.log_std))
            es = carry.env_state
            gt_qpos = the_ctx.qpos[es.clip_idx,
                                   torch.clamp(es.cur_t + 1, max=T_ctx - 1)]
            env_state, obs, reward, done, info = env.step(es, action, ctx)
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
