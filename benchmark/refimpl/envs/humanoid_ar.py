"""The kinematic-policy environment in training (as
``kinpoly_tpu/envs/humanoid_ar.py``, mode "train", policy_v 1, the
``dynamic_supervision_v1`` reward, movable objects), over a batch of envs.

The action is an 80-d kinematic update, integrated by ``step_ar`` and
bounded by ``clamp_qpos`` into the UHC tracking target; the frozen UHC
controller acts on the target with a sample of its Gaussian, whose unit
normal draw ``step`` takes as an input (``cc_noise``); the physics steps
the humanoid with the scene's free-body objects; a non-finite step snaps
to the target and terminates, as does a summed body distance beyond
``body_diff_thresh`` to the target or ``body_diff_gt_thresh`` to the
ground truth.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from refimpl.config.defaults import body_diff_weights
from refimpl.core import tmath
from refimpl.envs.humanoid_im import EnvConfig, TargetFrame, full_obs
from refimpl.models.traj_ar import TrajARConfig, ar_obs, clamp_qpos, step_ar
from refimpl.physics import engine as eng
from refimpl.physics import fk as fklib
from refimpl.rl import running_norm as rn

ACTIONS = ("sit", "push", "avoid", "step")
ACTION_OBJECT_NAMES = {"sit": "chair", "push": "box", "avoid": "Can",
                       "step": "step"}


@dataclass(frozen=True)
class ARRewardWeights:
    """The dynamic_supervision_v1 weights."""
    w_hp: float = 0.15
    w_hq: float = 0.15
    w_p: float = 0.2
    w_jp: float = 0.2
    w_act_p: float = 0.2
    w_act_v: float = 0.1
    k_hp: float = 45.0
    k_hq: float = 45.0
    k_p: float = 50.0
    k_jp: float = 50.0
    k_act_p: float = 5.0
    k_act_v: float = 0.005
    v_ord: int = 2


class ARContext(NamedTuple):
    """What the env reads of a per-take context bank (N, T, ...)."""
    bquat: torch.Tensor         # ground truth's body quaternions
    gt_wbpos: torch.Tensor      # ground truth's body positions
    head_pose: torch.Tensor
    head_vels: torch.Tensor
    obj_pose: torch.Tensor
    obj_head_relative_poses: torch.Tensor
    action_one_hot: torch.Tensor
    init_qpos: torch.Tensor     # (N, 76) the AR rollout's initial state
    init_qvel: torch.Tensor
    length: torch.Tensor        # (N,) int64: true frames - 1


class AREnvState(NamedTuple):
    sim: eng.SimState
    cur_t: torch.Tensor
    prev_bquat: torch.Tensor
    prev_hpos: torch.Tensor
    target_qpos: torch.Tensor
    clip_idx: torch.Tensor
    done: torch.Tensor
    fail: torch.Tensor
    sim_fk: fklib.FKResult


class ARStepInfo(NamedTuple):
    fail: torch.Tensor
    end: torch.Tensor
    percent: torch.Tensor
    cc_action: torch.Tensor
    cc_raw_obs: torch.Tensor   # the controller's observation before its norm


def multi_quat_norm_v2(nq: torch.Tensor) -> torch.Tensor:
    """Per-joint norm of (|w| - 1, x, y, z), (..., 4N) -> (..., N)."""
    q = nq.reshape(nq.shape[:-1] + (-1, 4))
    d = torch.cat([torch.abs(q[..., :1]) - 1.0, q[..., 1:]], dim=-1)
    return torch.linalg.norm(d, dim=-1)


class HumanoidAREnv:
    """The AR training env bound to a physics model with movable objects,
    the configs, the UHC controller (a module giving (mean, log_std)) and
    its observation norm; every method acts on a batch of envs and a
    context bank indexed by ``clip_idx``."""

    def __init__(self, model: eng.PhysicsModel, kin_cfg: TrajARConfig,
                 cc_cfg: EnvConfig, reward_w: ARRewardWeights, cc_policy,
                 cc_norm: rn.RunningNorm, body_diff_thresh: float = 10.0,
                 body_diff_gt_thresh: float = 12.0,
                 env_episode_len: int = 100000):
        self.model, self.kin_cfg, self.cc_cfg, self.rw = (model, kin_cfg,
                                                          cc_cfg, reward_w)
        self.cc_policy, self.cc_norm = cc_policy, cc_norm
        self.body_diff_thresh = body_diff_thresh
        self.body_diff_gt_thresh = body_diff_gt_thresh
        self.env_episode_len = env_episode_len
        spec, dtype, device = model.spec, model.dtype, model.device
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        self.base_rot = torch.tensor(cc_cfg.base_rot, dtype=torch.float32).to(
            dtype=dtype, device=device)
        self.head_idx = spec.body_index("Head")
        self.jpos_diffw = t(body_diff_weights(spec))
        names = [o.name for o in spec.objects]
        self.obj_of_action = torch.as_tensor(
            [names.index(ACTION_OBJECT_NAMES[a]) for a in ACTIONS],
            device=device)
        n_obj = len(spec.objects)
        park = np.zeros((n_obj, 7))
        park[:, 0] = (np.arange(n_obj) + 1) * 100.0
        park[:, 1] = 100.0
        park[:, 3] = 1.0
        self.obj_park = t(park)
        self.table_idx = names.index("table") if "table" in names else None

    def _at(self, ctx: ARContext, state: AREnvState, field: str, t):
        """ctx.field[clip_idx, min(t, T - 1)] per env."""
        x = getattr(ctx, field)
        t = torch.as_tensor(t, device=x.device).expand(state.clip_idx.shape)
        return x[state.clip_idx, torch.clamp(t, max=x.shape[1] - 1)]

    def _sim_obj_pose(self, state: AREnvState, ctx: ARContext):
        a_oh = self._at(ctx, state, "action_one_hot", 0)
        o_idx = self.obj_of_action[torch.argmax(a_oh, dim=-1)]
        return state.sim.obj_qpos[torch.arange(o_idx.shape[0],
                                               device=o_idx.device), o_idx]

    def get_obs(self, state: AREnvState, ctx: ARContext) -> torch.Tensor:
        sim, t = state.sim, state.cur_t
        return ar_obs(
            self.model.spec, self.model.st, self.kin_cfg, sim.qpos, sim.qvel,
            self._at(ctx, state, "head_pose", t),
            self._at(ctx, state, "head_vels", t),
            self._sim_obj_pose(state, ctx),
            self._at(ctx, state, "obj_head_relative_poses", t),
            self._at(ctx, state, "action_one_hot", 0), as_policy=True,
            fk_res=state.sim_fk)[0]

    def _head_pose(self, fk_res: fklib.FKResult) -> torch.Tensor:
        return torch.cat([fk_res.xpos[..., self.head_idx, :],
                          fk_res.xquat[..., self.head_idx, :]], dim=-1)

    def step(self, state: AREnvState, a: torch.Tensor, ctx: ARContext,
             cc_noise: torch.Tensor):
        """One control step of every env: (state, obs, reward, done,
        info); `cc_noise` is the controller's unit normal draw (N, 75)."""
        model = self.model
        prev_sim = state.sim
        next_qpos = clamp_qpos(model.jnt_lo, model.jnt_hi, prev_sim.qpos,
                               step_ar(prev_sim.qpos, a, self.kin_cfg))
        fk_t = fklib.fk(model.st, next_qpos)
        lead = next_qpos.shape[:-1]
        target = TargetFrame(qpos=next_qpos,
                             wbpos=fk_t.xpos.reshape(lead + (-1,)),
                             body_com=fk_t.xipos.reshape(lead + (-1,)),
                             wbquat=fk_t.xquat.reshape(lead + (-1,)))
        tgt_bquat = fklib.body_quat_sim(next_qpos)
        raw = full_obs(self.cc_cfg, self.base_rot, prev_sim, state.sim_fk,
                       target, include_com=self.cc_cfg.obs_v == 1)
        cc_mean, cc_log_std = self.cc_policy(rn.apply(self.cc_norm, raw))
        cc_action = cc_mean + torch.exp(cc_log_std) * cc_noise
        sim = eng.control_step(model, prev_sim, cc_action, next_qpos[..., 7:],
                               self.base_rot)
        bad = ~(torch.isfinite(sim.qpos).all(dim=-1)
                & torch.isfinite(sim.qvel).all(dim=-1))
        sim = sim._replace(
            qpos=torch.where(bad[..., None], next_qpos, sim.qpos),
            qvel=torch.where(bad[..., None], torch.zeros_like(sim.qvel),
                             sim.qvel))

        new_t = state.cur_t + 1
        fk_cur = fklib.fk(model.st, sim.qpos)
        cur_bquat = fklib.body_quat_sim(sim.qpos)
        reward = self._reward(state, fk_cur, cur_bquat, tgt_bquat, target,
                              ctx, new_t)
        cur_wbpos = fk_cur.xpos
        diff = (cur_wbpos - target.wbpos.reshape(cur_wbpos.shape)) \
            * self.jpos_diffw[:, None]
        fail = (torch.linalg.norm(diff, dim=-1).sum(dim=-1)
                > self.body_diff_thresh) | bad
        gt_wb = self._at(ctx, state, "gt_wbpos", new_t).reshape(cur_wbpos.shape)
        gt_diff = torch.linalg.norm((cur_wbpos - gt_wb)
                                    * self.jpos_diffw[:, None], dim=-1)
        fail = fail | (gt_diff.sum(dim=-1) > self.body_diff_gt_thresh)
        length = ctx.length[state.clip_idx]
        end = (new_t >= self.env_episode_len) | (new_t >= length)
        done = fail | end
        percent = new_t.to(sim.qpos.dtype) / length.to(sim.qpos.dtype)
        new_state = state._replace(
            sim=sim, cur_t=new_t, prev_bquat=cur_bquat,
            prev_hpos=self._head_pose(fk_cur), target_qpos=next_qpos,
            done=done, fail=fail, sim_fk=fk_cur)
        obs = self.get_obs(new_state, ctx)
        return new_state, obs, reward, done, ARStepInfo(
            fail=fail, end=end, percent=percent, cc_action=cc_action,
            cc_raw_obs=raw)

    def _reward(self, state, fk_cur, cur_bquat, tgt_bquat,
                target: TargetFrame, ctx, new_t):
        """dynamic_supervision_v1: head position and rotation to the
        context's head, pose and joint positions to the target, pose and
        body angular velocity to the ground truth."""
        rw = self.rw
        dt = self.model.control_dt
        tgt_hpose = self._at(ctx, state, "head_pose", new_t)
        cur_hpose = self._head_pose(fk_cur)
        hp_dist = torch.linalg.norm(cur_hpose[..., :3] - tgt_hpose[..., :3],
                                    dim=-1)
        hp_reward = torch.exp(-rw.k_hp * hp_dist ** 2)
        hq_dist = multi_quat_norm_v2(tmath.quat_mul(
            cur_hpose[..., 3:], tmath.quat_inv(tgt_hpose[..., 3:]))).mean(dim=-1)
        hq_reward = torch.exp(-rw.k_hq * hq_dist ** 2)
        pose_quat_diff = multi_quat_norm_v2(
            tmath.multi_quat_diff(cur_bquat, tgt_bquat)).mean(dim=-1)
        cur_wbpos = fk_cur.xpos
        pose_pos_diff = torch.linalg.norm(
            cur_wbpos - target.wbpos.reshape(cur_wbpos.shape),
            dim=-1).mean(dim=-1)
        p_reward = torch.exp(-rw.k_p * pose_quat_diff ** 2)
        jp_reward = torch.exp(-rw.k_jp * pose_pos_diff ** 2)
        gt_bquat = self._at(ctx, state, "bquat", new_t)
        gt_prev_bquat = self._at(ctx, state, "bquat",
                                 torch.clamp(new_t - 1, min=0))
        pose_gt_diff = multi_quat_norm_v2(
            tmath.multi_quat_diff(gt_bquat, cur_bquat)).mean(dim=-1)
        gt_p_reward = torch.exp(-rw.k_act_p * pose_gt_diff)
        cur_bangvel = tmath.angvel_fd(state.prev_bquat, cur_bquat, dt)
        tgt_bangvel = tmath.angvel_fd(gt_prev_bquat, gt_bquat, dt)
        vel_dist = torch.linalg.vector_norm(cur_bangvel - tgt_bangvel,
                                            ord=rw.v_ord, dim=-1)
        act_v_reward = torch.exp(-rw.k_act_v * vel_dist ** 2)
        return (rw.w_hp * hp_reward + rw.w_hq * hq_reward + rw.w_p * p_reward
                + rw.w_jp * jp_reward + rw.w_act_p * gt_p_reward
                + rw.w_act_v * act_v_reward)

    def reset(self, clip_idx: torch.Tensor, ctx: ARContext):
        """Each env starts its take from the context's initial state, the
        action's object placed at its context pose at rest (the others
        parked far away; a 14-d pose puts its second half on the table)."""
        qpos0, qvel0 = ctx.init_qpos[clip_idx], ctx.init_qvel[clip_idx]
        a_oh, obj_pose = ctx.action_one_hot[clip_idx, 0], ctx.obj_pose[clip_idx, 0]
        n = a_oh.shape[0]
        out = self.obj_park.to(obj_pose.dtype).expand(
            (n,) + self.obj_park.shape).clone()
        placed = out.clone()
        o_idx = self.obj_of_action[torch.argmax(a_oh, dim=-1)]
        placed[torch.arange(n, device=o_idx.device), o_idx] = obj_pose[..., :7]
        if obj_pose.shape[-1] >= 14 and self.table_idx is not None:
            placed[:, self.table_idx] = obj_pose[..., 7:14]
        has_action = torch.sum(a_oh, dim=-1) > 0
        obj0 = torch.where(has_action[:, None, None], placed, out)
        sim = eng.SimState(qpos=qpos0, qvel=qvel0, obj_qpos=obj0,
                           obj_qvel=obj0.new_zeros(obj0.shape[:-1] + (6,)))
        fk0 = fklib.fk(self.model.st, qpos0)
        zero = torch.zeros_like(clip_idx, dtype=torch.bool)
        state = AREnvState(
            sim=sim, cur_t=torch.zeros_like(clip_idx),
            prev_bquat=fklib.body_quat_sim(qpos0),
            prev_hpos=self._head_pose(fk0), target_qpos=qpos0,
            clip_idx=clip_idx, done=zero, fail=zero, sim_fk=fk0)
        return state, self.get_obs(state, ctx)
