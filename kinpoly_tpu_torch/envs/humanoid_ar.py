"""The kinematic-policy environment (port of
``kinpoly_tpu/envs/humanoid_ar.py``), over a batch of envs.

The action is the next frame's kinematic pose proposal: an 80-d kinematic
update with policy_v 1, which the env integrates (``traj_ar.step_ar``), or
the 76-d next qpos itself with policy_v 2, whose observation ends with the
AR rollout's pose at the current frame. The env bounds it, turns it into the
UHC tracking target by FK, runs the UHC controller in the loop (its mean
action in mode "test", a sample of its Gaussian in mode "train"), steps
the physics with the scene objects (movable: in the sim state; static:
posed from the context), and rewards with ``dynamic_supervision_v1`` or
the kin-poly reward of ``reward_id`` (``rl/rewards.get_kin_poly_reward``).
A non-finite step snaps to the target and terminates; so does a summed
body distance to the target beyond ``body_diff_thresh``, and in mode
"train" (unless ``wild``) one to the ground truth beyond
``body_diff_gt_thresh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from kinpoly_tpu_torch.config.defaults import (b_diff_weights_pose,
                                               body_diff_weights)
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.envs.humanoid_im import EnvConfig, TargetFrame, full_obs
from kinpoly_tpu_torch.metrics.pose_metrics import action_object_indices
from kinpoly_tpu_torch.models.traj_ar import (TrajARConfig, ar_obs, clamp_qpos,
                                              step_ar)
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.physics import fk as fklib
from kinpoly_tpu_torch.rl import rewards as rwlib
from kinpoly_tpu_torch.rl import running_norm as rn
from kinpoly_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class ARRewardWeights:
    """The dynamic_supervision weights (kin_poly.yml policy_specs
    reward_weights; the rest at the reward functions' defaults)."""
    reward_id: str = "dynamic_supervision_v1"
    w_hp: float = 0.15
    w_hq: float = 0.15
    w_p: float = 0.2
    w_jp: float = 0.2
    w_act_p: float = 0.2
    w_act_v: float = 0.1
    w_hv: float = 0.05
    k_hp: float = 45.0
    k_hq: float = 45.0
    k_p: float = 50.0
    k_jp: float = 50.0
    k_act_p: float = 5.0
    k_act_v: float = 0.005
    k_rp: float = 0.1
    k_rq: float = 0.1
    v_ord: int = 2


class ARContext(NamedTuple):
    """Per-take context bank (N, T, ...): ground truth and the AR rollout."""
    qpos: torch.Tensor          # GT (N, T, 76)
    qvel: torch.Tensor
    bquat: torch.Tensor         # GT body quats (N, T, 96)
    gt_wbpos: torch.Tensor      # FK of the GT qpos (N, T, 72)
    head_pose: torch.Tensor     # (N, T, 7)
    head_vels: torch.Tensor     # (N, T, 6)
    obj_pose: torch.Tensor      # (N, T, 14)
    obj_head_relative_poses: torch.Tensor   # (N, T, 7)
    action_one_hot: torch.Tensor            # (N, T, 4)
    ar_qpos: torch.Tensor       # the smoothed AR rollout (N, T, 76)
    ar_qvel: torch.Tensor
    ar_wbpos: torch.Tensor
    init_qpos: torch.Tensor     # (N, 76)
    init_qvel: torch.Tensor     # (N, 75)
    length: torch.Tensor        # (N,) int64 episode length: true frames - 1
    context_feat: torch.Tensor = None   # (N, T, H) use_context / use_of
    of: torch.Tensor = None             # (N, T, of_dim) use_of


class AREnvState(NamedTuple):
    sim: eng.SimState
    cur_t: torch.Tensor        # (N,) int64
    prev_bquat: torch.Tensor   # (N, 96)
    prev_hpos: torch.Tensor    # (N, 7) previous head pose
    target_qpos: torch.Tensor  # (N, 76) current AR target
    clip_idx: torch.Tensor     # (N,) int64
    done: torch.Tensor         # (N,) bool
    fail: torch.Tensor         # (N,) bool
    sim_fk: fklib.FKResult     # FK of sim.qpos


class ARStepInfo(NamedTuple):
    fail: torch.Tensor
    end: torch.Tensor
    percent: torch.Tensor
    cc_action: torch.Tensor
    cc_state: torch.Tensor
    reward_info: torch.Tensor  # (N, 6) reward components


def multi_quat_norm_v2(nq: torch.Tensor) -> torch.Tensor:
    """Per-joint norm of (|w| - 1, x, y, z), (..., 4N) -> (..., N)."""
    q = nq.reshape(nq.shape[:-1] + (-1, 4))
    d = torch.cat([torch.abs(q[..., :1]) - 1.0, q[..., 1:]], dim=-1)
    return torch.linalg.norm(d, dim=-1)


class HumanoidAREnv:
    """The AR env bound to a physics model, the configs, the UHC policy (a
    module giving (mean, log_std)) and its observation norm, and a context
    bank; every method acts on a batch of envs. In mode "train" the
    controller's actions are drawn from the generator given to ``step``
    (torch's default one if None)."""

    def __init__(self, model: eng.PhysicsModel, kin_cfg: TrajARConfig,
                 cc_cfg: EnvConfig, reward_w: ARRewardWeights,
                 context: ARContext | None, cc_policy, cc_norm: rn.RunningNorm,
                 mode: str = "test", wild: bool = False,
                 body_diff_thresh: float = 10.0,
                 body_diff_gt_thresh: float = 12.0,
                 env_episode_len: int = 100000, policy_v: int = 1):
        if mode not in ("train", "test"):
            raise ValueError(f"mode {mode!r}: 'train' or 'test'")
        if policy_v not in (1, 2):
            raise ValueError(f"policy_v {policy_v}: 1 or 2")
        self.reward_fn = (None if reward_w.reward_id == "dynamic_supervision_v1"
                          else rwlib.get_kin_poly_reward(reward_w.reward_id))
        self.model, self.kin_cfg, self.cc_cfg, self.rw = (model, kin_cfg,
                                                          cc_cfg, reward_w)
        self.ctx = context
        self.cc_policy, self.cc_norm = cc_policy, cc_norm
        self.mode, self.wild = mode, wild
        self.body_diff_thresh = body_diff_thresh
        self.body_diff_gt_thresh = body_diff_gt_thresh
        self.env_episode_len = env_episode_len
        self.policy_v = policy_v
        spec, dtype, device = model.spec, model.dtype, model.device
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        # the JAX env keeps base_rot in float32 whatever the physics dtype
        self.base_rot = torch.tensor(cc_cfg.base_rot, dtype=torch.float32).to(
            dtype=dtype, device=device)
        self.head_idx = spec.body_index("Head")
        self.jpos_diffw = t(body_diff_weights(spec))
        self.b_diffw = t(b_diff_weights_pose(spec))
        self.obj_of_action = torch.as_tensor(
            action_object_indices(spec) if spec.objects
            else np.zeros(4, np.int64), device=device)
        n_obj = len(spec.objects)
        park = np.zeros((n_obj, 7))
        park[:, 0] = (np.arange(n_obj) + 1) * 100.0
        park[:, 1] = 100.0
        park[:, 3] = 1.0
        self.obj_park = t(park)
        names = [o.name for o in spec.objects]
        self.table_idx = names.index("table") if "table" in names else None
        self.action_dim = 76 if policy_v == 2 else kin_cfg.action_dim

    # -- context access ------------------------------------------------------

    def _ctx(self, ctx):
        return self.ctx if ctx is None else ctx

    def _at(self, ctx, state: AREnvState, field: str, t):
        """ctx.field[clip_idx, min(t, T - 1)] per env."""
        x = getattr(self._ctx(ctx), field)
        t = torch.as_tensor(t, device=x.device).expand(state.clip_idx.shape)
        return x[state.clip_idx, torch.clamp(t, max=x.shape[1] - 1)]

    def _sim_obj_pose(self, state: AREnvState, ctx=None) -> torch.Tensor:
        """The active object's pose: simulated for movable objects, else
        the context's."""
        if self.model.movable_objects and state.sim.obj_qpos is not None:
            a_oh = self._at(ctx, state, "action_one_hot", 0)
            o_idx = self.obj_of_action[torch.argmax(a_oh, dim=-1)]
            return state.sim.obj_qpos[torch.arange(o_idx.shape[0],
                                                   device=o_idx.device), o_idx]
        return self._at(ctx, state, "obj_pose", state.cur_t)[..., :7]

    def get_obs(self, state: AREnvState, ctx=None) -> torch.Tensor:
        kc, sim = self.kin_cfg, state.sim
        the_ctx = self._ctx(ctx)

        def extra(field, width):
            if getattr(the_ctx, field) is not None:
                return self._at(ctx, state, field, state.cur_t)
            return sim.qpos.new_zeros(sim.qpos.shape[:-1] + (width,))

        ctx_feat = (extra("context_feat", kc.rnn_hdim)
                    if kc.use_context or kc.use_of else None)
        of_t = extra("of", kc.of_dim) if kc.use_of else None
        t = state.cur_t
        obs = ar_obs(
            self.model.spec, self.model.st, kc, sim.qpos, sim.qvel,
            self._at(ctx, state, "head_pose", t),
            self._at(ctx, state, "head_vels", t),
            self._sim_obj_pose(state, ctx),
            self._at(ctx, state, "obj_head_relative_poses", t),
            self._at(ctx, state, "action_one_hot", 0), of_t=of_t,
            context_feat_t=ctx_feat, as_policy=True, fk_res=state.sim_fk)[0]
        if self.policy_v == 2:
            # the residual policy's base: the AR rollout's pose at t
            obs = torch.cat([obs, self._at(ctx, state, "ar_qpos", t)], dim=-1)
        return obs

    # -- the UHC controller in the loop ----------------------------------------

    def target_frame(self, next_qpos: torch.Tensor):
        fk_res = fklib.fk(self.model.st, next_qpos)
        lead = next_qpos.shape[:-1]
        return TargetFrame(qpos=next_qpos,
                           wbpos=fk_res.xpos.reshape(lead + (-1,)),
                           body_com=fk_res.xipos.reshape(lead + (-1,)),
                           wbquat=fk_res.xquat.reshape(lead + (-1,))), fk_res

    def cc_obs(self, sim: eng.SimState, target: TargetFrame, fk_res=None):
        if fk_res is None:
            fk_res = fklib.fk(self.model.st, sim.qpos)
        obs = full_obs(self.cc_cfg, self.base_rot, sim, fk_res, target,
                       include_com=self.cc_cfg.obs_v == 1)
        return rn.apply(self.cc_norm, obs)

    def _head_pose(self, fk_res: fklib.FKResult) -> torch.Tensor:
        return torch.cat([fk_res.xpos[..., self.head_idx, :],
                          fk_res.xquat[..., self.head_idx, :]], dim=-1)

    # -- step ------------------------------------------------------------------

    def step(self, state: AREnvState, a: torch.Tensor, ctx=None,
             cc_policy=None, generator: torch.Generator | None = None):
        """One control step of every env: (state, obs, reward, done, info).
        `cc_policy` replaces the env's controller (the jointly tuned copy
        of training)."""
        model = self.model
        prev_sim = state.sim
        # policy_v 2: the action is the next qpos
        next_qpos = a if self.policy_v == 2 else step_ar(prev_sim.qpos, a,
                                                        self.kin_cfg)
        next_qpos = clamp_qpos(model.jnt_lo, model.jnt_hi, prev_sim.qpos,
                               next_qpos)
        target, _ = self.target_frame(next_qpos)
        tgt_bquat = fklib.body_quat_sim(next_qpos)
        with span("ar.controller"):
            cc_obs = self.cc_obs(prev_sim, target, fk_res=state.sim_fk)
            cc_mean, cc_log_std = (self.cc_policy if cc_policy is None
                                   else cc_policy)(cc_obs)
            if self.mode == "test":
                cc_action = cc_mean
            else:
                cc_action = cc_mean + torch.exp(cc_log_std) * torch.randn(
                    cc_mean.shape, generator=generator, dtype=cc_mean.dtype,
                    device=cc_mean.device)

        obj_qpos = None
        if model.scene is not None and not model.movable_objects:
            obj_qpos = self.convert_obj_qpos(
                self._at(ctx, state, "action_one_hot", 0),
                self._at(ctx, state, "obj_pose", 0))
        sim = eng.control_step(model, prev_sim, cc_action, next_qpos[..., 7:],
                               self.base_rot, obj_qpos=obj_qpos)
        # a blown-up env snaps to the AR target and terminates
        bad = ~(torch.isfinite(sim.qpos).all(dim=-1)
                & torch.isfinite(sim.qvel).all(dim=-1))
        sim = sim._replace(
            qpos=torch.where(bad[..., None], next_qpos, sim.qpos),
            qvel=torch.where(bad[..., None], torch.zeros_like(sim.qvel),
                             sim.qvel))

        new_t = state.cur_t + 1
        fk_cur = fklib.fk(model.st, sim.qpos)
        cur_bquat = fklib.body_quat_sim(sim.qpos)
        reward, rinfo = self._reward(state, fk_cur, cur_bquat, tgt_bquat,
                                     target, ctx, new_t)
        cur_wbpos = fk_cur.xpos
        diff = (cur_wbpos - target.wbpos.reshape(cur_wbpos.shape)) \
            * self.jpos_diffw[:, None]
        fail = (torch.linalg.norm(diff, dim=-1).sum(dim=-1)
                > self.body_diff_thresh) | bad
        if self.mode == "train" and not self.wild:
            gt_wb = self._at(ctx, state, "gt_wbpos", new_t).reshape(
                cur_wbpos.shape)
            gt_diff = torch.linalg.norm((cur_wbpos - gt_wb)
                                        * self.jpos_diffw[:, None], dim=-1)
            fail = fail | (gt_diff.sum(dim=-1) > self.body_diff_gt_thresh)
        length = self._ctx(ctx).length[state.clip_idx]
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
            cc_state=cc_obs, reward_info=rinfo)

    # -- rewards -----------------------------------------------------------

    def _reward(self, state, fk_cur, cur_bquat, tgt_bquat,
                target: TargetFrame, ctx, new_t):
        rw = self.rw
        dt = self.model.control_dt
        if self.reward_fn is not None:
            return self._kin_poly_reward(state, fk_cur, cur_bquat, tgt_bquat,
                                         target, ctx, new_t)
        tgt_hpose = self._at(ctx, state, "head_pose", new_t)
        cur_hpose = self._head_pose(fk_cur)
        hp_dist = torch.linalg.norm(cur_hpose[..., :3] - tgt_hpose[..., :3], dim=-1)
        hp_reward = torch.exp(-rw.k_hp * hp_dist ** 2)
        hq_dist = multi_quat_norm_v2(tmath.quat_mul(
            cur_hpose[..., 3:], tmath.quat_inv(tgt_hpose[..., 3:]))).mean(dim=-1)
        hq_reward = torch.exp(-rw.k_hq * hq_dist ** 2)

        pose_quat_diff = multi_quat_norm_v2(
            tmath.multi_quat_diff(cur_bquat, tgt_bquat)).mean(dim=-1)
        cur_wbpos = fk_cur.xpos
        pose_pos_diff = torch.linalg.norm(
            cur_wbpos - target.wbpos.reshape(cur_wbpos.shape), dim=-1).mean(dim=-1)
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

        reward = (rw.w_hp * hp_reward + rw.w_hq * hq_reward + rw.w_p * p_reward
                  + rw.w_jp * jp_reward + rw.w_act_p * gt_p_reward
                  + rw.w_act_v * act_v_reward)
        info = torch.stack([hp_reward, hq_reward, p_reward, jp_reward,
                            gt_p_reward, act_v_reward], dim=-1)
        return reward, info

    def _kin_poly_reward(self, state, fk_cur, cur_bquat, tgt_bquat,
                         target: TargetFrame, ctx, new_t):
        """The reward of ``reward_id`` from the registry, on the sim, the
        AR target, the ground truth and the AR rollout at frame new_t."""
        dt = self.model.control_dt
        prev_t = torch.clamp(new_t - 1, min=0)
        ar_qpos = self._at(ctx, state, "ar_qpos", new_t)
        gt_bq = self._at(ctx, state, "bquat", new_t)
        gt_pbq = self._at(ctx, state, "bquat", prev_t)
        inp = rwlib.ARRewardInputs(
            head_pose=self._head_pose(fk_cur),
            tgt_head_pose=self._at(ctx, state, "head_pose", new_t),
            bquat=cur_bquat,
            wbpos=fk_cur.xpos.reshape(cur_bquat.shape[:-1] + (-1,)),
            tgt_bquat=tgt_bquat, tgt_wbpos=target.wbpos,
            gt_bquat=gt_bq, gt_prev_bquat=gt_pbq,
            gt_wbpos=self._at(ctx, state, "gt_wbpos", new_t),
            gt_bangvel=tmath.angvel_fd(gt_pbq, gt_bq, dt),
            bangvel=tmath.angvel_fd(state.prev_bquat, cur_bquat, dt),
            b_diffw=self.b_diffw, tgt_qpos=target.qpos, ar_qpos=ar_qpos,
            ar_bquat=fklib.body_quat_sim(ar_qpos),
            ar_prev_bquat=fklib.body_quat_sim(
                self._at(ctx, state, "ar_qpos", prev_t)),
            prev_bquat=state.prev_bquat)
        ws = {f: getattr(self.rw, f) for f in self.rw.__dataclass_fields__}
        return self.reward_fn(inp, ws, dt)

    # -- reset / fail-safe -----------------------------------------------------

    def reset(self, clip_idx: torch.Tensor, ctx=None, ar_mode: bool = False):
        """Each env starts its take from the context's initial state (the AR
        rollout's first frame with ``ar_mode``), movable objects placed by
        ``convert_obj_qpos`` at rest."""
        c = self._ctx(ctx)
        clip_idx = torch.as_tensor(clip_idx, device=c.qpos.device)
        if ar_mode:
            qpos0, qvel0 = c.ar_qpos[clip_idx, 0], c.ar_qvel[clip_idx, 0]
        else:
            qpos0, qvel0 = c.init_qpos[clip_idx], c.init_qvel[clip_idx]
        sim = eng.SimState(qpos=qpos0, qvel=qvel0)
        if self.model.movable_objects:
            obj0 = self.convert_obj_qpos(c.action_one_hot[clip_idx, 0],
                                         c.obj_pose[clip_idx, 0])
            sim = sim._replace(obj_qpos=obj0, obj_qvel=obj0.new_zeros(
                obj0.shape[:-1] + (6,)))
        fk0 = fklib.fk(self.model.st, qpos0)
        zero = torch.zeros_like(clip_idx, dtype=torch.bool)
        state = AREnvState(
            sim=sim, cur_t=torch.zeros_like(clip_idx),
            prev_bquat=fklib.body_quat_sim(qpos0),
            prev_hpos=self._head_pose(fk0), target_qpos=qpos0,
            clip_idx=clip_idx, done=zero, fail=zero, sim_fk=fk0)
        return state, self.get_obs(state, ctx)

    def convert_obj_qpos(self, action_one_hot: torch.Tensor,
                         obj_pose: torch.Tensor) -> torch.Tensor:
        """(N, n_obj, 7): the action's object at its context pose, the others
        parked far away ((i + 1) 100, 100, 0); a 14-d pose puts its second
        half on the table (push)."""
        n = action_one_hot.shape[0]
        out = self.obj_park.to(obj_pose.dtype).expand(
            (n,) + self.obj_park.shape).clone()
        placed = out.clone()
        o_idx = self.obj_of_action[torch.argmax(action_one_hot, dim=-1)]
        placed[torch.arange(n, device=o_idx.device), o_idx] = obj_pose[..., :7]
        if obj_pose.shape[-1] >= 14 and self.table_idx is not None:
            placed[:, self.table_idx] = obj_pose[..., 7:14]
        has_action = torch.sum(action_one_hot, dim=-1) > 0
        return torch.where(has_action[:, None, None], placed, out)

    def ar_fail_safe(self, state: AREnvState, ctx=None) -> AREnvState:
        """Teleport the sim to the AR rollout's next pose; objects keep
        their simulated state."""
        t = state.cur_t + 1
        qpos = self._at(ctx, state, "ar_qpos", t)
        return state._replace(
            sim=state.sim._replace(qpos=qpos,
                                   qvel=self._at(ctx, state, "ar_qvel", t)),
            sim_fk=fklib.fk(self.model.st, qpos))
