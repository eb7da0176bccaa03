"""UHC motion-imitation environment (port of
``kinpoly_tpu/envs/humanoid_im.py``): observations v1 and v2, every UHC
reward (``rl/rewards.py``), body-distance, head and root-height
termination, the non-finite guard, the deterministic (evaluation) and
training resets, and the fail-safe, over a batch of envs. The action is
the model's ``action_dim`` wide.

Every state tensor has a leading env dim N. The training reset draws from
the caller's ``torch.Generator``: joint noise (``env_init_noise``), and in
"train" mode with probability ``reactive_rate`` a start from the neutral
standing pose (``reactive_v`` 1) or from a hard-state bank (``reactive_v``
2), matched to the expert's heading and position.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from kinpoly_tpu_torch.anim.spec import standing_pose
from kinpoly_tpu_torch.config.defaults import b_diff_weights_pose, body_diff_weights
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.data import expert as exlib
from kinpoly_tpu_torch.physics import engine as eng
from kinpoly_tpu_torch.physics import fk as fklib
from kinpoly_tpu_torch.rl import rewards as rwlib
from kinpoly_tpu_torch.utils.profiling import spanned


@dataclass(frozen=True)
class EnvConfig:
    obs_v: int = 1
    obs_coord: str = "root"
    obs_vel: str = "full"
    env_term_body: str = "body"
    body_diff_thresh: float = 0.5
    env_episode_len: int = 100000
    env_expert_trail_steps: int = 0
    env_init_noise: float = 0.0
    reactive_v: int = 1
    reactive_rate: float = 0.3
    base_rot: tuple = (0.7071, 0.7071, 0.0, 0.0)
    reward_id: str = "world_rfc_implicit"
    w_p: float = 0.3
    w_v: float = 0.1
    w_e: float = 0.45
    w_c: float = 0.1
    w_vf: float = 0.05
    k_p: float = 2.0
    k_v: float = 0.005
    k_e: float = 5.0
    k_c: float = 100.0
    k_vf: float = 1.0
    v_ord: int = 2
    # local_rfc_* root terms
    w_rp: float = 0.1
    w_rv: float = 0.1
    k_rh: float = 300.0
    k_rq: float = 300.0
    k_rl: float = 5.0
    k_ra: float = 0.5
    # *_explicit contact-point regularizer
    w_cp: float = 0.0
    k_cp: float = 1.0
    # v2/v3 world-quat/jpos terms
    w_wp: float = 0.4
    w_j: float = 100.0
    k_wp: float = 0.4
    k_j: float = 100.0


class TargetFrame(NamedTuple):
    qpos: torch.Tensor      # (..., 76)
    wbpos: torch.Tensor     # (..., 72)
    body_com: torch.Tensor  # (..., 72)
    wbquat: torch.Tensor    # (..., 96)


def full_obs(cfg: EnvConfig, base_rot: torch.Tensor, sim: eng.SimState,
             fk_res: fklib.FKResult, tgt: TargetFrame, include_com: bool):
    """UHC observation v1 (with the per-body CoM blocks) or v2 (without),
    keeping the reference's quirks the trained policies saw: the linear
    velocity is turned into the root frame twice, and 'rel_pos' is built
    from quaternion components."""
    qpos, qvel = sim.qpos, sim.qvel
    lead = qpos.shape[:-1]

    def remove_base(q):
        return tmath.quat_mul(q, tmath.quat_conj(base_rot))

    lin = tmath.transform_vec(qvel[..., :3], qpos[..., 3:7], cfg.obs_coord)
    curr_root_quat = remove_base(qpos[..., 3:7])
    hq = tmath.heading_q(curr_root_quat)
    target_qpos = tgt.qpos
    target_root_quat = remove_base(target_qpos[..., 3:7])

    qpos_dh = torch.cat([qpos[..., :3], tmath.de_heading(curr_root_quat),
                         qpos[..., 7:]], dim=-1)
    diff_rot = tmath.quat_mul(target_root_quat, tmath.quat_inv(curr_root_quat))
    diff_qpos = torch.cat([target_qpos[..., :2],
                           target_qpos[..., 2:3] - qpos_dh[..., 2:3],
                           diff_rot,
                           target_qpos[..., 7:] - qpos_dh[..., 7:]], dim=-1)
    obs = [hq, target_qpos[..., 2:], qpos_dh[..., 2:], diff_qpos[..., 2:]]

    lin2 = tmath.transform_vec(lin, curr_root_quat, cfg.obs_coord)
    vel = torch.cat([lin2, qvel[..., 3:]], dim=-1)
    obs.append(vel if cfg.obs_vel == "full" else vel[..., :6])

    rel_h = tmath.wrap_to_pi(tmath.heading(target_root_quat)
                             - tmath.heading(curr_root_quat))
    obs.append(rel_h[..., None])
    rel_pos = target_root_quat[..., :3] - qpos[..., :3]
    rel_pos = tmath.transform_vec(rel_pos, curr_root_quat, cfg.obs_coord)
    obs.append(rel_pos[..., :2])

    root_q = curr_root_quat[..., None, :]
    curr_jpos = fk_res.xpos
    r_jpos = tmath.transform_vec(curr_jpos - qpos[..., None, :3], root_q,
                                 cfg.obs_coord)
    obs.append(r_jpos.reshape(lead + (-1,)))
    diff_jpos = tgt.wbpos.reshape(lead + (24, 3)) - curr_jpos
    obs.append(tmath.transform_vec(diff_jpos, root_q, cfg.obs_coord)
               .reshape(lead + (-1,)))
    if include_com:
        curr_com = fk_res.xipos
        r_com = tmath.transform_vec(curr_com - qpos[..., None, :3], root_q,
                                    cfg.obs_coord)
        obs.append(r_com.reshape(lead + (-1,)))
        diff_com = tgt.body_com.reshape(lead + (24, 3)) - curr_com
        obs.append(tmath.transform_vec(diff_com, root_q, cfg.obs_coord)
                   .reshape(lead + (-1,)))

    cur_quat = fk_res.xquat
    r_quat = tmath.quat_mul(tmath.quat_inv(hq)[..., None, :], cur_quat)
    obs.append(r_quat.reshape(lead + (-1,)))
    target_quat = tgt.wbquat.reshape(lead + (24, 4))
    obs.append(tmath.quat_mul(tmath.quat_inv(cur_quat), target_quat)
               .reshape(lead + (-1,)))
    return torch.cat(obs, dim=-1)


class EnvState(NamedTuple):
    sim: eng.SimState
    cur_t: torch.Tensor       # (N,) int64
    start_ind: torch.Tensor   # (N,) int64
    prev_bquat: torch.Tensor  # (N, 96)
    clip_idx: torch.Tensor    # (N,) int64
    done: torch.Tensor        # (N,) bool
    fail: torch.Tensor        # (N,) bool


class StepInfo(NamedTuple):
    fail: torch.Tensor
    end: torch.Tensor
    percent: torch.Tensor
    reward_info: torch.Tensor   # (N, C) reward components


def select(mask: torch.Tensor, a, b):
    """Per env: `a` where mask, else `b`, through nested NamedTuples (an
    EnvState and its SimState; None leaves, such as the object state of a
    model without movable objects, stay None)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return type(a)(*(select(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


class HumanoidImEnv:
    """The UHC imitation env bound to a physics model, a config, an expert
    bank and the neutral standing pose (default: the spec's
    ``standing_pose``); all methods act on a batch of envs. ``hard_states``
    (qpos (K, 76), qvel (K, 75)) is the reactive_v 2 start bank."""

    def __init__(self, model: eng.PhysicsModel, cfg: EnvConfig,
                 bank: exlib.ExpertClip, neutral_qpos=None, neutral_qvel=None,
                 mode: str = "train", hard_states: tuple | None = None):
        if cfg.obs_v not in (1, 2):
            raise ValueError(f"obs_v {cfg.obs_v}")
        self.model = model
        self.cfg = cfg
        self.bank = bank
        self.mode = mode
        dtype, device = model.dtype, model.device
        if neutral_qpos is None:
            neutral_qpos, neutral_qvel = standing_pose(model.spec)
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        self.neutral_qpos = t(neutral_qpos)
        self.neutral_qvel = t(neutral_qvel)
        self.hard_states = (None if hard_states is None
                            else tuple(t(x) for x in hard_states))
        # the JAX env keeps base_rot in float32 whatever the physics dtype
        self.base_rot = torch.tensor(cfg.base_rot, dtype=torch.float32).to(
            dtype=dtype, device=device)
        spec = model.spec
        self.head_idx = spec.body_index("Head")
        self.ee_idx = torch.as_tensor(
            fklib.make_body_index(spec, exlib.EE_NAMES), device=device)
        self.jpos_diffw = torch.as_tensor(body_diff_weights(spec), dtype=dtype,
                                          device=device)
        self.b_diffw = torch.as_tensor(b_diff_weights_pose(spec), dtype=dtype,
                                       device=device)
        self.vf_dim = model.ctrl.vf_dim
        self.action_dim = model.action_dim
        self.reward_fn = rwlib.get_uhc_reward(cfg.reward_id)
        self.reward_weights = {f.name: getattr(cfg, f.name) for f in fields(cfg)}

    @property
    def n_clips(self) -> int:
        return int(self.bank.length.shape[0])

    @functools.cached_property
    def obs_dim(self) -> int:
        """Width of the observation (784 for v1, 640 for v2), from one
        reset of clip 0."""
        return self.reset(torch.zeros(1, dtype=torch.int64,
                                      device=self.model.device))[1].shape[-1]

    def expert_frame(self, state: EnvState, delta_t: int = 0) -> exlib.ExpertClip:
        return exlib.bank_frame(self.bank, state.clip_idx,
                                state.start_ind + state.cur_t + delta_t)

    @spanned("env.observe")
    def get_obs(self, state: EnvState, fk_res: fklib.FKResult | None = None):
        if fk_res is None:
            fk_res = fklib.fk(self.model.st, state.sim.qpos)
        t = self.expert_frame(state, delta_t=1)
        return full_obs(self.cfg, self.base_rot, state.sim, fk_res,
                        TargetFrame(t.qpos, t.wbpos, t.body_com, t.wbquat),
                        include_com=self.cfg.obs_v == 1)

    @spanned("env.reward")
    def reward(self, state: EnvState, next_sim: eng.SimState, action,
               fk_res: fklib.FKResult):
        """`state` carries the post-increment time, so the expert frame is
        the one the step moved to. The local-frame features are built only
        for the rewards that read them. As in the JAX env, `state.sim` is
        already `next_sim` here, so the simulated side's finite-difference
        root velocities (``rlinv``, ``rlinv_local``, ``rangv``) are those of
        next_sim against itself: zero."""
        e = self.expert_frame(state)
        dt = self.model.control_dt
        lead = next_sim.qpos.shape[:-1]
        cur_bquat = fklib.body_quat_sim(next_sim.qpos)
        kw = dict(
            bquat=cur_bquat,
            wbquat=fk_res.xquat.reshape(lead + (-1,)),
            wbpos=fk_res.xpos.reshape(lead + (-1,)),
            body_com=fk_res.xipos.reshape(lead + (-1,)),
            com=fklib.com(self.model.st, fk_res),
            ee_wpos=exlib.ee_world(fk_res, self.ee_idx),
            bangvel=tmath.angvel_fd(state.prev_bquat, cur_bquat, dt),
            head_pose=None,
            e_bquat=e.bquat, e_wbquat=e.wbquat, e_wbpos=e.wbpos,
            e_body_com=e.body_com, e_com=e.com, e_ee_wpos=e.ee_wpos,
            e_bangvel=e.bangvel, vf=action[..., 69:69 + self.vf_dim],
            b_diffw=self.b_diffw, jpos_diffw=self.jpos_diffw)
        if rwlib.needs_local(self.cfg.reward_id):
            cur_qvel = tmath.qvel_fd(state.sim.qpos, next_sim.qpos, dt)
            kw.update(
                qpos=next_sim.qpos,
                rq_rmh=tmath.de_heading(next_sim.qpos[..., 3:7]),
                rlinv=cur_qvel[..., :3],
                rlinv_local=tmath.transform_vec(
                    cur_qvel[..., :3], state.sim.qpos[..., 3:7],
                    self.cfg.obs_coord),
                rangv=cur_qvel[..., 3:6],
                ee_pos=exlib.ee_in_root(fk_res, next_sim.qpos, self.ee_idx,
                                        self.cfg.obs_coord),
                e_qpos=e.qpos, e_rq_rmh=e.rq_rmh, e_rlinv=e.rlinv,
                e_rlinv_local=e.rlinv_local, e_rangv=e.rangv,
                e_ee_pos=e.ee_pos)
        if self.cfg.reward_id.endswith("_explicit"):
            # per-body blocks of the explicit residual forces: the contact
            # point, then the force (and torque)
            c = self.model.ctrl
            v = kw["vf"].reshape(lead + (len(c.vf_bodies), c.body_vf_dim))
            kw.update(vf_cp=v[..., :3], vf_force=v[..., 3:])
        return self.reward_fn(rwlib.RewardInputs(**kw), self.reward_weights)

    def calc_body_diff(self, state: EnvState, fk_res: fklib.FKResult):
        e = self.expert_frame(state)
        cur = fk_res.xpos
        ref = e.wbpos.reshape(cur.shape[:-2] + (24, 3))
        diff = (cur - ref) * self.jpos_diffw[:, None]
        return torch.linalg.norm(diff, dim=-1).mean(dim=-1)

    @spanned("env.step")
    def step(self, state: EnvState, action: torch.Tensor):
        """One control step of every env: (state, obs, reward, done, info)."""
        cfg = self.cfg
        tgt = self.expert_frame(state, delta_t=1)
        next_sim = eng.control_step(self.model, state.sim, action,
                                    tgt.qpos[..., 7:], self.base_rot)
        # a blown-up env is snapped back to the expert frame and terminated
        bad = ~(torch.isfinite(next_sim.qpos).all(dim=-1)
                & torch.isfinite(next_sim.qvel).all(dim=-1))
        safe = self.expert_frame(state, delta_t=0)
        next_sim = eng.SimState(
            qpos=torch.where(bad[..., None], safe.qpos, next_sim.qpos),
            qvel=torch.where(bad[..., None], safe.qvel, next_sim.qvel))
        fk_res = fklib.fk(self.model.st, next_sim.qpos)

        new_t = state.cur_t + 1
        mid = state._replace(sim=next_sim, cur_t=new_t)
        reward, rinfo = self.reward(mid, next_sim, action, fk_res)

        length = self.bank.length[state.clip_idx]
        if cfg.env_term_body == "body":
            fail = self.calc_body_diff(mid, fk_res) > cfg.body_diff_thresh
        elif cfg.env_term_body == "Head":
            fail = (fk_res.xpos[..., self.head_idx, 2]
                    < self.bank.head_height_lb[state.clip_idx] - 0.1)
        else:
            fail = next_sim.qpos[..., 2] < self.bank.height_lb[state.clip_idx] - 0.1
        fail = fail | bad
        end = (new_t >= cfg.env_episode_len) | (
            new_t + state.start_ind >= length + cfg.env_expert_trail_steps)
        done = fail | end
        percent = new_t.to(next_sim.qpos.dtype) / length.to(next_sim.qpos.dtype)

        new_state = mid._replace(prev_bquat=fklib.body_quat_sim(next_sim.qpos),
                                 done=done, fail=fail)
        obs = self.get_obs(new_state, fk_res)
        return new_state, obs, reward, done, StepInfo(fail, end, percent, rinfo)

    @spanned("env.reset")
    def reset(self, clip_idx: torch.Tensor, start_ind: int = 0,
              deterministic: bool = True,
              generator: torch.Generator | None = None):
        """Each env starts on its clip's frame `start_ind`. Deterministic by
        default (the evaluation semantics: the reference's test-mode reset
        skips reactive init and noise); ``deterministic=False`` is the
        training reset, drawing from `generator` (one draw per env, fixed
        shapes whatever the draws give)."""
        cfg = self.cfg
        clip_idx = torch.as_tensor(clip_idx, device=self.model.device)
        start = torch.full_like(clip_idx, start_ind)
        f0 = exlib.bank_frame(self.bank, clip_idx, start)
        qpos, qvel = f0.qpos, f0.qvel
        if not deterministic:
            if generator is None:
                raise ValueError("the training reset needs a generator")
            n = clip_idx.shape[0]
            draw = dict(generator=generator, dtype=qpos.dtype, device=qpos.device)
            if cfg.env_init_noise > 0:
                noise = cfg.env_init_noise * torch.randn(n, qpos.shape[-1] - 7, **draw)
                qpos = torch.cat([qpos[..., :7], qpos[..., 7:] + noise], dim=-1)
            if self.mode == "train" and (cfg.reactive_v == 1 or (
                    cfg.reactive_v == 2 and self.hard_states is not None)):
                use = (torch.rand(n, **draw) < cfg.reactive_rate)[:, None]
                if cfg.reactive_v == 1:
                    q2, v2 = self.neutral_qpos, self.neutral_qvel
                else:
                    hq, hv = self.hard_states
                    k = torch.randint(0, hq.shape[0], (n,), generator=generator,
                                      device=qpos.device)
                    q2, v2 = hq[k], hv[k]
                q2 = self.match_heading_and_pos(qpos, q2.expand_as(qpos))
                qpos = torch.where(use, q2, qpos)
                qvel = torch.where(use, v2.expand_as(qvel), qvel)
        zero = torch.zeros_like(clip_idx, dtype=torch.bool)
        state = EnvState(
            sim=eng.SimState(qpos=qpos, qvel=qvel),
            cur_t=torch.zeros_like(clip_idx), start_ind=start,
            prev_bquat=fklib.body_quat_sim(qpos), clip_idx=clip_idx,
            done=zero, fail=zero)
        return state, self.get_obs(state)

    def match_heading_and_pos(self, qpos_1: torch.Tensor,
                              qpos_2: torch.Tensor) -> torch.Tensor:
        """qpos_2's pose with qpos_1's xy position and heading (reference
        humanoid_im.py:636-644)."""
        q1 = tmath.quat_mul(qpos_1[..., 3:7], tmath.quat_conj(self.base_rot))
        new_rot = tmath.quat_mul(tmath.heading_q(q1),
                                 tmath.de_heading(qpos_2[..., 3:7]))
        return torch.cat([qpos_1[..., :2], qpos_2[..., 2:3], new_rot,
                          qpos_2[..., 7:]], dim=-1)

    def fail_safe(self, state: EnvState) -> EnvState:
        """Teleport the sim to the expert pose."""
        f = self.expert_frame(state)
        return state._replace(sim=eng.SimState(qpos=f.qpos, qvel=f.qvel))


def make_bank(spec, model: eng.PhysicsModel, takes: list[np.ndarray]) -> exlib.ExpertClip:
    """Expert bank of qpos sequences (each (T_i, 76)), padded to the
    longest, in the model's dtype on its device."""
    t_max = max(t.shape[0] for t in takes)
    return exlib.stack_bank([
        exlib.from_qpos(spec, model.st, torch.as_tensor(
            np.asarray(t), dtype=model.dtype, device=model.device),
            dt=model.control_dt, pad_to=t_max)
        for t in takes])
