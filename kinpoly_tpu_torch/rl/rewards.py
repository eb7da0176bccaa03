"""UHC rewards (port of ``kinpoly_tpu/rl/rewards.py``): the UHC family
(``world_rfc_implicit`` and its ``_v1_mul``/``_v2``/``_v3`` variants,
``local_rfc_implicit``), the legacy imitation rewards that run on the same
inputs (``quat_v2``, ``deep_mimic``, ``local_world_*``, ``world_quat*``, ...)
and the ``get_uhc_reward`` lookup; and the kin-poly rewards of the AR env
(``dynamic_supervision_v2``-``_v6``, ``constant``) on ``ARRewardInputs``
with the ``get_kin_poly_reward`` lookup. The controller fine-tuning ids
(``fine_tune_*``) are not ported: no trainer builds their inputs.

Every reward is a function of a ``RewardInputs`` bundle and the weight dict
``ws`` (the env config's fields), batched over leading dims, and returns
(reward (...,), components (..., C)). The two ``*_explicit`` ids need
explicit residual forces in the engine, which the port does not have yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from kinpoly_tpu_torch.core import tmath


class RewardInputs(NamedTuple):
    """Everything the UHC rewards consume; unused fields may be None."""
    # current simulated state
    bquat: torch.Tensor       # (..., 96) sim-frame body quats
    wbquat: torch.Tensor      # (..., 96) world body quats
    wbpos: torch.Tensor       # (..., 72)
    body_com: torch.Tensor    # (..., 72)
    com: torch.Tensor         # (..., 3)
    ee_wpos: torch.Tensor     # (..., 15)
    bangvel: torch.Tensor     # (..., 72) fd from the previous step
    head_pose: torch.Tensor   # (..., 7)
    # expert frame
    e_bquat: torch.Tensor = None
    e_wbquat: torch.Tensor = None
    e_wbpos: torch.Tensor = None
    e_body_com: torch.Tensor = None
    e_com: torch.Tensor = None
    e_ee_wpos: torch.Tensor = None
    e_bangvel: torch.Tensor = None
    # residual force action
    vf: torch.Tensor = None
    # local-frame features (the ids in NEEDS_LOCAL_IDS and local_*)
    qpos: torch.Tensor = None          # (..., 76)
    rq_rmh: torch.Tensor = None        # (..., 4) de-headed root quat
    rlinv: torch.Tensor = None         # (..., 3) fd root lin vel, world frame
    rlinv_local: torch.Tensor = None   # (..., 3) fd root lin vel, root frame
    rangv: torch.Tensor = None         # (..., 3) fd root ang vel
    ee_pos: torch.Tensor = None        # (..., 15) end effectors, root frame
    e_qpos: torch.Tensor = None
    e_rq_rmh: torch.Tensor = None
    e_rlinv: torch.Tensor = None
    e_rlinv_local: torch.Tensor = None
    e_rangv: torch.Tensor = None
    e_ee_pos: torch.Tensor = None
    # weights
    b_diffw: torch.Tensor = None       # (23,)
    jpos_diffw: torch.Tensor = None    # (24,)


def _norm(x: torch.Tensor, ord: int = 2) -> torch.Tensor:
    if ord == 1:
        return torch.sum(torch.abs(x), dim=-1)
    return torch.linalg.norm(x, dim=-1)


def _exp(k: float, d: torch.Tensor) -> torch.Tensor:
    return torch.exp(-k * d ** 2)


def multi_quat_norm_v2(nq: torch.Tensor) -> torch.Tensor:
    """Per joint, |(|w| - 1, x, y, z)|, (..., 4N) -> (..., N)."""
    q = nq.reshape(nq.shape[:-1] + (-1, 4))
    d = torch.cat([torch.abs(q[..., :1]) - 1.0, q[..., 1:]], dim=-1)
    return torch.linalg.norm(d, dim=-1)


def _pose_diff(a: torch.Tensor, b: torch.Tensor, norm=tmath.multi_quat_norm):
    return norm(tmath.multi_quat_diff(a, b))


def world_rfc_implicit(inp: RewardInputs, ws: dict):
    """Weighted exp-kernels of body-quat distance, body angular velocity,
    end-effector and CoM distance, and the residual-force magnitude."""
    w_p, w_v, w_e = ws.get("w_p", 0.6), ws.get("w_v", 0.1), ws.get("w_e", 0.2)
    w_c, w_vf = ws.get("w_c", 0.1), ws.get("w_vf", 0.0)
    k_p, k_v, k_e = ws.get("k_p", 2.0), ws.get("k_v", 0.005), ws.get("k_e", 20.0)
    k_c, k_vf = ws.get("k_c", 1000.0), ws.get("k_vf", 1.0)
    v_ord = ws.get("v_ord", 2)

    pose_diff = _pose_diff(inp.bquat, inp.e_bquat)
    pose_diff = torch.cat([pose_diff[..., :1], pose_diff[..., 1:] * inp.b_diffw],
                          dim=-1)
    pose_r = _exp(k_p, torch.linalg.norm(pose_diff, dim=-1))
    vel_r = _exp(k_v, _norm(inp.bangvel - inp.e_bangvel, v_ord))
    ee_r = _exp(k_e, _norm(inp.ee_wpos - inp.e_ee_wpos))
    com_r = _exp(k_c, _norm(inp.com - inp.e_com))
    vf_r = _exp(k_vf, _norm(inp.vf)) if w_vf > 0 else torch.zeros_like(pose_r)
    total = w_p + w_v + w_e + w_c + w_vf
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_c * com_r
              + w_vf * vf_r) / total
    return reward, torch.stack([pose_r, vel_r, ee_r, com_r, vf_r], dim=-1)


def world_rfc_implicit_v1_mul(inp: RewardInputs, ws: dict):
    """The product of world_rfc_implicit's terms, vf included."""
    _, comps = world_rfc_implicit(inp, dict(ws, w_vf=1.0))
    return torch.prod(comps, dim=-1), comps


def _v2_components(inp: RewardInputs, ws: dict):
    k_p, k_wp = ws.get("k_p", 0.4), ws.get("k_wp", 0.4)
    k_v, k_j, k_c = ws.get("k_v", 0.005), ws.get("k_j", 100.0), ws.get("k_c", 100.0)
    k_vf = ws.get("k_vf", 1.0)
    w = inp.jpos_diffw

    pd = _pose_diff(inp.bquat, inp.e_bquat) * w
    pose_r = torch.exp(-k_p * torch.mean(pd ** 2, dim=-1))
    wpd = _pose_diff(inp.wbquat, inp.e_wbquat) * w
    wpose_r = torch.exp(-k_wp * torch.mean(wpd ** 2, dim=-1))
    vel_r = torch.exp(-k_v * torch.mean((inp.bangvel - inp.e_bangvel) ** 2, dim=-1))

    shape = inp.body_com.shape[:-1] + (24, 3)
    dc = (inp.e_body_com.reshape(shape) - inp.body_com.reshape(shape)) * w[:, None]
    com_r = torch.exp(-k_c * torch.mean(torch.linalg.norm(dc, dim=-1) ** 2, dim=-1))
    dj = (inp.wbpos.reshape(shape) - inp.e_wbpos.reshape(shape)) * w[:, None]
    jpos_r = torch.exp(-k_j * torch.mean(torch.linalg.norm(dj, dim=-1) ** 2, dim=-1))
    vf_r = _exp(k_vf, _norm(inp.vf))
    return torch.stack([pose_r, wpose_r, com_r, jpos_r, vel_r, vf_r], dim=-1)


def world_rfc_implicit_v2(inp: RewardInputs, ws: dict):
    """Product of body-quat, world-quat, per-body CoM and joint-position,
    angular-velocity and residual-force kernels."""
    comps = _v2_components(inp, ws)
    return torch.prod(comps, dim=-1), comps


def world_rfc_implicit_v3(inp: RewardInputs, ws: dict):
    """Weighted sum of v2's terms."""
    comps = _v2_components(inp, ws)
    w = torch.tensor([ws.get("w_p", 0.4), ws.get("w_wp", 0.4), ws.get("w_c", 100.0),
                      ws.get("w_j", 100.0), ws.get("w_v", 0.005), ws.get("w_vf", 1.0)],
                     dtype=comps.dtype, device=comps.device)
    return torch.sum(comps * w, dim=-1), comps


def _root_pose_vel(inp: RewardInputs, ws: dict):
    """exp(-k_rh dh^2 - k_rq dq^2) of root height and de-headed root quat,
    exp(-k_rl dl^2 - k_ra da^2) of root-frame linear and angular velocity."""
    k_rh, k_rq = ws.get("k_rh", 300.0), ws.get("k_rq", 300.0)
    k_rl, k_ra = ws.get("k_rl", 5.0), ws.get("k_ra", 0.5)
    rh_d = inp.qpos[..., 2] - inp.e_qpos[..., 2]
    rq_d = _pose_diff(inp.rq_rmh, inp.e_rq_rmh)[..., 0]
    root_pose_r = torch.exp(-k_rh * rh_d ** 2 - k_rq * rq_d ** 2)
    rl_d = _norm(inp.rlinv_local - inp.e_rlinv_local)
    ra_d = _norm(inp.rangv - inp.e_rangv)
    root_vel_r = torch.exp(-k_rl * rl_d ** 2 - k_ra * ra_d ** 2)
    return root_pose_r, root_vel_r


def _pose_nonroot(inp: RewardInputs, k_p: float, weighted: bool = True,
                  norm_v2: bool = False):
    """exp kernel of the non-root body-quat distance."""
    pd = _pose_diff(inp.bquat[..., 4:], inp.e_bquat[..., 4:],
                    multi_quat_norm_v2 if norm_v2 else tmath.multi_quat_norm)
    if weighted:
        pd = pd * inp.b_diffw
    return _exp(k_p, torch.linalg.norm(pd, dim=-1))


def _local_terms(inp: RewardInputs, ws: dict):
    """Non-root pose, non-root angular velocity and root-frame end
    effectors: the first three terms of local_rfc_implicit and quat_v3."""
    k_p, k_v, k_e = ws.get("k_p", 2.0), ws.get("k_v", 0.005), ws.get("k_e", 20.0)
    v_ord = ws.get("v_ord", 2)
    pose_r = _pose_nonroot(inp, k_p)
    vel_r = _exp(k_v, _norm(inp.bangvel[..., 3:] - inp.e_bangvel[..., 3:], v_ord))
    ee_r = _exp(k_e, _norm(inp.ee_pos - inp.e_ee_pos))
    return pose_r, vel_r, ee_r


def local_rfc_implicit(inp: RewardInputs, ws: dict):
    """Local-frame pose, velocity and end effectors, root pose and velocity
    kernels, and the residual-force magnitude."""
    w_p, w_v, w_e = ws.get("w_p", 0.5), ws.get("w_v", 0.0), ws.get("w_e", 0.2)
    w_rp, w_rv, w_vf = ws.get("w_rp", 0.1), ws.get("w_rv", 0.1), ws.get("w_vf", 0.1)
    k_vf = ws.get("k_vf", 1.0)
    pose_r, vel_r, ee_r = _local_terms(inp, ws)
    root_pose_r, root_vel_r = _root_pose_vel(inp, ws)
    vf_r = _exp(k_vf, _norm(inp.vf)) if w_vf > 0 else torch.zeros_like(pose_r)
    total = w_p + w_v + w_e + w_rp + w_rv + w_vf
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_rp * root_pose_r
              + w_rv * root_vel_r + w_vf * vf_r) / total
    return reward, torch.stack(
        [pose_r, vel_r, ee_r, root_pose_r, root_vel_r, vf_r], dim=-1)


def _root_composite(inp: RewardInputs, ws: dict):
    """exp kernel of w_rq |rq_rmh diff| + w_rlinv |rlinv_local diff|
    + w_rangv |rangv diff|."""
    w_rq, w_rlinv = ws.get("w_rq", 2.0), ws.get("w_rlinv", 1.0)
    w_rangv, k_r = ws.get("w_rangv", 0.1), ws.get("k_r", 1.0)
    rq_dist = _pose_diff(inp.rq_rmh, inp.e_rq_rmh)[..., 0]
    rlinv_dist = _norm(inp.rlinv_local - inp.e_rlinv_local)
    rangv_dist = _norm(inp.rangv - inp.e_rangv)
    return _exp(k_r, w_rq * rq_dist + w_rlinv * rlinv_dist + w_rangv * rangv_dist)


def quat_space_reward_v2(inp: RewardInputs, ws: dict):
    """Local pose, velocity and end effectors, CoM height, composite root
    kernel."""
    w_p, w_v, w_e = ws.get("w_p", 0.5), ws.get("w_v", 0.05), ws.get("w_e", 0.15)
    w_c, w_r = ws.get("w_c", 0.1), ws.get("w_r", 0.2)
    k_c = ws.get("k_c", 1000.0)
    pose_r, vel_r, ee_r = _local_terms(inp, ws)
    com_r = _exp(k_c, inp.com[..., 2] - inp.e_com[..., 2])
    root_r = _root_composite(inp, ws)
    total = w_p + w_v + w_e + w_c + w_r
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_c * com_r
              + w_r * root_r) / total
    return reward, torch.stack([pose_r, vel_r, ee_r, com_r, root_r], dim=-1)


def quat_space_reward_v3(inp: RewardInputs, ws: dict):
    """local_rfc_implicit without the residual-force term."""
    w_p, w_v, w_e = ws.get("w_p", 0.5), ws.get("w_v", 0.1), ws.get("w_e", 0.2)
    w_rp, w_rv = ws.get("w_rp", 0.1), ws.get("w_rv", 0.1)
    pose_r, vel_r, ee_r = _local_terms(inp, ws)
    root_pose_r, root_vel_r = _root_pose_vel(inp, ws)
    total = w_p + w_v + w_e + w_rp + w_rv
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_rp * root_pose_r
              + w_rv * root_vel_r) / total
    return reward, torch.stack([pose_r, vel_r, ee_r, root_pose_r, root_vel_r],
                               dim=-1)


def deep_mimic_reward(inp: RewardInputs, ws: dict):
    """All-joint pose, world end effectors, root position. The reference
    weights the pose distance after taking its norm, which has no effect,
    so it is not weighted here."""
    w_p, w_v, w_e, w_c = (ws.get("w_p", 0.65), ws.get("w_v", 0.1),
                          ws.get("w_e", 0.15), ws.get("w_c", 0.1))
    k_p, k_v, k_e, k_c = (ws.get("k_p", 2.0), ws.get("k_v", 0.1),
                          ws.get("k_e", 10.0), ws.get("k_c", 10.0))
    pose_r = _exp(k_p, torch.linalg.norm(_pose_diff(inp.bquat, inp.e_bquat), dim=-1))
    vel_r = _exp(k_v, _norm(inp.bangvel - inp.e_bangvel))
    ee_r = _exp(k_e, _norm(inp.ee_wpos - inp.e_ee_wpos))
    root_r = _exp(k_c, _norm(inp.qpos[..., :3] - inp.e_qpos[..., :3]))
    total = w_p + w_v + w_e + w_c
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_c * root_r) / total
    return reward, torch.stack([pose_r, vel_r, ee_r, root_r], dim=-1)


def _deep_mimic_v2_components(inp: RewardInputs, ws: dict):
    k_p, k_v, k_e = ws.get("k_p", 2.0), ws.get("k_v", 0.1), ws.get("k_e", 10.0)
    k_rp, k_rq = ws.get("k_rp", 10.0), ws.get("k_rq", 10.0)
    pose_r = _pose_nonroot(inp, k_p, weighted=False, norm_v2=True)
    vel_r = _exp(k_v, _norm(inp.bangvel - inp.e_bangvel))
    ee_r = _exp(k_e, _norm(inp.ee_wpos - inp.e_ee_wpos))
    rp_r = _exp(k_rp, _norm(inp.qpos[..., :3] - inp.e_qpos[..., :3]))
    rq_dist = _pose_diff(inp.bquat[..., :4], inp.e_bquat[..., :4],
                         multi_quat_norm_v2)[..., 0]
    return pose_r, vel_r, ee_r, rp_r, _exp(k_rq, rq_dist)


def deep_mimic_reward_v2(inp: RewardInputs, ws: dict):
    """deep_mimic with the v2 quat norm and a root-quat term."""
    w_p, w_v, w_e = ws.get("w_p", 0.65), ws.get("w_v", 0.1), ws.get("w_e", 0.15)
    w_rp, w_rq = ws.get("w_rp", 0.1), ws.get("w_rq", 0.1)
    pose_r, vel_r, ee_r, rp_r, rq_r = _deep_mimic_v2_components(inp, ws)
    total = w_p + w_v + w_e + w_rp + w_rq
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_rp * rp_r
              + w_rq * rq_r) / total
    return reward, torch.stack([pose_r, vel_r, ee_r, rp_r, rq_r], dim=-1)


def deep_mimic_reward_v2_vf(inp: RewardInputs, ws: dict):
    """deep_mimic_v2 plus the residual-force magnitude kernel."""
    w_p, w_v, w_e = ws.get("w_p", 0.65), ws.get("w_v", 0.1), ws.get("w_e", 0.15)
    w_rp, w_rq, w_vf = ws.get("w_rp", 0.1), ws.get("w_rq", 0.1), ws.get("w_vf", 0.1)
    k_vf = ws.get("k_vf", 1.0)
    pose_r, vel_r, ee_r, rp_r, rq_r = _deep_mimic_v2_components(inp, ws)
    vf_r = _exp(k_vf, _norm(inp.vf))
    total = w_p + w_v + w_e + w_rp + w_rq + w_vf
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_rp * rp_r
              + w_rq * rq_r + w_vf * vf_r) / total
    return reward, torch.stack([pose_r, vel_r, ee_r, rp_r, rq_r, vf_r], dim=-1)


def multiplicable_reward(inp: RewardInputs, ws: dict):
    """Product of pose, velocity, world end-effector, root position and
    root quat kernels."""
    k_p, k_v, k_e = ws.get("k_p", 2.0), ws.get("k_v", 0.1), ws.get("k_e", 10.0)
    k_rp, k_rq = ws.get("k_rp", 10.0), ws.get("k_rq", 10.0)
    pose_r = _pose_nonroot(inp, k_p, weighted=False)
    vel_r = _exp(k_v, _norm(inp.bangvel - inp.e_bangvel))
    ee_r = _exp(k_e, _norm(inp.ee_wpos - inp.e_ee_wpos))
    rp_r = _exp(k_rp, _norm(inp.qpos[..., :3] - inp.e_qpos[..., :3]))
    rq_r = _exp(k_rq, _pose_diff(inp.qpos[..., 3:7], inp.e_qpos[..., 3:7])[..., 0])
    comps = torch.stack([pose_r, vel_r, ee_r, rp_r, rq_r], dim=-1)
    return torch.prod(comps, dim=-1), comps


def local_world_reward_v1(inp: RewardInputs, ws: dict):
    """quat_v2 with a world-frame end-effector term and full CoM."""
    w_p, w_v, w_e = ws.get("w_p", 0.4), ws.get("w_v", 0.05), ws.get("w_e", 0.15)
    w_we, w_c, w_r = ws.get("w_we", 0.1), ws.get("w_c", 0.1), ws.get("w_r", 0.2)
    k_we, k_c = ws.get("k_we", 20.0), ws.get("k_c", 1000.0)
    pose_r, vel_r, ee_r = _local_terms(inp, ws)
    wee_r = _exp(k_we, _norm(inp.ee_wpos - inp.e_ee_wpos))
    com_r = _exp(k_c, _norm(inp.com - inp.e_com))
    root_r = _root_composite(inp, ws)
    total = w_p + w_v + w_e + w_we + w_c + w_r
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_we * wee_r
              + w_c * com_r + w_r * root_r) / total
    return reward, torch.stack([pose_r, vel_r, ee_r, wee_r, com_r, root_r],
                               dim=-1)


def _local_world_v23(inp: RewardInputs, ws: dict, com_z_only: bool):
    w_p, w_v, w_e = ws.get("w_p", 0.4), ws.get("w_v", 0.05), ws.get("w_e", 0.15)
    w_h, w_c, w_r = ws.get("w_h", 0.1), ws.get("w_c", 0.1), ws.get("w_r", 0.2)
    k_h, k_c = ws.get("k_h", 20.0), ws.get("k_c", 1000.0)
    pose_r, vel_r, ee_r = _local_terms(inp, ws)
    h_dist = tmath.wrap_to_pi(tmath.heading(inp.qpos[..., 3:7])
                              - tmath.heading(inp.e_qpos[..., 3:7]))
    h_r = _exp(k_h, h_dist)
    com_d = (inp.com[..., 2] - inp.e_com[..., 2]) if com_z_only \
        else _norm(inp.com - inp.e_com)
    com_r = _exp(k_c, com_d)
    root_r = _root_composite(inp, ws)
    total = w_p + w_v + w_e + w_h + w_c + w_r
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_h * h_r
              + w_c * com_r + w_r * root_r) / total
    return reward, torch.stack([pose_r, vel_r, ee_r, h_r, com_r, root_r], dim=-1)


def local_world_reward_v2(inp: RewardInputs, ws: dict):
    """quat_v2 with a heading kernel and full CoM."""
    return _local_world_v23(inp, ws, com_z_only=False)


def local_world_reward_v3(inp: RewardInputs, ws: dict):
    """local_world_v2 with the CoM height only."""
    return _local_world_v23(inp, ws, com_z_only=True)


def world_quat_space_reward(inp: RewardInputs, ws: dict):
    """world_rfc_implicit without the residual-force term."""
    w_p, w_v, w_e, w_c = (ws.get("w_p", 0.6), ws.get("w_v", 0.1),
                          ws.get("w_e", 0.2), ws.get("w_c", 0.1))
    _, comps = world_rfc_implicit(inp, dict(ws, w_vf=0.0))
    pose_r, vel_r, ee_r, com_r = comps[..., :4].unbind(-1)
    total = w_p + w_v + w_e + w_c
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_c * com_r) / total
    return reward, comps[..., :4]


def world_quat_space_reward_v2(inp: RewardInputs, ws: dict):
    """world_quat plus a composite world-frame root kernel."""
    w_p, w_v, w_e = ws.get("w_p", 0.3), ws.get("w_v", 0.1), ws.get("w_e", 0.3)
    w_c, w_r = ws.get("w_c", 0.1), ws.get("w_r", 0.2)
    k_r = ws.get("k_r", 1.0)
    w_rpos, w_rq = ws.get("w_rpos", 5.0), ws.get("w_rq", 2.0)
    w_rlinv, w_rangv = ws.get("w_rlinv", 1.0), ws.get("w_rangv", 0.1)
    _, comps = world_quat_space_reward(inp, ws)
    rpos_dist = _norm(inp.qpos[..., :3] - inp.e_qpos[..., :3])
    rq_dist = _pose_diff(inp.qpos[..., 3:7], inp.e_qpos[..., 3:7])[..., 0]
    rlinv_dist = _norm(inp.rlinv - inp.e_rlinv)
    rangv_dist = _norm(inp.rangv - inp.e_rangv)
    root_r = _exp(k_r, w_rpos * rpos_dist + w_rq * rq_dist
                  + w_rlinv * rlinv_dist + w_rangv * rangv_dist)
    pose_r, vel_r, ee_r, com_r = comps.unbind(-1)
    total = w_p + w_v + w_e + w_c + w_r
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_c * com_r
              + w_r * root_r) / total
    return reward, torch.stack([pose_r, vel_r, ee_r, com_r, root_r], dim=-1)


UHC_REWARDS: dict[str, Callable] = {
    "world_rfc_implicit": world_rfc_implicit,
    "world_rfc_implicit_v1_mul": world_rfc_implicit_v1_mul,
    "world_rfc_implicit_v2": world_rfc_implicit_v2,
    "world_rfc_implicit_v3": world_rfc_implicit_v3,
    "local_rfc_implicit": local_rfc_implicit,
}

# the explicit-RFC ids split the action into per-body contact points and
# forces, which only an engine with explicit residual forces applies
EXPLICIT_IDS = frozenset(("world_rfc_explicit", "local_rfc_explicit"))

LEGACY_IMITATION_REWARDS: dict[str, Callable] = {
    "quat_v2": quat_space_reward_v2,
    "quat_v3": quat_space_reward_v3,
    "deep_mimic": deep_mimic_reward,
    "deep_mimic_v2": deep_mimic_reward_v2,
    "deep_mimic_reward_v2_vf": deep_mimic_reward_v2_vf,
    # the reference's _vf_vq computes the same five terms as deep_mimic_v2
    "deep_mimic_reward_v2_vf_vq": deep_mimic_reward_v2,
    "multiplicable_reward": multiplicable_reward,
    "local_world_v1": local_world_reward_v1,
    "local_world_v2": local_world_reward_v2,
    "local_world_v3": local_world_reward_v3,
    "world_quat": world_quat_space_reward,
    "world_quat_v2": world_quat_space_reward_v2,
}

# ids whose formulas read the local-frame features; the env builds them for
# these and for every local_* id
NEEDS_LOCAL_IDS = frozenset((
    "quat_v2", "quat_v3", "deep_mimic", "deep_mimic_v2",
    "deep_mimic_reward_v2_vf", "deep_mimic_reward_v2_vf_vq",
    "multiplicable_reward", "local_world_v1", "local_world_v2",
    "local_world_v3", "world_quat_v2",
))


def needs_local(reward_id: str) -> bool:
    return reward_id.startswith("local_") or reward_id in NEEDS_LOCAL_IDS


def get_uhc_reward(reward_id: str) -> Callable:
    """The legacy imitation ids first, then the UHC family (the JAX
    lookup order)."""
    if reward_id in LEGACY_IMITATION_REWARDS:
        return LEGACY_IMITATION_REWARDS[reward_id]
    if reward_id in EXPLICIT_IDS:
        raise KeyError(f"reward_id {reward_id!r} needs explicit residual "
                       f"forces in the engine, which the port does not have")
    if reward_id not in UHC_REWARDS:
        raise KeyError(f"unknown UHC reward_id {reward_id!r}; available: "
                       f"{sorted(UHC_REWARDS) + sorted(LEGACY_IMITATION_REWARDS)}")
    return UHC_REWARDS[reward_id]


# ---------------------------------------------------------------------------
# kin-poly rewards (the dynamic supervision family of the AR env;
# dynamic_supervision_v1 lives in envs/humanoid_ar.py)
# ---------------------------------------------------------------------------


class ARRewardInputs(NamedTuple):
    """What the kin-poly rewards consume, batched (..., d)."""
    head_pose: torch.Tensor
    tgt_head_pose: torch.Tensor
    bquat: torch.Tensor
    wbpos: torch.Tensor
    tgt_bquat: torch.Tensor      # the AR target (this step's integrated action)
    tgt_wbpos: torch.Tensor
    gt_bquat: torch.Tensor       # ground truth
    gt_prev_bquat: torch.Tensor
    gt_wbpos: torch.Tensor = None
    gt_bangvel: torch.Tensor = None
    bangvel: torch.Tensor = None
    b_diffw: torch.Tensor = None
    tgt_qpos: torch.Tensor = None       # the integrated action
    ar_qpos: torch.Tensor = None        # the AR rollout at this frame
    ar_bquat: torch.Tensor = None
    ar_prev_bquat: torch.Tensor = None  # the AR rollout at the frame before
    prev_bquat: torch.Tensor = None     # simulated, the step before


def dynamic_supervision_v2(inp: ARRewardInputs, ws: dict, dt: float):
    """Imitation and head tracking, no dynamics regulation."""
    w_hp, w_hq = ws.get("w_hp", 1.0), ws.get("w_hq", 1.0)
    w_p, w_v, w_e = ws.get("w_p", 0.6), ws.get("w_v", 0.1), ws.get("w_e", 0.2)
    k_hp, k_hq = ws.get("k_hp", 1.0), ws.get("k_hq", 1.0)
    k_p, k_v, k_e = ws.get("k_p", 2.0), ws.get("k_v", 0.005), ws.get("k_e", 20.0)
    hp_r = _exp(k_hp, _norm(inp.head_pose[..., :3] - inp.tgt_head_pose[..., :3]))
    hq_d = multi_quat_norm_v2(tmath.quat_mul(
        inp.head_pose[..., 3:], tmath.quat_inv(inp.tgt_head_pose[..., 3:]))
    ).mean(-1)
    hq_r = _exp(k_hq, hq_d)
    pd = tmath.multi_quat_norm(tmath.multi_quat_diff(inp.bquat, inp.gt_bquat))
    pd = torch.cat([pd[..., :1], pd[..., 1:] * inp.b_diffw], dim=-1)
    pose_r = _exp(k_p, torch.linalg.norm(pd, dim=-1))
    vel_r = _exp(k_v, _norm(inp.bangvel - inp.gt_bangvel))
    ee_r = _exp(k_e, _norm(inp.wbpos - inp.gt_wbpos))
    reward = w_hp * hp_r + w_hq * hq_r + w_p * pose_r + w_v * vel_r + w_e * ee_r
    return reward, torch.stack([hp_r, hq_r, pose_r, vel_r, ee_r], dim=-1)


def _head_target_terms(inp: ARRewardInputs, ws: dict):
    """Head position and rotation, and body rotation and position against
    the AR target: shared by v3-v6."""
    k_hp, k_hq = ws.get("k_hp", 1.0), ws.get("k_hq", 1.0)
    k_p, k_jp = ws.get("k_p", 1.0), ws.get("k_jp", 0.1)
    hp_r = _exp(k_hp, _norm(inp.head_pose[..., :3] - inp.tgt_head_pose[..., :3]))
    hq_d = multi_quat_norm_v2(tmath.multi_quat_diff(
        inp.head_pose[..., 3:], inp.tgt_head_pose[..., 3:])).mean(-1)
    hq_r = _exp(k_hq, hq_d)
    pq_d = multi_quat_norm_v2(
        tmath.multi_quat_diff(inp.bquat, inp.tgt_bquat)).mean(-1)
    p_r = _exp(k_p, pq_d)
    shape = inp.wbpos.shape[:-1] + (24, 3)
    pp_d = torch.linalg.norm(inp.wbpos.reshape(shape)
                             - inp.tgt_wbpos.reshape(shape), dim=-1).mean(-1)
    jp_r = _exp(k_jp, pp_d)
    return hp_r, hq_r, p_r, jp_r


def dynamic_supervision_v3(inp: ARRewardInputs, ws: dict, dt: float):
    """Multiplicative head and target tracking, and the integrated action
    pulled toward the AR rollout (root position and rotation, body
    rotation)."""
    k_rp, k_rq = ws.get("k_rp", 0.1), ws.get("k_rq", 0.1)
    k_act_p = ws.get("k_act_p", 0.1)
    hp_r, hq_r, p_r, jp_r = _head_target_terms(inp, ws)
    rp_d = _norm(inp.ar_qpos[..., :3] - inp.tgt_qpos[..., :3])
    rq_d = multi_quat_norm_v2(tmath.multi_quat_diff(
        inp.ar_qpos[..., 3:7], inp.tgt_qpos[..., 3:7])).mean(-1)
    act_p_d = multi_quat_norm_v2(
        tmath.multi_quat_diff(inp.ar_bquat, inp.tgt_bquat)).mean(-1)
    rp_r = _exp(k_rp, rp_d)
    rq_r = _exp(k_rq, rq_d)
    act_p_r = torch.exp(-k_act_p * act_p_d)     # not squared, as the reference
    reward = hp_r * hq_r * p_r * jp_r * rp_r * rq_r * act_p_r
    return reward, torch.stack(
        [hp_r, hq_r, p_r, jp_r, rp_r, rq_r, act_p_r], dim=-1)


def dynamic_supervision_v4(inp: ARRewardInputs, ws: dict, dt: float):
    """Additive head and target tracking, no action terms (the head
    velocity term is 0, as the reference leaves it)."""
    w_hp, w_hq = ws.get("w_hp", 1.0), ws.get("w_hq", 1.0)
    w_hv, w_p, w_jp = ws.get("w_hv", 0.05), ws.get("w_p", 1.0), ws.get("w_jp", 1.0)
    hp_r, hq_r, p_r, jp_r = _head_target_terms(inp, ws)
    hv_r = torch.zeros_like(hp_r)
    reward = (w_hp * hp_r + w_hq * hq_r + w_hv * hv_r
              + w_p * p_r + w_jp * jp_r)
    return reward, torch.stack([hp_r, hq_r, hv_r, p_r, jp_r], dim=-1)


def dynamic_supervision_v5(inp: ARRewardInputs, ws: dict, dt: float):
    """v4, multiplicative."""
    hp_r, hq_r, p_r, jp_r = _head_target_terms(inp, ws)
    return hp_r * hq_r * p_r * jp_r, torch.stack([hp_r, hq_r, p_r, jp_r], dim=-1)


def dynamic_supervision_v6(inp: ARRewardInputs, ws: dict, dt: float):
    """Additive head and target tracking and the body angular velocity
    against the AR rollout's."""
    w_hp, w_hq = ws.get("w_hp", 1.0), ws.get("w_hq", 1.0)
    w_p, w_jp, w_act_v = ws.get("w_p", 1.0), ws.get("w_jp", 1.0), ws.get("w_act_v", 1.0)
    k_act_v = ws.get("k_act_v", 0.1)
    v_ord = ws.get("v_ord", 2)
    hp_r, hq_r, p_r, jp_r = _head_target_terms(inp, ws)
    cur_bangvel = tmath.angvel_fd(inp.prev_bquat, inp.bquat, dt)
    tgt_bangvel = tmath.angvel_fd(inp.ar_prev_bquat, inp.ar_bquat, dt)
    act_v_r = _exp(k_act_v, _norm(cur_bangvel - tgt_bangvel, v_ord))
    reward = (w_hp * hp_r + w_hq * hq_r + w_p * p_r + w_jp * jp_r
              + w_act_v * act_v_r)
    return reward, torch.stack([hp_r, hq_r, p_r, jp_r, act_v_r], dim=-1)


def constant_reward(inp: ARRewardInputs, ws: dict, dt: float):
    one = torch.ones(inp.head_pose.shape[:-1], dtype=inp.head_pose.dtype,
                     device=inp.head_pose.device)
    return one, one[..., None]


KIN_POLY_REWARDS: dict[str, Callable] = {
    "dynamic_supervision_v2": dynamic_supervision_v2,
    "dynamic_supervision_v3": dynamic_supervision_v3,
    "dynamic_supervision_v4": dynamic_supervision_v4,
    "dynamic_supervision_v5": dynamic_supervision_v5,
    "dynamic_supervision_v6": dynamic_supervision_v6,
    "constant": constant_reward,
}

# the controller fine-tuning rewards of the kin-poly registry: no trainer
# builds their inputs
FINE_TUNE_IDS = frozenset(("fine_tune_kin_action_reward",
                           "fine_tune_action_reward", "fine_tune_reward"))


def get_kin_poly_reward(reward_id: str) -> Callable:
    """A kin-poly reward by id, as the JAX lookup: an imitation id is the
    UHC env's, not the AR env's."""
    if reward_id in FINE_TUNE_IDS:
        raise KeyError(f"kin-poly reward_id {reward_id!r} is a controller "
                       f"fine-tuning reward, which the port does not have")
    if reward_id in LEGACY_IMITATION_REWARDS:
        raise KeyError(
            f"kin-poly reward_id {reward_id!r} is an imitation reward; "
            f"set it as the UHC env's reward_id instead")
    if reward_id not in KIN_POLY_REWARDS:
        raise KeyError(f"unknown kin-poly reward_id {reward_id!r}; "
                       f"available: {sorted(KIN_POLY_REWARDS)}")
    return KIN_POLY_REWARDS[reward_id]
