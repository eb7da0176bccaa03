"""UHC reward (port of ``kinpoly_tpu/rl/rewards.py``: ``world_rfc_implicit``
and the ``get_uhc_reward`` lookup for it)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from kinpoly_tpu_torch.core import tmath


class RewardInputs(NamedTuple):
    """What ``world_rfc_implicit`` consumes, for the simulated state and the
    expert frame."""
    bquat: torch.Tensor       # (..., 96) sim-frame body quats
    bangvel: torch.Tensor     # (..., 72) fd body angular velocity
    ee_wpos: torch.Tensor     # (..., 15)
    com: torch.Tensor         # (..., 3)
    e_bquat: torch.Tensor
    e_bangvel: torch.Tensor
    e_ee_wpos: torch.Tensor
    e_com: torch.Tensor
    vf: torch.Tensor          # (..., 6) residual force action
    b_diffw: torch.Tensor     # (23,)


def world_rfc_implicit(inp: RewardInputs, ws: dict):
    """Weighted exp-kernels of body-quat distance, body angular velocity,
    end-effector and CoM distance, and the residual-force magnitude.
    Returns (reward (...,), components (..., 5))."""
    w_p, w_v, w_e = ws.get("w_p", 0.6), ws.get("w_v", 0.1), ws.get("w_e", 0.2)
    w_c, w_vf = ws.get("w_c", 0.1), ws.get("w_vf", 0.0)
    k_p, k_v, k_e = ws.get("k_p", 2.0), ws.get("k_v", 0.005), ws.get("k_e", 20.0)
    k_c, k_vf = ws.get("k_c", 1000.0), ws.get("k_vf", 1.0)
    v_ord = ws.get("v_ord", 2)

    def norm(x):
        if v_ord == 1:
            return torch.sum(torch.abs(x), dim=-1)
        return torch.linalg.norm(x, dim=-1)

    pose_diff = tmath.multi_quat_norm(tmath.multi_quat_diff(inp.bquat, inp.e_bquat))
    pose_diff = torch.cat([pose_diff[..., :1], pose_diff[..., 1:] * inp.b_diffw],
                          dim=-1)
    pose_r = torch.exp(-k_p * torch.linalg.norm(pose_diff, dim=-1) ** 2)
    vel_r = torch.exp(-k_v * norm(inp.bangvel - inp.e_bangvel) ** 2)
    ee_r = torch.exp(-k_e * torch.linalg.norm(inp.ee_wpos - inp.e_ee_wpos, dim=-1) ** 2)
    com_r = torch.exp(-k_c * torch.linalg.norm(inp.com - inp.e_com, dim=-1) ** 2)
    vf_r = (torch.exp(-k_vf * torch.linalg.norm(inp.vf, dim=-1) ** 2) if w_vf > 0
            else torch.zeros_like(pose_r))
    total = w_p + w_v + w_e + w_c + w_vf
    reward = (w_p * pose_r + w_v * vel_r + w_e * ee_r + w_c * com_r
              + w_vf * vf_r) / total
    return reward, torch.stack([pose_r, vel_r, ee_r, com_r, vf_r], dim=-1)


UHC_REWARDS: dict[str, Callable] = {"world_rfc_implicit": world_rfc_implicit}


def get_uhc_reward(reward_id: str) -> Callable:
    if reward_id not in UHC_REWARDS:
        raise KeyError(f"reward_id {reward_id!r} is not ported; available: "
                       f"{sorted(UHC_REWARDS)}")
    return UHC_REWARDS[reward_id]
