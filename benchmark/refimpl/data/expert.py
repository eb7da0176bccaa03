"""Expert clip features (as ``kinpoly_tpu/data/expert.py``): the
kinematic features of a qpos sequence from one batched FK, stored as
fixed-shape tensors so a bank of clips can be indexed per env.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refimpl.core import tmath
from refimpl.physics import fk as fklib

EE_NAMES = ["L_Toe", "R_Toe", "L_Wrist", "R_Wrist", "Head"]


class ExpertClip(NamedTuple):
    """Per-frame expert features (leading dim T, or (N, T) for a bank)."""
    qpos: torch.Tensor         # (T, 76)
    qvel: torch.Tensor         # (T, 75) finite-diff, clipped +-10
    wbpos: torch.Tensor        # (T, 72)
    wbquat: torch.Tensor       # (T, 96)
    bquat: torch.Tensor        # (T, 96)
    ee_wpos: torch.Tensor      # (T, 15)
    ee_pos: torch.Tensor       # (T, 15)
    com: torch.Tensor          # (T, 3)
    body_com: torch.Tensor     # (T, 72)
    head_pose: torch.Tensor    # (T, 7)
    rq_rmh: torch.Tensor       # (T, 4)
    rlinv: torch.Tensor        # (T, 3)
    rlinv_local: torch.Tensor  # (T, 3)
    rangv: torch.Tensor        # (T, 3)
    bangvel: torch.Tensor      # (T, 72)
    length: torch.Tensor       # () int64 true length (<= T)
    height_lb: torch.Tensor    # ()
    head_height_lb: torch.Tensor  # ()


def ee_world(fk_res: fklib.FKResult, ee_idx) -> torch.Tensor:
    pos = fk_res.xpos[..., ee_idx, :]
    return pos.reshape(pos.shape[:-2] + (-1,))


def ee_in_root(fk_res: fklib.FKResult, qpos: torch.Tensor, ee_idx,
               coord: str = "root") -> torch.Tensor:
    pos = fk_res.xpos[..., ee_idx, :] - qpos[..., None, 0:3]
    pos = tmath.transform_vec(pos, qpos[..., None, 3:7], coord)
    return pos.reshape(pos.shape[:-2] + (-1,))


def from_qpos(spec, st, qpos_seq: torch.Tensor, dt: float,
              obs_coord: str = "root", pad_to: int | None = None) -> ExpertClip:
    """qpos sequence (T, 76) -> ExpertClip, optionally padded to `pad_to`
    frames by repeating the last frame."""
    qpos = qpos_seq
    T = qpos.shape[0]
    ee_idx = fklib.make_body_index(spec, EE_NAMES)
    head = spec.body_index("Head")

    res = fklib.fk(st, qpos)
    bquat = fklib.body_quat_sim(qpos)
    head_pose = torch.cat([res.xpos[:, head], res.xquat[:, head]], dim=-1)
    qvel = torch.clamp(tmath.qvel_fd(qpos[:-1], qpos[1:], dt), -10.0, 10.0)
    qvel = torch.cat([qvel[:1], qvel], dim=0)
    bangvel = tmath.angvel_fd(bquat[:-1], bquat[1:], dt)
    bangvel = torch.cat([bangvel[:1], bangvel], dim=0)

    clip = ExpertClip(
        qpos=qpos, qvel=qvel, wbpos=res.xpos.reshape(T, -1),
        wbquat=res.xquat.reshape(T, -1), bquat=bquat,
        ee_wpos=ee_world(res, ee_idx),
        ee_pos=ee_in_root(res, qpos, ee_idx, obs_coord),
        com=fklib.com(st, res), body_com=res.xipos.reshape(T, -1),
        head_pose=head_pose, rq_rmh=tmath.de_heading(qpos[:, 3:7]),
        rlinv=qvel[:, :3],
        rlinv_local=tmath.transform_vec(qvel[:, :3], qpos[:, 3:7], obs_coord),
        rangv=qvel[:, 3:6], bangvel=bangvel,
        length=torch.tensor(T, device=qpos.device),
        height_lb=qpos[:, 2].min(), head_height_lb=head_pose[:, 2].min(),
    )
    if pad_to is not None and pad_to > T:
        clip = ExpertClip(*(
            torch.cat([x, x[-1:].expand((pad_to - T,) + x.shape[1:])])
            if x.dim() > 0 else x for x in clip))
    return clip


def stack_bank(clips: list[ExpertClip]) -> ExpertClip:
    """Stack equally padded clips into a bank with a leading clip dim."""
    return ExpertClip(*(torch.stack(xs) for xs in zip(*clips)))


def index_clip(bank: ExpertClip, i: torch.Tensor) -> ExpertClip:
    """Select clip(s) i from a bank."""
    return ExpertClip(*(x[i] for x in bank))


def frame(clip: ExpertClip, t: torch.Tensor) -> ExpertClip:
    """Frame t of one clip, clamped to its true length - 1; scalar fields
    pass through."""
    idx = torch.minimum(torch.as_tensor(t), clip.length - 1)
    return ExpertClip(*(x[idx] if x.dim() > 0 else x for x in clip))


def bank_frame(bank: ExpertClip, clip_idx: torch.Tensor,
               t: torch.Tensor) -> ExpertClip:
    """bank[i, min(t, len_i - 1)] per env: clip_idx and t (...,)."""
    idx = torch.minimum(t, bank.length[clip_idx] - 1)
    return ExpertClip(*(x[clip_idx, idx] if x.dim() >= 2 else x[clip_idx]
                        for x in bank))
