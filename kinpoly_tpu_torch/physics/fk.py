"""Forward kinematics of the SMPL humanoid (port of
``kinpoly_tpu/physics/fk.py``): free root (``qpos[:3]`` position,
``qpos[3:7]`` wxyz quaternion), then three hinges per body about its local
z, y, x axes, composed intrinsically z-y-x. Batched over leading dims.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.utils.profiling import count, spanned


class FKResult(NamedTuple):
    xpos: torch.Tensor    # (..., B, 3) body frame origins
    xquat: torch.Tensor   # (..., B, 4) body orientations
    xipos: torch.Tensor   # (..., B, 3) body CoM in world


class DofFrames(NamedTuple):
    axis: torch.Tensor    # (..., 75, 3) world axis per dof
    anchor: torch.Tensor  # (..., 75, 3) world anchor per dof


@spanned("physics.fk")
def fk(st, qpos: torch.Tensor) -> FKResult:
    """qpos (..., 76) -> world body frames; `st` is a SpecTensors. Each
    call adds 1 to ``COUNTS["fk"]``."""
    count("fk")
    B = len(st.parents)
    root_pos = qpos[..., 0:3]
    root_quat = tmath.quat_norm(qpos[..., 3:7])
    a = qpos[..., 7:].reshape(qpos.shape[:-1] + (B - 1, 3))
    local_q = tmath.quat_from_euler(a[..., 0], a[..., 1], a[..., 2], "rzyx")

    xpos = [root_pos]
    xquat = [root_quat]
    for i in range(1, B):
        p = st.parents[i]
        xquat.append(tmath.quat_mul(xquat[p], local_q[..., i - 1, :]))
        xpos.append(xpos[p] + tmath.quat_rot_vec(xquat[p], st.body_pos[i]))
    xpos = torch.stack(xpos, dim=-2)
    xquat = torch.stack(xquat, dim=-2)
    xipos = xpos + tmath.quat_rot_vec(xquat, st.body_ipos)
    return FKResult(xpos=xpos, xquat=xquat, xipos=xipos)


@spanned("physics.dof_frames")
def dof_frames(st, qpos: torch.Tensor, fk_res: FKResult) -> DofFrames:
    """Per-dof world axes and anchors, as MuJoCo's sequential hinges: the y
    hinge axis is turned by the z hinge, the x hinge by z then y."""
    B = len(st.parents)
    angles = qpos[..., 7:].reshape(qpos.shape[:-1] + (B - 1, 3))
    batch = qpos.shape[:-1]
    eye = torch.eye(3, dtype=qpos.dtype, device=qpos.device)
    ex, ey, ez = eye[0], eye[1], eye[2]

    # free joint: 3 world translational axes, 3 rotational axes of the root
    root_R = tmath.quat_to_mat(tmath.quat_norm(qpos[..., 3:7]))
    root_axes = torch.cat([eye.expand(batch + (3, 3)),
                           root_R.transpose(-1, -2)], dim=-2)
    root_anchor = qpos[..., None, 0:3].expand(batch + (6, 3))

    def about(angle, e):
        half = angle[..., None] * 0.5
        return torch.cat([torch.cos(half), torch.sin(half) * e], dim=-1)

    qz = about(angles[..., 0], ez)
    qzy = tmath.quat_mul(qz, about(angles[..., 1], ey))
    parent_q = fk_res.xquat[..., st.parent_idx, :]
    ax_z = tmath.quat_rot_vec(parent_q, ez)
    ax_y = tmath.quat_rot_vec(tmath.quat_mul(parent_q, qz), ey)
    ax_x = tmath.quat_rot_vec(tmath.quat_mul(parent_q, qzy), ex)
    hinge_axes = torch.stack([ax_z, ax_y, ax_x], dim=-2)
    hinge_axes = hinge_axes.reshape(batch + (3 * (B - 1), 3))
    hinge_anchor = torch.repeat_interleave(fk_res.xpos[..., 1:, :], 3, dim=-2)
    return DofFrames(axis=torch.cat([root_axes, hinge_axes], dim=-2),
                     anchor=torch.cat([root_anchor, hinge_anchor], dim=-2))


def body_quat_sim(qpos: torch.Tensor) -> torch.Tensor:
    """Root quat followed by per-body 'sxyz' quats of the (z, y, x) hinge
    angles, flat (..., 96)."""
    a = qpos[..., 7:].reshape(qpos.shape[:-1] + (-1, 3))
    q = tmath.quat_from_euler(a[..., 0], a[..., 1], a[..., 2], "sxyz")
    root = qpos[..., None, 3:7]
    return torch.cat([root, q], dim=-2).reshape(qpos.shape[:-1] + (-1,))


def com(st, fk_res: FKResult) -> torch.Tensor:
    """Mass-weighted whole-body CoM."""
    return torch.sum(fk_res.xipos * st.mass_frac[:, None], dim=-2)


def make_body_index(spec, names: list[str]) -> np.ndarray:
    return np.asarray([spec.body_index(n) for n in names], dtype=np.int64)
