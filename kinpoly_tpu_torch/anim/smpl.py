"""SMPL pose <-> humanoid qpos conversion on tensors (port of
``kinpoly_tpu/anim/smpl.py``).

72-d SMPL axis-angle (24 joints, canonical SMPL kintree order) and a root
translation become a 76-d qpos (translation, root wxyz quaternion, 69
intrinsic-ZYX Euler angles in the humanoid's depth-first body order), and
back. Batched over leading dims; device and dtype are the input's.
"""

from __future__ import annotations

import numpy as np
import torch

from kinpoly_tpu_torch.core import tmath

# canonical SMPL joint order
SMPL_JOINT_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck",
    "L_Thorax", "R_Thorax", "Head", "L_Shoulder", "R_Shoulder",
    "L_Elbow", "R_Elbow", "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
]

DEFAULT_ROOT_Z = 0.91437225  # standing root height


def smpl_to_mujoco_index(spec) -> np.ndarray:
    """Index map m: mujoco_joints[i] = smpl_joints[m[i]]."""
    return np.asarray([SMPL_JOINT_NAMES.index(n) for n in spec.body_names], np.int32)


def smpl_to_qpose(spec, pose_aa: torch.Tensor,
                  trans: torch.Tensor | None = None) -> torch.Tensor:
    """pose_aa (..., 72) SMPL axis-angle + trans (..., 3) -> qpos (..., 76);
    without trans the root stands at DEFAULT_ROOT_Z over the origin."""
    batch = pose_aa.shape[:-1]
    if trans is None:
        trans = torch.zeros(batch + (3,), dtype=pose_aa.dtype,
                            device=pose_aa.device)
        trans[..., 2] = DEFAULT_ROOT_Z

    aa = pose_aa.reshape(batch + (24, 3))
    quat = tmath.quat_from_expmap(aa)
    # intrinsic ZYX Euler angles per joint
    euler = tmath.euler_from_quat(quat, "rzyx")
    m = torch.as_tensor(smpl_to_mujoco_index(spec), dtype=torch.int64,
                        device=pose_aa.device)
    euler_mj = euler[..., m, :]
    root_quat = quat[..., m[0], :]
    body = euler_mj[..., 1:, :].reshape(batch + (69,))
    return torch.cat([trans, root_quat, body], dim=-1)


def qpose_to_smpl(spec, qpos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """qpos (..., 76) -> (pose_aa (..., 72), trans (..., 3))."""
    batch = qpos.shape[:-1]
    trans = qpos[..., :3]
    euler_mj = qpos[..., 7:].reshape(batch + (23, 3))
    quat_mj = tmath.quat_from_euler(
        euler_mj[..., 0], euler_mj[..., 1], euler_mj[..., 2], "rzyx")
    quat_mj = torch.cat([qpos[..., None, 3:7], quat_mj], dim=-2)  # (..., 24, 4)
    m = smpl_to_mujoco_index(spec)
    inv = np.zeros_like(m)
    inv[m] = np.arange(len(m))
    quat_smpl = quat_mj[..., torch.as_tensor(inv, dtype=torch.int64,
                                             device=qpos.device), :]
    aa = tmath.rotation_from_quat_shortest(quat_smpl)
    return aa.reshape(batch + (72,)), trans
