"""Forward kinematics of the SMPL humanoid (port of
``kinpoly_tpu/physics/fk.py``): free root (``qpos[:3]`` position,
``qpos[3:7]`` wxyz quaternion), then three hinges per body about its local
z, y, x axes, composed intrinsically z-y-x. Batched over leading dims.

``fk`` and ``fk_frames`` choose their path from the input: a CUDA
``qpos`` that needs no gradient launches the kinematics kernel K5
(``csrc/fk.cu``, one launch per call, counted as ``fk_tree`` or
``fk_tree[frames]``) and must be float32; a CPU tensor, or one that
autograd has to differentiate (the retargeting fit, the AR losses), takes
the plain PyTorch code. The kernel takes trees of at most 32 bodies in
preorder (each parent before its children) and raises on others. It
repeats the plain code's float32 operations one for one, so on the card
both give the same bits (for a strided pose, those of its contiguous
copy).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from kinpoly_tpu_torch import native
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.utils.profiling import count, span, spanned

MAX_BODIES = 32              # one warp per env, one lane per body


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
    if _on_kernel(qpos):
        return _launch(st, qpos, frames=False)[0]
    return _fk_plain(st, qpos)


def fk_frames(st, qpos: torch.Tensor) -> tuple[FKResult, DofFrames]:
    """``fk`` and ``dof_frames`` of one pose: one ``fk_tree[frames]``
    launch on the kernel's path, else the two plain calls (and their two
    spans). One FK call in ``COUNTS["fk"]`` either way."""
    if not _on_kernel(qpos):
        res = fk(st, qpos)
        return res, dof_frames(st, qpos, res)
    with span("physics.fk"):
        count("fk")
        return _launch(st, qpos, frames=True)


def _fk_plain(st, qpos: torch.Tensor) -> FKResult:
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


def _on_kernel(qpos: torch.Tensor) -> bool:
    """A CUDA pose that autograd will not differentiate goes to K5."""
    return qpos.device.type == "cuda" and not (
        torch.is_grad_enabled() and qpos.requires_grad)


def tree_table(parents: tuple) -> tuple[np.ndarray, int]:
    """K5's table of a tree: int32 (2, B), each body's parent (the root's
    -1) then its depth (the root's 0), and the number of levels below the
    root, which the kernel walks in order. Raises for a tree the kernel
    cannot take: more than ``MAX_BODIES`` bodies, or a parent that does
    not come before its child."""
    B = len(parents)
    if not 1 <= B <= MAX_BODIES:
        raise ValueError(f"fk_tree: {B} bodies, the kernel takes 1 to "
                         f"{MAX_BODIES}")
    if parents[0] >= 0 or any(not 0 <= parents[i] < i for i in range(1, B)):
        raise ValueError("fk_tree: the kernel needs the bodies in preorder "
                         "(the root first, each parent before its children)")
    depth = [0] * B
    for i in range(1, B):
        depth[i] = depth[parents[i]] + 1
    return np.asarray([list(parents), depth], np.int32), max(depth)


@functools.cache
def _device_table(parents: tuple, device: torch.device):
    table, n_level = tree_table(parents)
    return torch.as_tensor(table, device=device), n_level


def _launch(st, qpos: torch.Tensor, frames: bool):
    """K5 on a CUDA float32 pose: (FKResult, DofFrames or None)."""
    if qpos.dtype != torch.float32:
        raise ValueError(f"fk_tree: expected float32, got {qpos.dtype}")
    B = len(st.parents)
    nq = 7 + 3 * (B - 1)
    if qpos.shape[-1:] != (nq,):
        raise ValueError(f"fk_tree: expected (..., {nq}) for {B} bodies, got "
                         f"{tuple(qpos.shape)}")
    for name in ("body_pos", "body_ipos"):
        x = getattr(st, name)
        if (x.device != qpos.device or x.dtype != torch.float32
                or tuple(x.shape) != (B, 3) or not x.is_contiguous()):
            raise ValueError(f"fk_tree: st.{name} must be a contiguous "
                             f"float32 ({B}, 3) on {qpos.device}")
    table, n_level = _device_table(st.parents, qpos.device)
    lead = qpos.shape[:-1]
    q = qpos.contiguous()
    n = q.numel() // nq
    new = lambda *tail: torch.empty(lead + tail, dtype=q.dtype, device=q.device)
    res = FKResult(xpos=new(B, 3), xquat=new(B, 4), xipos=new(B, 3))
    df = DofFrames(axis=new(nq - 1, 3), anchor=new(nq - 1, 3)) if frames else None
    if n == 0:
        return res, df
    rc = native.library().fk_tree(
        q.data_ptr(), table.data_ptr(), st.body_pos.data_ptr(),
        st.body_ipos.data_ptr(), res.xpos.data_ptr(), res.xquat.data_ptr(),
        res.xipos.data_ptr(), df.axis.data_ptr() if frames else None,
        df.anchor.data_ptr() if frames else None, n, B, n_level, int(frames),
        torch.cuda.current_stream(q.device).cuda_stream)
    native.check_launch("fk_tree[frames]" if frames else "fk_tree", rc)
    return res, df


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
