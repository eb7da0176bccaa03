"""Quaternion / rotation / heading math (as ``kinpoly_tpu/core/tmath.py``,
the functions the UHC evaluation path calls).

Batched over arbitrary leading dims and dtype-preserving. Conventions as in
the JAX package: quaternions are (w, x, y, z), ``quat_mul(a, b)`` applies b
first, the heading of a root quaternion zeroes its x/y parts, Euler
sequences follow the transformations.py encoding (all 24 of them, both
ways: ``quat_from_euler``, ``euler_from_mat``, ``euler_from_quat``). The
SMPL conversion also reads ``rotation_from_quat_shortest``; the BVH reader
``quat_about_axis``; the 6D rotation representation (``rot6d_*``) is Zhou
et al.'s, as the reference's ``transform_utils.py``.
"""

from __future__ import annotations

import math

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 norm floored at eps (before the sqrt, as the JAX package does)."""
    n2 = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(n2, min=eps * eps))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate over squared norm (no unit assumption)."""
    return quat_conj(q) / torch.sum(q * q, dim=-1, keepdim=True)


def quat_norm(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / safe_norm(q, eps=eps)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    n = torch.sum(q * q, dim=-1)
    s = torch.where(n > 1e-12, 2.0 / torch.clamp(n, min=1e-12),
                    torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    one = torch.ones_like(xx)
    m = torch.stack([
        one - (yy + zz), xy - wz, xz + wy,
        xy + wz, one - (xx + zz), yz - wx,
        xz - wy, yz + wx, one - (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> unit quaternion with w >= 0.

    All four branches of the stable construction are evaluated and one is
    selected: w where the trace is positive, else the largest diagonal
    entry's (x on ties with y or z, y on ties with z), as the JAX package
    selects, so that ties and gradients agree."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def build(w2, a, b, c, slot):
        # w2 = 4 q[slot]^2; (a, b, c) fill the other slots in order
        s = torch.sqrt(torch.clamp(w2, min=1e-18))
        comps = [a / (2.0 * s), b / (2.0 * s), c / (2.0 * s)]
        comps.insert(slot, 0.5 * s)
        return torch.stack(comps, dim=-1)

    q_w = build(1.0 + tr, m21 - m12, m02 - m20, m10 - m01, 0)
    q_x = build(1.0 + m00 - m11 - m22, m21 - m12, m01 + m10, m02 + m20, 1)
    q_y = build(1.0 + m11 - m00 - m22, m02 - m20, m01 + m10, m12 + m21, 2)
    q_z = build(1.0 + m22 - m00 - m11, m10 - m01, m02 + m20, m12 + m21, 3)
    cond_w = (tr > 0.0)[..., None]
    cond_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond_y = (m11 >= m22)[..., None]
    q = torch.where(cond_w, q_w,
                    torch.where(cond_x, q_x, torch.where(cond_y, q_y, q_z)))
    return torch.where(q[..., :1] < 0, -q, q)


def quat_rot_vec(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v for (..., 4) q and (..., 3) v (broadcasting)."""
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_rot_vec_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rot_vec(quat_conj(q), v)


def quat_about_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Rotation by `angle` (...,) about a (not necessarily unit) axis
    (..., 3)."""
    axis = axis / safe_norm(axis)
    half = angle[..., None] * 0.5
    v = torch.sin(half) * axis
    return torch.cat([torch.cos(half).expand(v.shape[:-1] + (1,)), v], dim=-1)


def quat_from_expmap(e: torch.Tensor) -> torch.Tensor:
    """Axis*angle 3-vector -> quaternion, finite at 0."""
    angle = safe_norm(e)
    half = 0.5 * angle
    k = torch.where(angle < 1e-9, 0.5 * torch.ones_like(angle),
                    torch.sin(half) / torch.clamp(angle, min=1e-9))
    return torch.cat([torch.cos(half), e * k], dim=-1)


def rotation_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> axis*angle, angle = 2*atan2(|xyz|, w) in [0, 2pi);
    near-identity quaternions give the zero vector."""
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    s = safe_norm(q[..., 1:], eps=1e-9)
    angle = 2.0 * torch.atan2(s, w)
    small = (1.0 - torch.abs(w)) < 1e-8
    unit_x = torch.zeros_like(q[..., 1:])
    unit_x[..., 0] = 1.0
    axis = torch.where(small, unit_x, q[..., 1:] / s)
    return torch.where(small, torch.zeros_like(axis), axis * angle)


def rotation_from_quat_shortest(q: torch.Tensor) -> torch.Tensor:
    """Axis*angle with the angle wrapped to (-pi, pi] (the shortest
    rotation); near-identity quaternions give the zero vector."""
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    s = safe_norm(q[..., 1:], eps=1e-9)
    angle = 2.0 * torch.atan2(s, w)
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    small = (1.0 - torch.abs(w)) < 1e-8
    axis = torch.where(small, torch.zeros_like(q[..., 1:]), q[..., 1:] / s)
    return axis * angle


def heading_q(q: torch.Tensor) -> torch.Tensor:
    """Zero the x/y parts and renormalise; identity where undefined."""
    zero = torch.zeros_like(q[..., 0])
    hq = torch.stack([q[..., 0], zero, zero, q[..., 3]], dim=-1)
    n2 = torch.sum(hq * hq, dim=-1, keepdim=True)
    iden = torch.zeros_like(hq)
    iden[..., 0] = 1.0
    hq = torch.where(n2 > 1e-12, hq, iden)
    return hq / safe_norm(hq, eps=1e-6)


def heading(q: torch.Tensor) -> torch.Tensor:
    """Yaw of the sign-canonicalised heading quaternion, 2*atan2(z, w)."""
    w, z = q[..., 0], q[..., 3]
    sgn = torch.where(z < 0, -1.0, 1.0).to(q.dtype)
    w, z = sgn * w, sgn * z
    deg = (w * w + z * z) <= 1e-12
    w = torch.where(deg, torch.ones_like(w), w)
    z = torch.where(deg, torch.zeros_like(z), z)
    return 2.0 * torch.atan2(z, w)


def de_heading(q: torch.Tensor) -> torch.Tensor:
    return quat_mul(quat_conj(heading_q(q)), q)


def transform_vec(v: torch.Tensor, q: torch.Tensor,
                  trans: str = "root") -> torch.Tensor:
    """World vector v in the root ('root') or heading ('heading') frame."""
    if trans == "root":
        return quat_rot_vec_inv(quat_norm(q), v)
    if trans == "heading":
        return quat_rot_vec_inv(heading_q(q), v)
    raise ValueError(f"unknown transform {trans!r}")


def wrap_to_pi(x: torch.Tensor) -> torch.Tensor:
    return x - 2.0 * math.pi * torch.floor((x + math.pi) / (2.0 * math.pi))


# Euler sequences in the transformations.py encoding:
# (firstaxis, parity, repetition, frame)
_AXES2TUPLE = {
    "sxyz": (0, 0, 0, 0), "sxyx": (0, 0, 1, 0), "sxzy": (0, 1, 0, 0),
    "sxzx": (0, 1, 1, 0), "syzx": (1, 0, 0, 0), "syzy": (1, 0, 1, 0),
    "syxz": (1, 1, 0, 0), "syxy": (1, 1, 1, 0), "szxy": (2, 0, 0, 0),
    "szxz": (2, 0, 1, 0), "szyx": (2, 1, 0, 0), "szyz": (2, 1, 1, 0),
    "rzyx": (0, 0, 0, 1), "rxyx": (0, 0, 1, 1), "ryzx": (0, 1, 0, 1),
    "rxzx": (0, 1, 1, 1), "rxzy": (1, 0, 0, 1), "ryzy": (1, 0, 1, 1),
    "rzxy": (1, 1, 0, 1), "ryxy": (1, 1, 1, 1), "ryxz": (2, 0, 0, 1),
    "rzxz": (2, 0, 1, 1), "rxyz": (2, 1, 0, 1), "rzyz": (2, 1, 1, 1),
}
_NEXT_AXIS = [1, 2, 0, 1]


def quat_from_euler(ai: torch.Tensor, aj: torch.Tensor, ak: torch.Tensor,
                    axes: str = "sxyz") -> torch.Tensor:
    """Euler angles -> quaternion (the transformations.py algorithm), for
    every sequence of ``_AXES2TUPLE``."""
    firstaxis, parity, repetition, frame = _AXES2TUPLE[axes.lower()]
    i = firstaxis + 1
    j = _NEXT_AXIS[i + parity - 1] + 1
    k = _NEXT_AXIS[i - parity] + 1
    if frame:
        ai, ak = ak, ai
    if parity:
        aj = -aj
    ai, aj, ak = ai * 0.5, aj * 0.5, ak * 0.5
    ci, si = torch.cos(ai), torch.sin(ai)
    cj, sj = torch.cos(aj), torch.sin(aj)
    ck, sk = torch.cos(ak), torch.sin(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    out = [None] * 4
    if repetition:
        out[0] = cj * (cc - ss)
        out[i] = cj * (cs + sc)
        out[j] = sj * (cc + ss)
        out[k] = sj * (cs - sc)
    else:
        out[0] = cj * cc + sj * ss
        out[i] = cj * sc - sj * cs
        out[j] = cj * ss + sj * cc
        out[k] = cj * cs - sj * sc
    if parity:
        out[j] = -out[j]
    return torch.stack(out, dim=-1)


def euler_from_mat(m: torch.Tensor, axes: str = "sxyz") -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> Euler angles (..., 3) of the same
    sequence encoding; at gimbal lock (cos or sin of the middle angle under
    1e-8) the last angle is 0, both branches evaluated and selected by
    ``torch.where`` as the JAX package does."""
    firstaxis, parity, repetition, frame = _AXES2TUPLE[axes.lower()]
    i = firstaxis
    j = _NEXT_AXIS[i + parity]
    k = _NEXT_AXIS[i - parity + 1]
    eps = 1e-8
    if repetition:
        sy = torch.sqrt(m[..., i, j] ** 2 + m[..., i, k] ** 2)
        ok = sy > eps
        ax = torch.where(ok, torch.atan2(m[..., i, j], m[..., i, k]),
                         torch.atan2(-m[..., j, k], m[..., j, j]))
        ay = torch.atan2(sy, m[..., i, i])
        az = torch.where(ok, torch.atan2(m[..., j, i], -m[..., k, i]),
                         torch.zeros_like(ax))
    else:
        cy = torch.sqrt(m[..., i, i] ** 2 + m[..., j, i] ** 2)
        ok = cy > eps
        ax = torch.where(ok, torch.atan2(m[..., k, j], m[..., k, k]),
                         torch.atan2(-m[..., j, k], m[..., j, j]))
        ay = torch.atan2(-m[..., k, i], cy)
        az = torch.where(ok, torch.atan2(m[..., j, i], m[..., i, i]),
                         torch.zeros_like(ax))
    if parity:
        ax, ay, az = -ax, -ay, -az
    if frame:
        ax, az = az, ax
    return torch.stack([ax, ay, az], dim=-1)


def euler_from_quat(q: torch.Tensor, axes: str = "sxyz") -> torch.Tensor:
    return euler_from_mat(quat_to_mat(q), axes)


def multi_quat_diff(nq1: torch.Tensor, nq0: torch.Tensor) -> torch.Tensor:
    """q1 * q0^-1 of N stacked joints, flat (..., 4N)."""
    shape = nq1.shape
    q1 = nq1.reshape(shape[:-1] + (-1, 4))
    q0 = nq0.reshape(shape[:-1] + (-1, 4))
    return quat_mul(q1, quat_inv(q0)).reshape(shape)


def multi_quat_norm(nq: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude atan2(|xyz|, |w|) per joint, (..., 4N) -> (..., N)."""
    q = nq.reshape(nq.shape[:-1] + (-1, 4))
    s = safe_norm(q[..., 1:], keepdim=False, eps=1e-12)
    return torch.atan2(s, torch.abs(q[..., 0]))


def qvel_fd(cur_qpos: torch.Tensor, next_qpos: torch.Tensor,
            dt: float) -> torch.Tensor:
    """Finite-difference generalized velocity between two qpos frames:
    world linear velocity, root-frame angular velocity, wrapped hinge
    rates."""
    v = (next_qpos[..., :3] - cur_qpos[..., :3]) / dt
    qrel = quat_mul(next_qpos[..., 3:7], quat_inv(cur_qpos[..., 3:7]))
    axis_angle = rotation_from_quat(qrel)
    angle = safe_norm(axis_angle)
    wrapped = wrap_to_pi(angle)
    rv = torch.where(angle > 1e-12,
                     axis_angle * (wrapped / torch.clamp(angle, min=1e-12)),
                     axis_angle) / dt
    rv = transform_vec(rv, cur_qpos[..., 3:7], "root")
    diff = wrap_to_pi(next_qpos[..., 7:] - cur_qpos[..., 7:])
    return torch.cat([v, rv, diff / dt], dim=-1)


def angvel_fd(prev_bquat: torch.Tensor, cur_bquat: torch.Tensor,
              dt: float) -> torch.Tensor:
    """Per-joint finite-difference angular velocity, (..., 4N) -> (..., 3N)."""
    qd = multi_quat_diff(cur_bquat, prev_bquat)
    q = qd.reshape(qd.shape[:-1] + (-1, 4))
    aa = rotation_from_quat(q) / dt
    return aa.reshape(qd.shape[:-1] + (-1,))


def rot6d_to_mat(x: torch.Tensor) -> torch.Tensor:
    """Ortho-6D (..., 6) = (a1, a2) -> rotation matrix by Gram-Schmidt; the
    matrix's columns are (b1, b2, b3). The norms are floored at 1e-8, so
    the gradient stays finite at a1 = 0 and at a2 parallel to a1."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / safe_norm(a1, eps=1e-8)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / safe_norm(b2, eps=1e-8)
    b3 = torch.linalg.cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-1)


def mat_to_rot6d(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> 6D: its first two columns, concatenated."""
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def quat_to_rot6d(q: torch.Tensor) -> torch.Tensor:
    return mat_to_rot6d(quat_to_mat(q))


def rot6d_to_quat(x: torch.Tensor) -> torch.Tensor:
    return mat_to_quat(rot6d_to_mat(x))


def normalize_angle_diff(base: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Shift base by multiples of 2pi so that base - ref is in (-pi, pi]."""
    return ref + wrap_to_pi(base - ref)
