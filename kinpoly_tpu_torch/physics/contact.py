"""Soft floor contacts and joint limits, MuJoCo-style (port of
``kinpoly_tpu/physics/contact.py``, the parts the UHC env runs: no objects).

Candidate contact points are static body-frame vertices; the K deepest are
gathered into a fixed-size constraint block each substep. Forces solve a
MuJoCo-style soft-constraint problem (impedance from solimp, reference
acceleration from solref) by block projected Gauss-Seidel in contact space,
A = J M^-1 J^T + R. Defaults reproduce the reference scene: solref (0.02, 1),
solimp (0.9, 0.95, 0.001), pyramidal cone, condim 3.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kinpoly_tpu_torch.core import tmath

SOLREF = (0.02, 1.0)
SOLIMP = (0.9, 0.95, 0.001)

FOOT_BODIES = {"L_Ankle": 10, "R_Ankle": 10, "L_Toe": 10, "R_Toe": 10}


class ContactSet(NamedTuple):
    """Fixed-size batch of candidate contacts (already top-k selected)."""
    pos: torch.Tensor       # (..., K, 3) world contact position
    normal: torch.Tensor    # (..., K, 3) world normal, up out of the surface
    depth: torch.Tensor     # (..., K) penetration (> 0 penetrating), margin included
    body: torch.Tensor      # (..., K) humanoid body index (int64)
    friction: torch.Tensor  # (..., K)
    active: torch.Tensor    # (..., K) bool


class ContactPlan(NamedTuple):
    """Candidate indices chosen once per control step."""
    floor_idx: torch.Tensor   # (..., Pf) into the candidate verts
    lim_idx: torch.Tensor     # (..., Pl) into the 69 hinges


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last dim, descending, ties to the lower index
    (the order ``jax.lax.top_k`` gives)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_contact_vertices(spec, per_body: dict[str, int] | None = None,
                            default_k: int = 6) -> tuple[np.ndarray, np.ndarray]:
    """Host-side, once: extreme mesh vertices of each body along 14
    directions, farthest-point downsampled to k per body. Returns
    (verts (N, 3), body_id (N,))."""
    per_body = per_body or {}
    dirs = []
    for s in (1.0, -1.0):
        dirs += [np.array([s, 0, 0]), np.array([0, s, 0]), np.array([0, 0, s])]
    for sx in (1.0, -1.0):
        for sy in (1.0, -1.0):
            for sz in (1.0, -1.0):
                dirs.append(np.array([sx, sy, sz]) / np.sqrt(3))
    dirs = np.stack(dirs)

    verts_out, body_out = [], []
    for i, name in enumerate(spec.body_names):
        k = per_body.get(name, default_k)
        v = spec.mesh_verts[i]
        idx = np.unique(np.argmax(v @ dirs.T, axis=0))
        if len(idx) > k:
            chosen = [int(idx[np.argmin(v[idx, 2])])]
            rest = [j for j in idx if j != chosen[0]]
            while len(chosen) < k and rest:
                dmin = np.array([min(np.linalg.norm(v[j] - v[c]) for c in chosen)
                                 for j in rest])
                chosen.append(rest.pop(int(np.argmax(dmin))))
            idx = np.asarray(chosen)
        verts_out.append(v[idx])
        body_out.append(np.full(len(idx), i, dtype=np.int64))
    return np.concatenate(verts_out), np.concatenate(body_out)


def _floor_set(world, body, k_top, margin, friction) -> ContactSet:
    depth = margin - world[..., 2]
    val, sub = top_k(depth, k_top)
    pos = torch.gather(world, -2, sub[..., None].expand(sub.shape + (3,)))
    normal = torch.zeros_like(pos)
    normal[..., 2] = 1.0
    return ContactSet(pos=pos, normal=normal, depth=val,
                      body=torch.gather(body, -1, sub),
                      friction=torch.full_like(val, friction),
                      active=val > 0.0)


def floor_contacts(cand_verts: torch.Tensor, cand_body: torch.Tensor,
                   xpos: torch.Tensor, xquat: torch.Tensor, k_top: int,
                   margin: float = 0.001, friction: float = 1.0) -> ContactSet:
    """All candidate verts against the floor z = 0; the K deepest."""
    world = xpos[..., cand_body, :] + tmath.quat_rot_vec(
        xquat[..., cand_body, :], cand_verts)
    body = cand_body.expand(world.shape[:-1])
    return _floor_set(world, body, k_top, margin, friction)


def floor_contacts_planned(cand_verts: torch.Tensor, cand_body: torch.Tensor,
                           xpos: torch.Tensor, xquat: torch.Tensor,
                           plan_idx: torch.Tensor, k_top: int,
                           margin: float = 0.001,
                           friction: float = 1.0) -> ContactSet:
    """``floor_contacts`` over the planned candidates only."""
    verts = cand_verts[plan_idx]                            # (..., P, 3)
    body = cand_body[plan_idx]                              # (..., P)
    bq = torch.gather(xquat, -2, body[..., None].expand(body.shape + (4,)))
    bp = torch.gather(xpos, -2, body[..., None].expand(body.shape + (3,)))
    world = bp + tmath.quat_rot_vec(bq, verts)
    return _floor_set(world, body, k_top, margin, friction)


def _limit_rows(q, lo, hi, jidx_all, k_top, nv):
    depth_all = torch.maximum(lo - q, q - hi)
    sign = torch.where(lo - q > q - hi, 1.0, -1.0).to(q.dtype)
    val, sub = top_k(depth_all, k_top)
    sgn = torch.gather(sign, -1, sub)
    jidx = torch.gather(jidx_all, -1, sub)
    rows = torch.nn.functional.one_hot(jidx + 6, nv).to(q.dtype) * sgn[..., None]
    J = torch.zeros(rows.shape[:-2] + (k_top, 3, nv), dtype=q.dtype,
                    device=q.device)
    J[..., 0, :] = rows
    return J.reshape(rows.shape[:-2] + (3 * k_top, nv)), val, val > 0.0


def joint_limit_contacts(qpos: torch.Tensor, jnt_lo: torch.Tensor,
                         jnt_hi: torch.Tensor, k_top: int, nv: int = 75):
    """Joint limits as contact-like rows: (J (..., 3K, nv), depth (..., K),
    active (..., K)); only the first row of each block is live."""
    q = qpos[..., 7:]
    jidx = torch.arange(q.shape[-1], device=q.device).expand(q.shape)
    return _limit_rows(q, jnt_lo, jnt_hi, jidx, k_top, nv)


def joint_limit_contacts_planned(qpos: torch.Tensor, jnt_lo: torch.Tensor,
                                 jnt_hi: torch.Tensor, plan_idx: torch.Tensor,
                                 k_top: int, nv: int = 75):
    """``joint_limit_contacts`` over the planned hinges only."""
    q = torch.gather(qpos[..., 7:], -1, plan_idx)
    return _limit_rows(q, jnt_lo[plan_idx], jnt_hi[plan_idx], plan_idx,
                       k_top, nv)


def merge_contacts(a: ContactSet, b: ContactSet) -> ContactSet:
    return ContactSet(*(torch.cat([x, y], dim=-2 if x.dim() > a.depth.dim() else -1)
                        for x, y in zip(a, b)))


def contact_frame(normal: torch.Tensor) -> torch.Tensor:
    """(..., K, 3) normal -> (..., K, 3, 3) rows [n, t1, t2]."""
    n = normal
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.9, eye[2], eye[0])
    t1 = torch.linalg.cross(n, ref)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True), min=1e-9)
    t2 = torch.linalg.cross(n, t1)
    return torch.stack([n, t1, t2], dim=-2)


def contact_jacobian(cs: ContactSet, phi: torch.Tensor,
                     anc_dof_body: torch.Tensor) -> torch.Tensor:
    """Rows (normal, t1, t2) x K of the contact Jacobian J (..., 3K, nv):
    n . (phi_v0 + phi_omega x p) per dof, masked by dof ancestry."""
    mask = anc_dof_body.T[torch.clamp(cs.body, min=0)]      # (..., K, nv)
    mask = mask * (cs.body >= 0)[..., None]
    omega, v0 = phi[..., :3], phi[..., 3:]
    omega_b = omega[..., None, :, :]
    p_b = cs.pos[..., :, None, :]
    omega_b, p_b = torch.broadcast_tensors(omega_b, p_b)
    vel = v0[..., None, :, :] + torch.linalg.cross(omega_b, p_b)  # (..., K, nv, 3)
    frame = contact_frame(cs.normal)
    J = torch.einsum("...kvx,...kfx->...kfv", vel, frame) * mask[..., None, :]
    return J.reshape(J.shape[:-3] + (J.shape[-3] * 3, J.shape[-1]))


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) batched 3x3 inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-18,
                                torch.full_like(det, 1e-18), det)
    adj = torch.stack([
        A, -(b * i - c * h), b * f - c * e,
        B, a * i - c * g, -(a * f - c * d),
        C, -(a * h - b * g), a * e - b * d,
    ], dim=-1).reshape(m.shape)
    return adj * inv_det[..., None, None]


def impedance(depth: torch.Tensor, solimp=SOLIMP) -> torch.Tensor:
    """MuJoCo solimp impedance d(r): sigmoid from d0 to dmax over width."""
    d0, dmax, width = solimp
    x = torch.clamp(torch.abs(depth) / width, 0.0, 1.0)
    y = torch.where(x < 0.5, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) * (1.0 - x))
    return d0 + y * (dmax - d0)


def contact_system(J: torch.Tensor, MiJt: torch.Tensor,
                   qacc_smooth: torch.Tensor, qvel: torch.Tensor,
                   depth: torch.Tensor, active: torch.Tensor,
                   row_live: torch.Tensor | None = None,
                   solref=SOLREF, solimp=SOLIMP):
    """The PSOR problem of ``contact_forces``: returns (A (..., C, C),
    rhs (..., C), Dinv (..., K, 3, 3), R (..., C)) with C = 3K.

    ``row_live`` (C,) bool marks rows that carry a constraint (joint-limit
    blocks have dead friction rows)."""
    nK = depth.shape[-1]
    A = J @ MiJt
    d = impedance(depth, solimp) * active
    timeconst, dampratio = solref
    b_coef = 2.0 / (SOLIMP[1] * timeconst)
    k_coef = d / (SOLIMP[1] * SOLIMP[1] * timeconst * timeconst
                  * dampratio * dampratio)

    vel_c = torch.einsum("...cv,...v->...c", J, qvel)
    vel3 = vel_c.reshape(vel_c.shape[:-1] + (nK, 3))
    # reference acceleration: the normal row gets the position term, the
    # tangential rows are pure friction
    aref_n = -b_coef * vel3[..., 0] - k_coef * (-depth)
    aref_t = -b_coef * vel3[..., 1:] * 0.0
    aref = torch.cat([aref_n[..., None], aref_t], dim=-1).reshape(vel_c.shape)
    rhs = aref - torch.einsum("...cv,...v->...c", J, qacc_smooth)

    diagA = torch.diagonal(A, dim1=-2, dim2=-1)
    d_rows = torch.repeat_interleave(d, 3, dim=-1)
    R = (1.0 - d_rows) / torch.clamp(d_rows, min=1e-6) * torch.clamp(diagA, min=1e-8)
    R = torch.where(torch.repeat_interleave(active, 3, dim=-1), R,
                    torch.full_like(R, 1e8))
    if row_live is not None:
        R = torch.where(row_live, R, torch.full_like(R, 1e8))

    A3 = A.reshape(A.shape[:-2] + (nK, 3, nK, 3))
    D = torch.diagonal(A3, dim1=-4, dim2=-2).movedim(-1, -3)   # (..., K, 3, 3)
    eye3 = torch.eye(3, dtype=A.dtype, device=A.device)
    D = D + R.reshape(R.shape[:-1] + (nK, 3))[..., None] * eye3 + 1e-9 * eye3
    return A, rhs, _inv3x3(D), R


def psor_plain(A: torch.Tensor, rhs: torch.Tensor, Dinv: torch.Tensor,
               R: torch.Tensor, mu: torch.Tensor, active: torch.Tensor,
               iters: int) -> torch.Tensor:
    """Block projected Gauss-Seidel, ``iters`` sweeps over the K 3-row
    blocks in order; plain version of kernel K3. Tangent norm
    sqrt(t1^2 + t2^2 + 1e-24), the TPU kernel's form (the JAX lax path
    clips the norm at 1e-12 instead; the two agree to ~1e-24 / |t|^2)."""
    nK = mu.shape[-1]
    act = active.to(rhs.dtype)
    f = torch.zeros_like(rhs)
    for _ in range(iters):
        for k in range(nK):
            s = slice(3 * k, 3 * k + 3)
            fk = f[..., s]
            res = rhs[..., s] - torch.einsum("...ic,...c->...i", A[..., s, :], f) \
                - R[..., s] * fk
            g = fk + torch.einsum("...ij,...j->...i", Dinv[..., k, :, :], res)
            fn = torch.clamp(g[..., 0], min=0.0)
            tn = torch.sqrt(g[..., 1] ** 2 + g[..., 2] ** 2 + 1e-24)
            scale = torch.clamp(mu[..., k] * fn / tn, max=1.0)
            new = torch.stack([fn, g[..., 1] * scale, g[..., 2] * scale], dim=-1)
            f[..., s] = new * act[..., k, None]
    return f


def contact_forces(J, MiJt, qacc_smooth, qvel, depth, active, friction,
                   iters: int = 30, row_live=None) -> torch.Tensor:
    """Contact forces f (..., 3K) by plain PSOR; the constraint
    acceleration is MiJt @ f. The engine runs the same system through
    kernel K3 (``pgs_cuda.pgs_solve``)."""
    A, rhs, Dinv, R = contact_system(J, MiJt, qacc_smooth, qvel, depth,
                                     active, row_live)
    return psor_plain(A, rhs, Dinv, R, friction, active, iters)
