"""Soft contacts and joint limits, MuJoCo-style (as ``kinpoly_tpu/physics/contact.py``): the floor, joint limits and the scene
objects (box and cylinder geoms by signed distance, object corners against
the floor, the object side of the contact Jacobian).

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

from refimpl.core import tmath

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
    obj: torch.Tensor = None  # (..., K) int64 scene object on the other side
    #                           (-1: the floor); ``body`` is -1 where no
    #                           humanoid body takes part (object-floor)


class ContactPlan(NamedTuple):
    """Candidate indices chosen once per control step."""
    floor_idx: torch.Tensor   # (..., Pf) into the candidate verts
    lim_idx: torch.Tensor     # (..., Pl) into the 69 hinges
    obj_idx: torch.Tensor = None  # (..., Po) into the flat (geom, vert) pairs
    of_idx: torch.Tensor = None   # (..., Pof) into the object floor verts


class SceneGeoms(NamedTuple):
    """The objects' box and cylinder geoms, stacked (host side)."""
    gtype: np.ndarray    # (G,) 0 box, 1 cylinder
    size: np.ndarray     # (G, 3)
    pos: np.ndarray      # (G, 3) geom offset in the object frame
    quat: np.ndarray     # (G, 4)
    obj: np.ndarray      # (G,) object index


class SceneTensors(NamedTuple):
    """A SceneGeoms as tensors of one dtype on one device."""
    gtype: torch.Tensor  # (G,) int64
    size: torch.Tensor
    pos: torch.Tensor
    quat: torch.Tensor
    obj: torch.Tensor    # (G,) int64


def scene_from_spec(spec) -> SceneGeoms:
    gtypes, sizes, poss, quats, objs = [], [], [], [], []
    for oi, obj in enumerate(spec.objects):
        for g in obj.geoms:
            if g.gtype not in ("box", "cylinder"):
                continue
            gtypes.append(0 if g.gtype == "box" else 1)
            sz = np.zeros(3)
            sz[:len(g.size)] = g.size
            sizes.append(sz)
            poss.append(g.pos)
            quats.append(g.quat)
            objs.append(oi)
    return SceneGeoms(np.asarray(gtypes, np.int64), np.stack(sizes),
                      np.stack(poss), np.stack(quats),
                      np.asarray(objs, np.int64))


def scene_tensors(scene: SceneGeoms, dtype, device) -> SceneTensors:
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return SceneTensors(
        gtype=torch.as_tensor(scene.gtype, device=device), size=t(scene.size),
        pos=t(scene.pos), quat=t(scene.quat),
        obj=torch.as_tensor(scene.obj, device=device))


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


def _sdf_box(p: torch.Tensor, half: torch.Tensor):
    """Signed distance and outward normal of points against a box centred
    at the origin: outside, along the clamped offset; inside, along the
    axis of least penetration."""
    q = torch.abs(p) - half
    outside = torch.clamp(q, min=0.0)
    d_out = torch.linalg.norm(outside, dim=-1)
    d_in = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    n_out = outside * torch.sign(p)
    n_out = n_out / torch.clamp(torch.linalg.norm(n_out, dim=-1, keepdim=True),
                                min=1e-9)
    ax = torch.argmax(q, dim=-1, keepdim=True)
    n_in = torch.zeros_like(p).scatter_(-1, ax, 1.0) * torch.sign(
        torch.gather(p, -1, ax))
    return d_out + d_in, torch.where((d_out > 0)[..., None], n_out, n_in)


def _sdf_cylinder(p: torch.Tensor, size: torch.Tensor):
    """Points against a z-aligned cylinder (radius size[0], half-height
    size[1])."""
    r, h = size[..., 0], size[..., 1]
    pr = torch.linalg.norm(p[..., :2], dim=-1)
    dr = pr - r
    dz = torch.abs(p[..., 2]) - h
    out_r = torch.clamp(dr, min=0.0)
    out_z = torch.clamp(dz, min=0.0)
    d_out = torch.sqrt(out_r ** 2 + out_z ** 2)
    d_in = torch.clamp(torch.maximum(dr, dz), max=0.0)
    nr = p[..., :2] / torch.clamp(pr[..., None], min=1e-9)
    n_side = torch.cat([nr, torch.zeros_like(p[..., 2:3])], dim=-1)
    n_cap = torch.cat([torch.zeros_like(p[..., :2]), torch.sign(p[..., 2:3])],
                      dim=-1)
    use_side = torch.where(d_out > 0, out_r >= out_z, dr >= dz)
    return d_out + d_in, torch.where(use_side[..., None], n_side, n_cap)


def _geom_sdf(local, size, is_box):
    d_box, n_box = _sdf_box(local, size)
    d_cyl, n_cyl = _sdf_cylinder(local, size)
    return (torch.where(is_box, d_box, d_cyl),
            torch.where(is_box[..., None], n_box, n_cyl))


def object_point_distances(scene: SceneTensors, obj_qpos: torch.Tensor,
                           points: torch.Tensor):
    """Signed distance (and world normal) of world points (..., P, 3) to
    every geom of the objects posed at obj_qpos (..., n_obj, 7): (dist
    (..., G, P), normal (..., G, P, 3))."""
    op = obj_qpos[..., scene.obj, :3]                   # (..., G, 3)
    oq = obj_qpos[..., scene.obj, 3:7]
    wq = tmath.quat_mul(oq, scene.quat)
    wp = op + tmath.quat_rot_vec(oq, scene.pos)
    rel = points[..., None, :, :] - wp[..., :, None, :]
    local = tmath.quat_rot_vec_inv(wq[..., :, None, :], rel)
    is_box = (scene.gtype == 0)[:, None]
    dist, n_local = _geom_sdf(local, scene.size[:, None, :], is_box)
    return dist, tmath.quat_rot_vec(wq[..., :, None, :], n_local)


def object_contacts(scene: SceneTensors, obj_qpos: torch.Tensor,
                    cand_world: torch.Tensor, cand_body: torch.Tensor,
                    k_top: int, margin: float = 0.001,
                    friction: float = 1.0) -> ContactSet:
    """World candidate verts (..., V, 3) against the object geoms; the K
    deepest (geom, vert) pairs."""
    dist, normal = object_point_distances(scene, obj_qpos, cand_world)
    depth = (margin - dist).flatten(-2)                 # (..., G * V)
    val, idx = top_k(depth, k_top)
    G, V = dist.shape[-2], dist.shape[-1]
    pos = torch.gather(cand_world, -2, (idx % V)[..., None].expand(
        idx.shape + (3,)))
    nrm = torch.gather(normal.flatten(-3, -2), -2,
                       idx[..., None].expand(idx.shape + (3,)))
    return ContactSet(pos=pos, normal=nrm, depth=val, body=cand_body[idx % V],
                      friction=torch.full_like(val, friction),
                      active=val > 0.0, obj=scene.obj[idx // V])


def object_contacts_planned(scene: SceneTensors, obj_qpos: torch.Tensor,
                            cand_verts: torch.Tensor, cand_body: torch.Tensor,
                            xpos: torch.Tensor, xquat: torch.Tensor,
                            plan_idx: torch.Tensor, k_top: int,
                            margin: float = 0.001,
                            friction: float = 1.0) -> ContactSet:
    """``object_contacts`` over the planned (geom, vert) pairs only."""
    V = cand_verts.shape[0]
    g, v = plan_idx // V, plan_idx % V
    body = cand_body[v]
    bq = torch.gather(xquat, -2, body[..., None].expand(body.shape + (4,)))
    bp = torch.gather(xpos, -2, body[..., None].expand(body.shape + (3,)))
    world = bp + tmath.quat_rot_vec(bq, cand_verts[v])      # (..., P, 3)
    g_obj = scene.obj[g]
    op = torch.gather(obj_qpos, -2, g_obj[..., None].expand(g_obj.shape + (7,)))
    oq = op[..., 3:7]
    wq = tmath.quat_mul(oq, scene.quat[g])
    wp = op[..., :3] + tmath.quat_rot_vec(oq, scene.pos[g])
    local = tmath.quat_rot_vec_inv(wq, world - wp)
    dist, n_local = _geom_sdf(local, scene.size[g], scene.gtype[g] == 0)
    normal = tmath.quat_rot_vec(wq, n_local)
    val, sub = top_k(margin - dist, k_top)
    s3 = sub[..., None].expand(sub.shape + (3,))
    return ContactSet(pos=torch.gather(world, -2, s3),
                      normal=torch.gather(normal, -2, s3), depth=val,
                      body=torch.gather(body, -1, sub),
                      friction=torch.full_like(val, friction),
                      active=val > 0.0, obj=torch.gather(g_obj, -1, sub))


def _object_floor_set(world, vert_obj, k_top, margin, friction) -> ContactSet:
    """The K deepest object verts against the floor. The stored normal
    points down: rows measure (floor - object) velocity, so the object
    side's force -n f pushes the object up out of the floor."""
    val, sub = top_k(margin - world[..., 2], k_top)
    pos = torch.gather(world, -2, sub[..., None].expand(sub.shape + (3,)))
    normal = torch.zeros_like(pos)
    normal[..., 2] = -1.0
    return ContactSet(pos=pos, normal=normal, depth=val,
                      body=torch.full_like(sub, -1),
                      friction=torch.full_like(val, friction),
                      active=val > 0.0, obj=torch.gather(vert_obj, -1, sub))


def object_floor_contacts(obj_qpos: torch.Tensor, verts: torch.Tensor,
                          vert_obj: torch.Tensor, k_top: int,
                          margin: float = 0.001,
                          friction: float = 1.0) -> ContactSet:
    """Object candidate verts (V, 3), object frame, against the floor."""
    op = obj_qpos[..., vert_obj, :]
    world = op[..., :3] + tmath.quat_rot_vec(op[..., 3:7], verts)
    return _object_floor_set(world, vert_obj.expand(world.shape[:-1]), k_top,
                             margin, friction)


def object_floor_contacts_planned(obj_qpos: torch.Tensor, verts: torch.Tensor,
                                  vert_obj: torch.Tensor, plan_idx: torch.Tensor,
                                  k_top: int, margin: float = 0.001,
                                  friction: float = 1.0) -> ContactSet:
    """``object_floor_contacts`` over the planned verts only."""
    vo = vert_obj[plan_idx]                                  # (..., P)
    op = torch.gather(obj_qpos, -2, vo[..., None].expand(vo.shape + (7,)))
    world = op[..., :3] + tmath.quat_rot_vec(op[..., 3:7], verts[plan_idx])
    return _object_floor_set(world, vo, k_top, margin, friction)


def object_floor_verts(scene: SceneGeoms) -> tuple[np.ndarray, np.ndarray]:
    """Object-frame floor-contact candidates (host side): a box's 8
    corners, a cylinder's 4 bottom and 4 top rim points. Returns (verts
    (V, 3), object index (V,))."""
    verts, objs = [], []
    for gi in range(len(scene.gtype)):
        s = scene.size[gi]
        if scene.gtype[gi] == 0:
            local = np.array([[sx * s[0], sy * s[1], sz * s[2]]
                              for sx in (-1, 1) for sy in (-1, 1)
                              for sz in (-1, 1)])
        else:
            local = np.array([[s[0] * np.cos(a), s[0] * np.sin(a), sz * s[1]]
                              for sz in (-1, 1)
                              for a in np.arange(4) * (np.pi / 2)])
        w, x, y, z = scene.quat[gi]
        Rm = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        verts.append(local @ Rm.T + scene.pos[gi])
        objs.append(np.full(len(local), scene.obj[gi], np.int64))
    return np.concatenate(verts), np.concatenate(objs)


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
    """Concatenate two contact sets (a missing ``obj`` is the floor, -1)."""
    def obj(c):
        return c.obj if c.obj is not None else torch.full_like(c.body, -1)
    return ContactSet(
        pos=torch.cat([a.pos, b.pos], dim=-2),
        normal=torch.cat([a.normal, b.normal], dim=-2),
        **{f: torch.cat([getattr(a, f), getattr(b, f)], dim=-1)
           for f in ("depth", "body", "friction", "active")},
        obj=torch.cat([obj(a), obj(b)], dim=-1))


def contact_frame(normal: torch.Tensor) -> torch.Tensor:
    """(..., K, 3) normal -> (..., K, 3, 3) rows [n, t1, t2]."""
    n = normal
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.9, eye[2], eye[0])
    t1 = torch.linalg.cross(n, ref)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True), min=1e-9)
    t2 = torch.linalg.cross(n, t1)
    return torch.stack([n, t1, t2], dim=-2)


def object_jacobian(cs: ContactSet, com_world: torch.Tensor):
    """The object side of the contact rows: (J_o (..., 3K, 6), object of
    each row (..., 3K), -1 for none). J_o maps the contact object's
    generalized velocity (v_com, omega), both world, to minus the velocity
    of its contact point along [n, t1, t2] (rows measure humanoid point
    minus object point). `com_world` (..., n_obj, 3)."""
    frame = contact_frame(cs.normal)                     # (..., K, 3, 3)
    oi = torch.clamp(cs.obj, min=0)
    com = torch.gather(com_world, -2, oi[..., None].expand(oi.shape + (3,)))
    r = (cs.pos - com)[..., None, :].expand(frame.shape)
    Jo = torch.cat([-frame, -torch.linalg.cross(r, frame)], dim=-1)
    Jo = Jo * (cs.obj >= 0)[..., None, None]
    return (Jo.reshape(Jo.shape[:-3] + (-1, 6)),
            torch.repeat_interleave(cs.obj, 3, dim=-1))


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
                   solref=SOLREF, solimp=SOLIMP,
                   A_extra: torch.Tensor | None = None,
                   vel_extra: torch.Tensor | None = None,
                   acc_smooth_extra: torch.Tensor | None = None):
    """The PSOR problem of ``contact_forces``: returns (A (..., C, C),
    rhs (..., C), Dinv (..., K, 3, 3), R (..., C)) with C = 3K.

    ``row_live`` ((C,) or per env (..., C), bool) marks rows that carry a
    constraint (joint-limit blocks have dead friction rows). Movable
    objects add their side through ``A_extra`` (the object Delassus block
    J_o M_o^-1 J_o^T), ``vel_extra`` and ``acc_smooth_extra`` (the object
    points' velocity and unconstrained acceleration along each row). J and
    MiJt may carry fewer rows than C (split object-floor rows): the
    trailing rows have no humanoid side and live only through the extra
    terms; the caller applies MiJt @ f[..., :rows]."""
    nK = depth.shape[-1]
    n_of = 3 * nK - J.shape[-2]

    def pad_rows(x):
        return torch.nn.functional.pad(x, (0, n_of)) if n_of else x

    A = J @ MiJt
    if n_of:
        A = torch.nn.functional.pad(A, (0, n_of, 0, n_of))
    if A_extra is not None:
        A = A + A_extra
    d = impedance(depth, solimp) * active
    timeconst, dampratio = solref
    b_coef = 2.0 / (SOLIMP[1] * timeconst)
    k_coef = d / (SOLIMP[1] * SOLIMP[1] * timeconst * timeconst
                  * dampratio * dampratio)

    vel_c = pad_rows(torch.einsum("...cv,...v->...c", J, qvel))
    if vel_extra is not None:
        vel_c = vel_c + vel_extra
    vel3 = vel_c.reshape(vel_c.shape[:-1] + (nK, 3))
    # reference acceleration: the normal row gets the position term, the
    # tangential rows are pure friction
    aref_n = -b_coef * vel3[..., 0] - k_coef * (-depth)
    aref_t = -b_coef * vel3[..., 1:] * 0.0
    aref = torch.cat([aref_n[..., None], aref_t], dim=-1).reshape(vel_c.shape)
    rhs = aref - pad_rows(torch.einsum("...cv,...v->...c", J, qacc_smooth))
    if acc_smooth_extra is not None:
        rhs = rhs - acc_smooth_extra

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
                   iters: int = 30, row_live=None, **extra) -> torch.Tensor:
    """Contact forces f (..., 3K) by plain PSOR; the constraint
    acceleration is MiJt @ f[..., :rows of J]. ``extra``: the movable
    objects' terms of ``contact_system``. The engine runs the same system
    through kernel K3 (``pgs_cuda.pgs_solve``)."""
    A, rhs, Dinv, R = contact_system(J, MiJt, qacc_smooth, qvel, depth,
                                     active, row_live, **extra)
    return psor_plain(A, rhs, Dinv, R, friction, active, iters)
