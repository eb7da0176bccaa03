"""The batched humanoid simulation engine (port of
``kinpoly_tpu/physics/engine.py``): stable-PD control (with per-substep
meta-PD gains), implicit or explicit residual force control, soft floor,
joint-limit and object contacts, semi-implicit Euler, and the scene objects
as static geometry or as free bodies.

Per substep: FK and the motion subspaces, RNEA bias force, the two SPD
systems M + Kd dt and M, the stable-PD solve (one right-hand side), planned
floor and joint-limit contacts, the fused multi-RHS solve [tau - C, J^T]
(1 + 54 columns), the Delassus build J M^-1 J^T, PSOR (kernel K3),
integration. A control step is one contact plan and ``n_substeps`` substeps
under a fixed action.

Two SPD solvers, as in the JAX package. ``solver="ltdl"`` (the default;
``"pallas_ltdl"`` names the same route): packed CRBA and two tree-sparse
LTDL factorizations (kernel K1) with their solves (kernel K2).
``solver="dense"``: the dense CRBA mass matrix, solved by PyTorch's
Cholesky, or by kernel K4a with ``use_pallas_chol`` (which, as in JAX,
makes "dense" the default solver). On a CUDA device the kernels always run;
CPU tensors take their plain versions (``ltdl.factor``/``ltdl.solve``,
``chol.solve_only``, ``contact.psor_plain``).

Objects (``with_objects``): static geometry posed per control step
(``control_step(..., obj_qpos=)``), or with ``movable_objects`` free rigid
bodies in ``SimState.obj_qpos/obj_qvel``, coupled to the contact rows
through the object-side Delassus block and integrated after the contact
solve. Their object-floor rows stay out of the humanoid's Jacobian and mass
solve (``split_of``), and ``compact_k = (K_h, K_o)`` gathers the deepest
active blocks of each pool before the mass solve (the AR scripts' (16, 8):
K2 at 1 + 3 x 16 columns, K3 over 24 blocks).

Residual forces (``ControlParams.rfc_mode``): "implicit" is one 6-d root
wrench, its linear part turned by the heading and clipped at ``rfc_lim``;
"explicit" is a wrench per body of ``vf_bodies`` (a contact point, a force
and, with ``residual_force_torque``, a torque, all in the body frame,
scaled by ``rfc_scale`` and not clipped), mapped to generalized forces.
With ``meta_pd`` the action carries 2 x ``n_substeps`` more entries that
scale every joint's k_p and k_d per substep. ``control_step(...,
with_contacts=False)`` drops the contact plan and solve: each substep then
solves M qacc = tau - C at one right-hand side, and movable objects fall as
free bodies.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import HumanoidSpec, SpecTensors, spec_tensors
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.physics import contact as ct
from kinpoly_tpu_torch.physics import dynamics as dyn
from kinpoly_tpu_torch.physics import fk as fklib
from kinpoly_tpu_torch.physics import chol_cuda, ltdl, ltdl_cuda, pgs_cuda
from kinpoly_tpu_torch.utils.profiling import span, spanned


class SimState(NamedTuple):
    qpos: torch.Tensor   # (..., 76)
    qvel: torch.Tensor   # (..., 75)
    # free-body object state (movable_objects only)
    obj_qpos: torch.Tensor = None   # (..., n_obj, 7)
    obj_qvel: torch.Tensor = None   # (..., n_obj, 6): (v_com, omega), world


@dataclass(frozen=True)
class ControlParams:
    """Per-joint stable-PD table (uhc.yml joint_params), residual forces
    and meta-PD."""
    jkp: np.ndarray          # (69,)
    jkd: np.ndarray          # (69,)
    a_ref: np.ndarray        # (69,) base pose for action_v = 0
    a_scale: np.ndarray      # (69,)
    torque_lim: np.ndarray   # (69,)
    rfc_scale: float = 100.0
    rfc_lim: float = float("inf")
    action_v: int = 1
    meta_pd: bool = False
    # "implicit": a 6-d root wrench; "explicit": per-body (contact point,
    # force[, torque]) wrenches of the bodies `vf_bodies` (indices)
    rfc_mode: str = "implicit"
    vf_bodies: tuple = ()
    residual_force_torque: bool = True

    @property
    def body_vf_dim(self) -> int:
        return 6 + 3 * int(self.residual_force_torque)

    @property
    def vf_dim(self) -> int:
        if self.rfc_mode == "implicit":
            return 6
        return self.body_vf_dim * len(self.vf_bodies)


class ControlTensors(NamedTuple):
    jkp: torch.Tensor
    jkd: torch.Tensor
    a_ref: torch.Tensor
    a_scale: torch.Tensor
    torque_lim: torch.Tensor
    vf_bodies: torch.Tensor   # (n_vb,) int64, the explicit wrenches' bodies


@dataclass(frozen=True)
class ObjDynParams:
    """Free-body dynamics of the scene objects, as tensors."""
    mass: torch.Tensor           # (n_obj,)
    com: torch.Tensor            # (n_obj, 3) object-frame CoM
    inertia: torch.Tensor        # (n_obj, 3, 3) about the CoM, object frame
    floor_verts: torch.Tensor    # (V, 3) object-frame floor candidates
    floor_vert_obj: torch.Tensor  # (V,) int64


@dataclass(frozen=True)
class PhysicsModel:
    """Static bundle: spec, its tensors, dynamics and packing tables,
    control table, contact candidates, all on one device in one dtype."""
    spec: HumanoidSpec
    st: SpecTensors
    tables: dyn.DynamicsTables
    topo: ltdl.LTDLTopo
    ctrl: ControlParams
    ctrl_t: ControlTensors
    cand_verts: torch.Tensor     # (N, 3) body-local contact candidates
    cand_body: torch.Tensor      # (N,) int64
    jnt_lo: torch.Tensor         # (69,)
    jnt_hi: torch.Tensor         # (69,)
    scene: ct.SceneTensors | None = None   # the objects' geoms
    # simulate the objects as free bodies (else static geometry posed per
    # control step)
    movable_objects: bool = False
    obj_dyn: ObjDynParams | None = None
    obj_floor_top_k: int = 10
    object_top_k: int = 8
    # object-floor rows out of the humanoid Jacobian and mass solve
    split_of: bool = True
    # per-env top-(K_h, K_o) gather of the humanoid-side and object-floor
    # contact blocks before the mass solve; None keeps every block
    compact_k: tuple | None = None
    n_substeps: int = 15
    contact_top_k: int = 12
    limit_top_k: int = 6
    contact_iters: int = 20
    friction: float = 1.0
    # contact-plan hoisting: choose an oversampled candidate set once per
    # control step from the step-start pose; each substep then ranks only
    # the planned candidates (the JAX package's production default)
    plan_contacts: bool = True
    plan_oversample: int = 2
    # |qvel| cap per substep (stops the v^2 Coriolis blow-up loop)
    qvel_clip: float = 100.0
    # SPD solver: "ltdl" (packed tree-sparse LTDL, kernels K1/K2) or
    # "dense" (dense Cholesky; kernel K4a with use_pallas_chol)
    solver: str = "ltdl"
    use_pallas_chol: bool = False

    @property
    def dt(self) -> float:
        return self.spec.timestep

    @property
    def control_dt(self) -> float:
        return self.spec.timestep * self.n_substeps

    @property
    def action_dim(self) -> int:
        """69 joint targets, ``ctrl.vf_dim`` residual forces and, with
        meta-PD, 2 x ``n_substeps`` gain scales."""
        return 69 + self.ctrl.vf_dim + (
            2 * self.n_substeps if self.ctrl.meta_pd else 0)

    @property
    def device(self) -> torch.device:
        return self.cand_verts.device

    @property
    def dtype(self) -> torch.dtype:
        return self.cand_verts.dtype


def build_model(spec: HumanoidSpec, ctrl: ControlParams, device=None,
                dtype: torch.dtype = torch.float32,
                with_objects: bool = False, **kw) -> PhysicsModel:
    """The physics model on `device` (CUDA unless the caller passes
    another device). ``use_pallas_chol=True`` makes ``solver="dense"`` the
    default; ``"pallas_ltdl"`` is accepted as a name of ``"ltdl"``.
    ``with_objects`` adds the spec's objects (``movable_objects=True``:
    as free bodies)."""
    device = resolve_device(device)
    if kw.get("use_pallas_chol"):
        kw.setdefault("solver", "dense")
    if kw.get("solver") == "pallas_ltdl":
        kw["solver"] = "ltdl"
    if kw.get("solver", "ltdl") not in ("ltdl", "dense"):
        raise ValueError(f"unknown solver {kw['solver']!r}")
    cand_verts, cand_body = ct.select_contact_vertices(
        spec, per_body=ct.FOOT_BODIES, default_k=4)
    tables = dyn.build_tables(spec, dtype, device)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    scene = (ct.scene_from_spec(spec) if with_objects and spec.objects
             else None)
    movable = bool(kw.get("movable_objects")) and scene is not None
    kw["movable_objects"] = movable
    if movable:
        fv, fvo = ct.object_floor_verts(scene)
        kw["obj_dyn"] = ObjDynParams(
            mass=t([o.mass for o in spec.objects]),
            com=t(np.stack([o.com for o in spec.objects])),
            inertia=t(np.stack([o.inertia for o in spec.objects])),
            floor_verts=t(fv),
            floor_vert_obj=torch.as_tensor(fvo, device=device))
    return PhysicsModel(
        spec=spec, st=spec_tensors(spec, dtype, device), tables=tables,
        topo=ltdl.build_topo(tables.dof_parent, dtype, device),
        ctrl=ctrl,
        ctrl_t=ControlTensors(t(ctrl.jkp), t(ctrl.jkd), t(ctrl.a_ref),
                              t(ctrl.a_scale), t(ctrl.torque_lim),
                              torch.as_tensor(ctrl.vf_bodies, dtype=torch.int64,
                                              device=device)),
        cand_verts=t(cand_verts),
        cand_body=torch.as_tensor(cand_body, device=device),
        jnt_lo=t(spec.jnt_range[:, 0]), jnt_hi=t(spec.jnt_range[:, 1]),
        scene=(None if scene is None
               else ct.scene_tensors(scene, dtype, device)), **kw)


def compute_torque(model: PhysicsModel, qpos, qvel, ctrl_joint, base_pos,
                   C, solve_A, jkp=None, jkd=None):
    """Stable-PD torque for one substep; `solve_A(rhs)` solves
    (M + K_d dt) x = rhs. `jkp`/`jkd` (69,) or (..., 69): this substep's
    gains (default: the model's table)."""
    dt = model.dt
    jkp = model.ctrl_t.jkp if jkp is None else jkp
    jkd = model.ctrl_t.jkd if jkd is None else jkd
    base_pos = tmath.normalize_angle_diff(base_pos, qpos[..., 7:])
    target_pos = base_pos + ctrl_joint
    zeros6 = torch.zeros(qpos.shape[:-1] + (6,), dtype=qpos.dtype,
                         device=qpos.device)
    qpos_err = torch.cat([zeros6, qpos[..., 7:] + qvel[..., 6:] * dt - target_pos],
                         dim=-1)
    k_p = torch.cat([zeros6, jkp.expand(qpos.shape[:-1] + (69,))], dim=-1)
    k_d = torch.cat([zeros6, jkd.expand(qpos.shape[:-1] + (69,))], dim=-1)
    rhs = -C - k_p * qpos_err - k_d * qvel
    q_accel = solve_A(rhs)
    qvel_err = qvel + q_accel * dt
    torque = -jkp * qpos_err[..., 6:] - jkd * qvel_err[..., 6:]
    lim = model.ctrl_t.torque_lim
    return torch.clamp(torque, -lim, lim)


def rfc_explicit(model: PhysicsModel, ks: dyn.KinState, vf: torch.Tensor):
    """Generalized forces (..., nv) of the per-body residual wrenches. Per
    body of ``vf_bodies``, `vf` holds a contact point, a force and (with
    ``residual_force_torque``) a torque, all in the body frame; force and
    torque are turned to world and scaled by ``rfc_scale``. A force f at
    world point p with torque t on body b gives every ancestor dof j of b
    Q_j = phi_j^omega . (t + p x f) + phi_j^v . f."""
    c = model.ctrl
    vb = model.ctrl_t.vf_bodies
    v = vf.reshape(vf.shape[:-1] + (vb.shape[0], c.body_vf_dim))
    xquat = ks.fk_res.xquat[..., vb, :]
    p = ks.fk_res.xpos[..., vb, :] + tmath.quat_rot_vec(xquat, v[..., 0:3])
    f = tmath.quat_rot_vec(xquat, v[..., 3:6]) * c.rfc_scale
    t = (tmath.quat_rot_vec(xquat, v[..., 6:9]) * c.rfc_scale
         if c.residual_force_torque else torch.zeros_like(f))
    n0 = t + torch.linalg.cross(p, f)
    anc = model.tables.anc_dof_body[:, vb].T                  # (n_vb, nv)
    return (torch.einsum("...jx,nj,...nx->...j", ks.phi[..., :3], anc, n0)
            + torch.einsum("...jx,nj,...nx->...j", ks.phi[..., 3:], anc, f))


def rfc_implicit(model: PhysicsModel, qpos, vf, base_rot):
    """Residual root wrench: 6 generalized forces on the free joint, the
    linear part turned by the heading."""
    vf = vf * model.ctrl.rfc_scale
    root_q = tmath.quat_mul(qpos[..., 3:7], tmath.quat_conj(base_rot))
    hq = tmath.heading_q(root_q)
    lin = tmath.quat_rot_vec(hq, vf[..., :3])
    vf = torch.cat([lin, vf[..., 3:6]], dim=-1)
    return torch.clamp(vf, -model.ctrl.rfc_lim, model.ctrl.rfc_lim)


def integrate(qpos, qvel, dt):
    """Semi-implicit Euler position update; the free-joint quaternion
    integrates the body-local angular velocity."""
    pos = qpos[..., :3] + qvel[..., :3] * dt
    quat = tmath.quat_norm(tmath.quat_mul(
        qpos[..., 3:7], tmath.quat_from_expmap(qvel[..., 3:6] * dt)))
    hinge = qpos[..., 7:] + qvel[..., 6:] * dt
    return torch.cat([pos, quat, hinge], dim=-1)


@functools.lru_cache(maxsize=None)
def _row_live(n_contact: int, n_limit: int, n_of: int,
              device: torch.device) -> torch.Tensor:
    """(3 (n_contact + n_limit + n_of),) bool: the rows that carry a
    constraint (a limit block has only its normal row)."""
    return torch.as_tensor(np.concatenate([
        np.ones(3 * n_contact, bool), np.tile([True, False, False], n_limit),
        np.ones(3 * n_of, bool)]), device=device)


def _compact_rows(compact_k, J, depth, active, friction, row_live, Jo,
                  obj_rows):
    """Active-set compaction: a per-env gather of the top K_h humanoid-side
    blocks (the rows of J: contacts and joint limits) and, separately, the
    top K_o object-floor blocks, ranked actives first and deepest first,
    before the mass solve, the Delassus build and the PSOR. Ties (parked
    objects have equal depths) go to the lower index, as ``jax.lax.top_k``
    breaks them. ``row_live`` becomes per env."""
    K_h, K_o = compact_k
    n_hb = J.shape[-2] // 3
    n_ob = depth.shape[-1] - n_hb
    K_h, K_o = min(K_h, n_hb), min(K_o, n_ob)

    def top_idx(d, a, k):
        return ct.top_k(a.to(d.dtype) * 1e3 + d, k)[1]

    idx_h = top_idx(depth[..., :n_hb], active[..., :n_hb], K_h)
    idx = idx_h
    if K_o:
        idx = torch.cat([idx_h, n_hb + top_idx(depth[..., n_hb:],
                                               active[..., n_hb:], K_o)], dim=-1)

    def g3(x, ix):                                   # (..., 3 nb, d) blocks
        xb = x.reshape(x.shape[:-2] + (-1, 3, x.shape[-1]))
        out = torch.gather(xb, -3, ix[..., None, None].expand(
            ix.shape + (3, x.shape[-1])))
        return out.reshape(out.shape[:-3] + (-1, x.shape[-1]))

    def rows(x):                                     # (..., 3 nb) rows
        return g3(x[..., None], idx)[..., 0]

    J = g3(J, idx_h)
    depth, active, friction = (torch.gather(x, -1, idx)
                               for x in (depth, active, friction))
    row_live = rows(row_live.expand(idx.shape[:-1] + row_live.shape[-1:]))
    if Jo is not None:
        Jo, obj_rows = g3(Jo, idx), rows(obj_rows)
    return J, depth, active, friction, row_live, Jo, obj_rows


def _cand_world(model: PhysicsModel, fk_res) -> torch.Tensor:
    cb = model.cand_body
    return fk_res.xpos[..., cb, :] + tmath.quat_rot_vec(
        fk_res.xquat[..., cb, :], model.cand_verts)


@spanned("physics.contact_plan")
def build_contact_plan(model: PhysicsModel, qpos: torch.Tensor,
                       obj_qpos: torch.Tensor | None = None) -> ct.ContactPlan:
    """Candidate index sets for one control step, from one FK at the
    step-start pose: ``plan_oversample`` times each per-substep top-K (the
    object pairs and the object-floor verts given `obj_qpos`)."""
    ov = model.plan_oversample
    world = _cand_world(model, fklib.fk(model.st, qpos))
    n_cand = model.cand_verts.shape[0]
    floor_idx = ct.top_k(-world[..., 2], min(ov * model.contact_top_k, n_cand))[1]
    obj_idx = of_idx = None
    if model.scene is not None and obj_qpos is not None:
        dist = ct.object_point_distances(model.scene, obj_qpos, world)[0]
        dist = dist.flatten(-2)
        obj_idx = ct.top_k(-dist, min(ov * model.object_top_k,
                                      dist.shape[-1]))[1]
    if model.movable_objects and obj_qpos is not None:
        od = model.obj_dyn
        op = obj_qpos[..., od.floor_vert_obj, :]
        z = (op[..., :3] + tmath.quat_rot_vec(op[..., 3:7], od.floor_verts))[..., 2]
        of_idx = ct.top_k(-z, min(ov * model.obj_floor_top_k, z.shape[-1]))[1]
    q = qpos[..., 7:]
    depth_all = torch.maximum(model.jnt_lo - q, q - model.jnt_hi)
    lim_idx = ct.top_k(depth_all, min(ov * model.limit_top_k,
                                      depth_all.shape[-1]))[1]
    return ct.ContactPlan(floor_idx=floor_idx, lim_idx=lim_idx,
                          obj_idx=obj_idx, of_idx=of_idx)


class _ObjFrames(NamedTuple):
    """Per-substep object terms, built once for every object."""
    com_w: torch.Tensor    # (..., n_obj, 3) world CoM
    Iw_inv: torch.Tensor   # (..., n_obj, 3, 3) world inverse inertia
    minv: torch.Tensor     # (n_obj,)
    a_smooth: torch.Tensor  # (..., n_obj, 6) gravity and gyroscopic accel


def _obj_frames(od: ObjDynParams, obj_qpos, obj_qvel) -> _ObjFrames:
    oq = obj_qpos[..., 3:7]
    Rm = tmath.quat_to_mat(oq)
    com_w = obj_qpos[..., :3] + tmath.quat_rot_vec(oq, od.com)
    Iw = Rm @ od.inertia @ Rm.transpose(-1, -2)
    Iw_inv = ct._inv3x3(Iw)
    w = obj_qvel[..., 3:]
    gyro = -torch.einsum("...nij,...nj->...ni", Iw_inv, torch.linalg.cross(
        w, torch.einsum("...nij,...nj->...ni", Iw, w)))
    gvec = torch.zeros_like(com_w)
    gvec[..., 2] = -9.81
    return _ObjFrames(com_w=com_w, Iw_inv=Iw_inv,
                      minv=1.0 / torch.clamp(od.mass, min=1e-9),
                      a_smooth=torch.cat([gvec, gyro], dim=-1))


@spanned("physics.contacts")
def _contact_accel(model: PhysicsModel, state: SimState, ks: dyn.KinState,
                   tau_minus_C: torch.Tensor, solve_M, plan, obj_qpos,
                   of: _ObjFrames | None):
    """The contact-constrained accelerations of one substep: the floor,
    joint-limit and object contact rows, the fused multi-RHS solve
    [tau - C, J^T] -> [qacc_smooth, M^-1 J^T], the Delassus build and PSOR
    (kernel K3). Returns (qacc (..., nv), the movable objects' accelerations
    (..., n_obj, 6) or None)."""
    tables = model.tables
    qpos, qvel = state.qpos, state.qvel
    dtype, device = qpos.dtype, qpos.device
    movable = of is not None
    fk_res = ks.fk_res
    margin, mu = model.spec.geom_margin, model.friction
    if plan is not None:
        cs = ct.floor_contacts_planned(
            model.cand_verts, model.cand_body, fk_res.xpos, fk_res.xquat,
            plan.floor_idx, model.contact_top_k, margin=margin, friction=mu)
        Jl, dl, al = ct.joint_limit_contacts_planned(
            qpos, model.jnt_lo, model.jnt_hi, plan.lim_idx,
            model.limit_top_k, nv=qvel.shape[-1])
    else:
        cs = ct.floor_contacts(
            model.cand_verts, model.cand_body, fk_res.xpos, fk_res.xquat,
            model.contact_top_k, margin=margin, friction=mu)
        Jl, dl, al = ct.joint_limit_contacts(
            qpos, model.jnt_lo, model.jnt_hi, model.limit_top_k,
            nv=qvel.shape[-1])
    if model.scene is not None and obj_qpos is not None:
        if plan is not None:
            ocs = ct.object_contacts_planned(
                model.scene, obj_qpos, model.cand_verts, model.cand_body,
                fk_res.xpos, fk_res.xquat, plan.obj_idx, model.object_top_k,
                margin=margin, friction=mu)
        else:
            ocs = ct.object_contacts(
                model.scene, obj_qpos, _cand_world(model, fk_res),
                model.cand_body, model.object_top_k, margin=margin,
                friction=mu)
        cs = ct.merge_contacts(cs, ocs)
    fcs = None
    split_of = movable and model.split_of
    if movable:
        od = model.obj_dyn
        if plan is not None:
            fcs = ct.object_floor_contacts_planned(
                obj_qpos, od.floor_verts, od.floor_vert_obj, plan.of_idx,
                model.obj_floor_top_k, margin=margin, friction=mu)
        else:
            fcs = ct.object_floor_contacts(
                obj_qpos, od.floor_verts, od.floor_vert_obj,
                model.obj_floor_top_k, margin=margin, friction=mu)
        if not split_of:
            cs = ct.merge_contacts(cs, fcs)

    J = torch.cat([ct.contact_jacobian(cs, ks.phi, tables.anc_dof_body), Jl],
                  dim=-2)
    depth = torch.cat([cs.depth, dl], dim=-1)
    active = torch.cat([cs.active, al], dim=-1)
    friction = torch.cat([cs.friction, torch.zeros_like(dl)], dim=-1)
    row_live = _row_live(cs.depth.shape[-1], dl.shape[-1],
                         fcs.depth.shape[-1] if split_of else 0, device)
    if split_of:
        # object-floor rows after the humanoid rows: in the PSOR system,
        # not in J (their humanoid side is identically zero)
        depth = torch.cat([depth, fcs.depth], dim=-1)
        active = torch.cat([active, fcs.active], dim=-1)
        friction = torch.cat([friction, fcs.friction], dim=-1)

    # the object side of every row, before compaction gathers it with J
    Jo = obj_rows = None
    if movable:
        Jo_c, obj_rows_c = ct.object_jacobian(cs, of.com_w)
        pad = J.shape[-2] - Jo_c.shape[-2]                 # limit rows
        Jo = torch.nn.functional.pad(Jo_c, (0, 0, 0, pad))
        obj_rows = torch.nn.functional.pad(obj_rows_c, (0, pad), value=-1)
        if split_of:
            Jo_f, obj_rows_f = ct.object_jacobian(fcs, of.com_w)
            Jo = torch.cat([Jo, Jo_f], dim=-2)
            obj_rows = torch.cat([obj_rows, obj_rows_f], dim=-1)

    if model.compact_k is not None:
        J, depth, active, friction, row_live, Jo, obj_rows = _compact_rows(
            model.compact_k, J, depth, active, friction, row_live, Jo,
            obj_rows)

    # one fused multi-RHS solve: [tau - C, J^T] -> [qacc_smooth, M^-1 J^T]
    B = torch.cat([tau_minus_C[..., None], J.transpose(-1, -2)], dim=-1)
    X = solve_M(B)
    qacc = X[..., 0]
    MiJt = X[..., 1:]

    extra = {}
    if movable:
        # the rows also see the objects' free motion: the object Delassus
        # block J_o M_o^-1 J_o^T (rows of one object), and the object
        # points' velocity and smooth acceleration along each row
        n_obj = od.mass.shape[0]
        onehot = (obj_rows[..., None] == torch.arange(
            n_obj, device=device)).to(dtype)                  # (..., C, n_obj)
        K_lin = Jo[..., :3] * (onehot @ of.minv)[..., None]
        Iwi_r = torch.einsum("...rn,...nij->...rij", onehot, of.Iw_inv)
        K_ang = torch.einsum("...rij,...rj->...ri", Iwi_r, Jo[..., 3:])
        same = ((obj_rows[..., :, None] == obj_rows[..., None, :])
                & (obj_rows >= 0)[..., :, None])
        extra = dict(
            A_extra=(torch.cat([K_lin, K_ang], dim=-1) @ Jo.transpose(-1, -2))
            * same,
            vel_extra=torch.sum(Jo * (onehot @ state.obj_qvel), dim=-1),
            acc_smooth_extra=torch.sum(Jo * (onehot @ of.a_smooth), dim=-1))

    A, rhs, Dinv, Rr = ct.contact_system(J, MiJt, qacc, qvel, depth, active,
                                         row_live, **extra)
    with span("physics.pgs"):
        f = pgs_cuda.pgs_solve(A, rhs, Dinv.contiguous(), Rr.contiguous(),
                               friction.contiguous(), active.contiguous(),
                               model.contact_iters)
    qacc = qacc + torch.einsum("...vc,...c->...v", MiJt, f[..., :J.shape[-2]])
    if not movable:
        return qacc, None
    # the contact wrench about each object's CoM
    w = torch.einsum("...rn,...r,...ri->...ni", onehot, f, Jo)
    a_lin = w[..., :3] * of.minv[:, None] + of.a_smooth[..., :3]
    a_ang = torch.einsum("...nij,...nj->...ni", of.Iw_inv, w[..., 3:]) \
        + of.a_smooth[..., 3:]
    return qacc, torch.cat([a_lin, a_ang], dim=-1)


@spanned("physics.substep")
def substep(model: PhysicsModel, state: SimState, ctrl_joint, vf, base_pos,
            base_rot, plan: ct.ContactPlan | None = None,
            obj_qpos: torch.Tensor | None = None, jkp=None, jkd=None,
            with_contacts: bool = True) -> SimState:
    """One 450 Hz physics substep with stable-PD control and, unless
    `with_contacts` is False, contacts. `plan`: the control step's
    candidate selection (None = rank every candidate). `obj_qpos`
    (..., n_obj, 7): the static objects' poses (movable objects take theirs
    from `state`). `jkp`/`jkd`: this substep's PD gains (meta-PD); k_d
    enters both the torque and the system M + K_d dt."""
    st, tables, topo = model.st, model.tables, model.topo
    qpos, qvel = state.qpos, state.qvel
    dtype, device = qpos.dtype, qpos.device
    movable = model.movable_objects and state.obj_qpos is not None
    if movable:
        obj_qpos = state.obj_qpos

    ks = dyn.kin_state(st, qpos)
    C = dyn.bias_force(tables, ks, qvel)
    zeros6 = torch.zeros(qpos.shape[:-1] + (6,), dtype=dtype, device=device)
    jkd_eff = model.ctrl_t.jkd if jkd is None else jkd
    kd_full = torch.cat([zeros6, jkd_eff.expand(qpos.shape[:-1] + (69,))],
                        dim=-1)

    if model.solver == "ltdl":
        with span("physics.crba"):
            R = ltdl.crba_packed(st, tables, topo, ks)
        with span("physics.factor"):
            Rf_A = ltdl_cuda.factor(topo, ltdl.add_diag(topo, R,
                                                        kd_full * model.dt))
            Rf_M = ltdl_cuda.factor(topo, R.contiguous())

        def solve_A(rhs):
            with span("physics.solve"):
                return ltdl_cuda.solve(topo, Rf_A,
                                       rhs[..., None].contiguous())[..., 0]

        def solve_M(B):
            with span("physics.solve"):
                return ltdl_cuda.solve(topo, Rf_M, B.contiguous())
    else:
        with span("physics.crba"):
            M = dyn.mass_matrix(st, tables, ks)
        with span("physics.factor"):
            M_pd = M + torch.diag_embed(kd_full * model.dt)
        spd = chol_cuda.solve_only if model.use_pallas_chol else dyn.chol_solve

        def solve_A(rhs):
            with span("physics.solve"):
                return spd(M_pd, rhs[..., None].contiguous())[..., 0]

        def solve_M(B):
            with span("physics.solve"):
                return spd(M, B.contiguous())

    torque = compute_torque(model, qpos, qvel, ctrl_joint, base_pos, C,
                            solve_A, jkp, jkd)
    if model.ctrl.rfc_mode == "explicit":
        tau = torch.cat([zeros6, torque], dim=-1) + rfc_explicit(model, ks, vf)
    else:
        tau = torch.cat([rfc_implicit(model, qpos, vf, base_rot), torque],
                        dim=-1)

    of = _obj_frames(model.obj_dyn, obj_qpos, state.obj_qvel) if movable else None
    if with_contacts:
        qacc, obj_acc = _contact_accel(model, state, ks, tau - C, solve_M,
                                       plan, obj_qpos, of)
    else:
        # no contact rows: the smooth acceleration alone, and the objects
        # fall as free bodies (gravity and gyroscopic terms)
        qacc = solve_M((tau - C)[..., None])[..., 0]
        obj_acc = of.a_smooth if movable else None

    obj_qpos_new, obj_qvel_new = state.obj_qpos, state.obj_qvel
    if movable:
        # free-body semi-implicit Euler; the orientation integrates the
        # world angular velocity (a left product, unlike the humanoid's root)
        u_new = state.obj_qvel + obj_acc * model.dt
        if model.qvel_clip:
            u_new = torch.clamp(u_new, -model.qvel_clip, model.qvel_clip)
        v_origin = u_new[..., :3] + torch.linalg.cross(
            u_new[..., 3:], obj_qpos[..., :3] - of.com_w)
        quat_new = tmath.quat_norm(tmath.quat_mul(
            tmath.quat_from_expmap(u_new[..., 3:] * model.dt), obj_qpos[..., 3:7]))
        obj_qpos_new = torch.cat([obj_qpos[..., :3] + v_origin * model.dt,
                                  quat_new], dim=-1)
        obj_qvel_new = u_new

    qvel_new = qvel + qacc * model.dt
    if model.qvel_clip:
        qvel_new = torch.clamp(qvel_new, -model.qvel_clip, model.qvel_clip)
    return SimState(qpos=integrate(qpos, qvel_new, model.dt), qvel=qvel_new,
                    obj_qpos=obj_qpos_new, obj_qvel=obj_qvel_new)


@spanned("physics.control_step")
def control_step(model: PhysicsModel, state: SimState, action: torch.Tensor,
                 expert_kin_pose: torch.Tensor, base_rot: torch.Tensor,
                 obj_qpos: torch.Tensor | None = None,
                 with_contacts: bool = True) -> SimState:
    """One 30 Hz control step: ``n_substeps`` substeps under a fixed action
    [69 joint targets, ``vf_dim`` residual forces, with ``meta_pd``
    2 x ``n_substeps`` gain scales]. `obj_qpos` poses static objects for
    the whole step; movable objects carry theirs in `state`. Without
    contacts no contact plan is built."""
    c = model.ctrl
    ctrl_joint = action[..., :69] * model.ctrl_t.a_scale
    vf = action[..., 69:69 + c.vf_dim]
    base_pos = expert_kin_pose if c.action_v == 1 else model.ctrl_t.a_ref
    plan = None
    if model.plan_contacts and with_contacts:
        plan_obj = (state.obj_qpos if model.movable_objects
                    and state.obj_qpos is not None else obj_qpos)
        plan = build_contact_plan(model, state.qpos, plan_obj)
    n = model.n_substeps
    if c.meta_pd:
        # substep i scales every joint's k_p by clip(meta_i + 1, 0, 10) and
        # its k_d by clip(meta_{n+i} + 1, 0, 10), per env
        meta = action[..., 69 + c.vf_dim:model.action_dim]
        scale = torch.clamp(meta + 1, 0, 10)
    for i in range(n):
        kp = kd = None
        if c.meta_pd:
            kp = model.ctrl_t.jkp * scale[..., i, None]
            kd = model.ctrl_t.jkd * scale[..., n + i, None]
        state = substep(model, state, ctrl_joint, vf, base_pos, base_rot, plan,
                        obj_qpos, jkp=kp, jkd=kd, with_contacts=with_contacts)
    return state
