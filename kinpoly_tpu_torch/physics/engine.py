"""The batched humanoid simulation engine (port of
``kinpoly_tpu/physics/engine.py``, the UHC env's path): stable-PD control,
implicit residual force control, soft floor contacts and joint limits,
semi-implicit Euler.

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

Not ported here (AR-only or opt-in in the JAX package): movable objects,
split object-floor rows, active-set compaction, meta-PD gains, explicit
RFC and the contacts-off substep.
"""

from __future__ import annotations

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


class SimState(NamedTuple):
    qpos: torch.Tensor   # (..., 76)
    qvel: torch.Tensor   # (..., 75)


@dataclass(frozen=True)
class ControlParams:
    """Per-joint stable-PD table (uhc.yml joint_params) and implicit RFC."""
    jkp: np.ndarray          # (69,)
    jkd: np.ndarray          # (69,)
    a_ref: np.ndarray        # (69,) base pose for action_v = 0
    a_scale: np.ndarray      # (69,)
    torque_lim: np.ndarray   # (69,)
    rfc_scale: float = 100.0
    rfc_lim: float = float("inf")
    action_v: int = 1

    @property
    def vf_dim(self) -> int:
        return 6


class ControlTensors(NamedTuple):
    jkp: torch.Tensor
    jkd: torch.Tensor
    a_ref: torch.Tensor
    a_scale: torch.Tensor
    torque_lim: torch.Tensor


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
    row_live: torch.Tensor       # (3 * (contact_top_k + limit_top_k),) bool
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
    def device(self) -> torch.device:
        return self.cand_verts.device

    @property
    def dtype(self) -> torch.dtype:
        return self.cand_verts.dtype


def build_model(spec: HumanoidSpec, ctrl: ControlParams, device=None,
                dtype: torch.dtype = torch.float32, **kw) -> PhysicsModel:
    """The physics model on `device` (CUDA unless the caller passes
    another device). ``use_pallas_chol=True`` makes ``solver="dense"`` the
    default; ``"pallas_ltdl"`` is accepted as a name of ``"ltdl"``."""
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
    k_c = kw.get("contact_top_k", 12)
    k_l = kw.get("limit_top_k", 6)
    row_live = np.concatenate([np.ones(3 * k_c, bool),
                               np.tile([True, False, False], k_l)])
    return PhysicsModel(
        spec=spec, st=spec_tensors(spec, dtype, device), tables=tables,
        topo=ltdl.build_topo(tables.dof_parent, dtype, device),
        ctrl=ctrl,
        ctrl_t=ControlTensors(t(ctrl.jkp), t(ctrl.jkd), t(ctrl.a_ref),
                              t(ctrl.a_scale), t(ctrl.torque_lim)),
        cand_verts=t(cand_verts),
        cand_body=torch.as_tensor(cand_body, device=device),
        jnt_lo=t(spec.jnt_range[:, 0]), jnt_hi=t(spec.jnt_range[:, 1]),
        row_live=torch.as_tensor(row_live, device=device), **kw)


def compute_torque(model: PhysicsModel, qpos, qvel, ctrl_joint, base_pos,
                   C, solve_A):
    """Stable-PD torque for one substep; `solve_A(rhs)` solves
    (M + K_d dt) x = rhs."""
    dt = model.dt
    jkp, jkd = model.ctrl_t.jkp, model.ctrl_t.jkd
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


def build_contact_plan(model: PhysicsModel, qpos: torch.Tensor) -> ct.ContactPlan:
    """Candidate index sets for one control step, from one FK at the
    step-start pose: ``plan_oversample`` times each per-substep top-K."""
    ov = model.plan_oversample
    fk_res = fklib.fk(model.st, qpos)
    cb = model.cand_body
    world = fk_res.xpos[..., cb, :] + tmath.quat_rot_vec(
        fk_res.xquat[..., cb, :], model.cand_verts)
    n_cand = model.cand_verts.shape[0]
    floor_idx = ct.top_k(-world[..., 2], min(ov * model.contact_top_k, n_cand))[1]
    q = qpos[..., 7:]
    depth_all = torch.maximum(model.jnt_lo - q, q - model.jnt_hi)
    lim_idx = ct.top_k(depth_all, min(ov * model.limit_top_k,
                                      depth_all.shape[-1]))[1]
    return ct.ContactPlan(floor_idx=floor_idx, lim_idx=lim_idx)


def substep(model: PhysicsModel, state: SimState, ctrl_joint, vf, base_pos,
            base_rot, plan: ct.ContactPlan | None = None) -> SimState:
    """One 450 Hz physics substep with stable-PD control and contacts.
    `plan`: the control step's candidate selection (None = rank every
    candidate)."""
    st, tables, topo = model.st, model.tables, model.topo
    qpos, qvel = state.qpos, state.qvel
    dtype, device = qpos.dtype, qpos.device

    ks = dyn.kin_state(st, qpos)
    C = dyn.bias_force(tables, ks, qvel)
    zeros6 = torch.zeros(qpos.shape[:-1] + (6,), dtype=dtype, device=device)
    kd_full = torch.cat(
        [zeros6, model.ctrl_t.jkd.expand(qpos.shape[:-1] + (69,))], dim=-1)

    if model.solver == "ltdl":
        R = ltdl.crba_packed(st, tables, topo, ks)
        Rf_A = ltdl_cuda.factor(topo, ltdl.add_diag(topo, R, kd_full * model.dt))
        Rf_M = ltdl_cuda.factor(topo, R.contiguous())

        def solve_A(rhs):
            return ltdl_cuda.solve(topo, Rf_A, rhs[..., None].contiguous())[..., 0]

        def solve_M(B):
            return ltdl_cuda.solve(topo, Rf_M, B.contiguous())
    else:
        M = dyn.mass_matrix(st, tables, ks)
        M_pd = M + torch.diag_embed(kd_full * model.dt)
        spd = chol_cuda.solve_only if model.use_pallas_chol else dyn.chol_solve

        def solve_A(rhs):
            return spd(M_pd, rhs[..., None].contiguous())[..., 0]

        def solve_M(B):
            return spd(M, B.contiguous())

    torque = compute_torque(model, qpos, qvel, ctrl_joint, base_pos, C, solve_A)
    tau = torch.cat([rfc_implicit(model, qpos, vf, base_rot), torque], dim=-1)

    fk_res = ks.fk_res
    if plan is not None:
        cs = ct.floor_contacts_planned(
            model.cand_verts, model.cand_body, fk_res.xpos, fk_res.xquat,
            plan.floor_idx, model.contact_top_k,
            margin=model.spec.geom_margin, friction=model.friction)
        Jl, dl, al = ct.joint_limit_contacts_planned(
            qpos, model.jnt_lo, model.jnt_hi, plan.lim_idx,
            model.limit_top_k, nv=qvel.shape[-1])
    else:
        cs = ct.floor_contacts(
            model.cand_verts, model.cand_body, fk_res.xpos, fk_res.xquat,
            model.contact_top_k, margin=model.spec.geom_margin,
            friction=model.friction)
        Jl, dl, al = ct.joint_limit_contacts(
            qpos, model.jnt_lo, model.jnt_hi, model.limit_top_k,
            nv=qvel.shape[-1])
    J = torch.cat([ct.contact_jacobian(cs, ks.phi, tables.anc_dof_body), Jl],
                  dim=-2)
    depth = torch.cat([cs.depth, dl], dim=-1)
    active = torch.cat([cs.active, al], dim=-1)
    friction = torch.cat([cs.friction, torch.zeros_like(dl)], dim=-1)

    # one fused multi-RHS solve: [tau - C, J^T] -> [qacc_smooth, M^-1 J^T]
    B = torch.cat([(tau - C)[..., None], J.transpose(-1, -2)], dim=-1)
    X = solve_M(B)
    qacc = X[..., 0]
    MiJt = X[..., 1:]

    A, rhs, Dinv, Rr = ct.contact_system(J, MiJt, qacc, qvel, depth, active,
                                         model.row_live)
    f = pgs_cuda.pgs_solve(A, rhs, Dinv.contiguous(), Rr, friction, active,
                           model.contact_iters)
    qacc = qacc + torch.einsum("...vc,...c->...v", MiJt, f)

    qvel_new = qvel + qacc * model.dt
    if model.qvel_clip:
        qvel_new = torch.clamp(qvel_new, -model.qvel_clip, model.qvel_clip)
    return SimState(qpos=integrate(qpos, qvel_new, model.dt), qvel=qvel_new)


def control_step(model: PhysicsModel, state: SimState, action: torch.Tensor,
                 expert_kin_pose: torch.Tensor,
                 base_rot: torch.Tensor) -> SimState:
    """One 30 Hz control step: ``n_substeps`` substeps under a fixed action
    [69 joint targets, 6 residual root forces]."""
    c = model.ctrl
    ctrl_joint = action[..., :69] * model.ctrl_t.a_scale
    vf = action[..., 69:69 + c.vf_dim]
    base_pos = expert_kin_pose if c.action_v == 1 else model.ctrl_t.a_ref
    plan = build_contact_plan(model, state.qpos) if model.plan_contacts else None
    for _ in range(model.n_substeps):
        state = substep(model, state, ctrl_joint, vf, base_pos, base_rot, plan)
    return state
