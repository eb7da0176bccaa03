"""Articulated rigid-body dynamics of the SMPL humanoid (port of
``kinpoly_tpu/physics/dynamics.py``): world-frame Plücker algebra anchored at
the world origin over the 75-dof tree; CRBA mass matrix and RNEA bias force
as batched einsums; the dense SPD solve of the ``solver="dense"`` engine.

Motion vectors are (omega, v0), force vectors (n0, f). Free-joint linear
qvel is in the world frame, angular qvel in the body frame (MuJoCo).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.physics import fk as fklib
from kinpoly_tpu_torch.utils.profiling import spanned


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def cross_motion(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x_m u."""
    w, v0 = v[..., :3], v[..., 3:]
    uw, uv = u[..., :3], u[..., 3:]
    return torch.cat([_cross(w, uw), _cross(w, uv) + _cross(v0, uw)], dim=-1)


def cross_force(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x_f g."""
    w, v0 = v[..., :3], v[..., 3:]
    n, f = g[..., :3], g[..., 3:]
    return torch.cat([_cross(w, n) + _cross(v0, f), _cross(w, f)], dim=-1)


class DynamicsTables(NamedTuple):
    """Index tables derived once from the spec: numpy for host-side
    construction, tensors for the batched math."""
    dof_body: np.ndarray        # (75,) body index per dof
    dof_parent: np.ndarray      # (75,) parent dof in the dof tree
    anc_dof_body: torch.Tensor  # (75, B) 1 if dof j is an ancestor of body b
    anc_dof_dof: torch.Tensor   # (75, 75) 1 if dof i ancestor-or-self of j
    last_dof: torch.Tensor      # (B,) int64 last dof of each body


def build_tables(spec, dtype: torch.dtype, device) -> DynamicsTables:
    B = len(spec.body_names)
    nv = 6 + 3 * (B - 1)
    dof_body = np.zeros(nv, dtype=np.int32)
    dof_parent = np.full(nv, -1, dtype=np.int32)
    for k in range(1, 6):
        dof_parent[k] = k - 1
    last_dof = {0: 5}
    for i in range(1, B):
        p = int(spec.parents[i])
        d0 = 6 + 3 * (i - 1)
        dof_body[d0:d0 + 3] = i
        dof_parent[d0] = last_dof[p]
        dof_parent[d0 + 1] = d0
        dof_parent[d0 + 2] = d0 + 1
        last_dof[i] = d0 + 2

    anc_dd = np.zeros((nv, nv))
    for j in range(nv):
        k = j
        while k >= 0:
            anc_dd[k, j] = 1.0
            k = dof_parent[k]
    anc_db = np.zeros((nv, B))
    for b in range(B):
        j = last_dof[b]
        while j >= 0:
            anc_db[j, b] = 1.0
            j = dof_parent[j]
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return DynamicsTables(
        dof_body=dof_body, dof_parent=dof_parent,
        anc_dof_body=t(anc_db), anc_dof_dof=t(anc_dd),
        last_dof=torch.as_tensor([last_dof[b] for b in range(B)],
                                 device=device))


class KinState(NamedTuple):
    """Position-dependent quantities, computed once per substep."""
    fk_res: fklib.FKResult
    phi: torch.Tensor       # (..., 75, 6) per-dof motion subspace
    ic_world: torch.Tensor  # (..., B, 6, 6) per-body spatial inertia at origin


def kin_state(st, qpos: torch.Tensor) -> KinState:
    res, df = fklib.fk_frames(st, qpos)

    # translational dofs 0-2 -> (0, e); rotational -> (a, p x a)
    is_trans = torch.zeros((df.axis.shape[-2], 1), dtype=qpos.dtype,
                           device=qpos.device)
    is_trans[:3, 0] = 1.0
    omega = df.axis * (1.0 - is_trans)
    v0 = _cross(df.anchor, df.axis) * (1.0 - is_trans) + df.axis * is_trans
    phi = torch.cat([omega, v0], dim=-1)

    R = tmath.quat_to_mat(res.xquat)
    I_c = R @ st.body_inertia @ R.transpose(-1, -2)
    chat = _skew(res.xipos)
    m = st.body_mass[:, None, None]
    eye3 = torch.eye(3, dtype=qpos.dtype, device=qpos.device).expand(chat.shape)
    ic = torch.cat([
        torch.cat([I_c - m * (chat @ chat), m * chat], dim=-1),
        torch.cat([-m * chat, m * eye3], dim=-1),
    ], dim=-2)
    return KinState(fk_res=res, phi=phi, ic_world=ic)


def composite_force(tables: DynamicsTables, ks: KinState) -> torch.Tensor:
    """F_j = (sum of the body inertias in dof j's subtree) phi_j."""
    return torch.einsum("jb,...bxy,...jy->...jx", tables.anc_dof_body,
                        ks.ic_world, ks.phi)


def mass_matrix(st, tables: DynamicsTables, ks: KinState) -> torch.Tensor:
    """CRBA: dense (..., 75, 75) joint-space inertia (== mj_fullM) with
    armature on the diagonal."""
    anc_dd = tables.anc_dof_dof
    F = composite_force(tables, ks)
    G = torch.einsum("...ix,...jx->...ij", ks.phi, F)
    M = torch.where(anc_dd > 0, G, G.transpose(-1, -2))
    M = M * torch.maximum(anc_dd, anc_dd.T)
    return M + torch.diag(st.armature)


@spanned("physics.bias_force")
def bias_force(tables: DynamicsTables, ks: KinState, qvel: torch.Tensor,
               gravity: float = -9.81) -> torch.Tensor:
    """RNEA with qacc = 0: qfrc_bias (Coriolis, centrifugal, gravity), with
    MuJoCo's sign (M qacc = tau - qfrc_bias)."""
    anc_dd = tables.anc_dof_dof
    phi_qd = ks.phi * qvel[..., None]
    v_dof = torch.einsum("ij,...ix->...jx", anc_dd, phi_qd)
    # each dof's axis is fixed in the frame before it, except the free
    # joint's rotational dofs, which move with the full root velocity
    zeta = cross_motion(v_dof, phi_qd)
    v_root_full = v_dof[..., 5:6, :]
    zeta = torch.cat([zeta[..., :3, :],
                      cross_motion(v_root_full, phi_qd[..., 3:6, :]),
                      zeta[..., 6:, :]], dim=-2)
    a_dof = torch.einsum("ij,...ix->...jx", anc_dd, zeta)
    a_dof = a_dof.clone()
    a_dof[..., :, 5] += -gravity    # base acceleration -g z

    v_body = v_dof[..., tables.last_dof, :]
    a_body = a_dof[..., tables.last_dof, :]
    f_body = torch.einsum("...bxy,...by->...bx", ks.ic_world, a_body) + \
        cross_force(v_body,
                    torch.einsum("...bxy,...by->...bx", ks.ic_world, v_body))
    return torch.einsum("...jx,jb,...bx->...j", ks.phi, tables.anc_dof_body,
                        f_body)


def chol_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve through PyTorch's Cholesky; rhs (..., n) or
    (..., n, k). The dense solver without the kernel: the JAX package leaves
    this to XLA's library routines. A matrix that is not SPD gives NaN, as
    XLA's Cholesky does (``cholesky_ex`` neither raises nor syncs)."""
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    vec = rhs.dim() == M.dim() - 1
    b = rhs[..., None] if vec else rhs
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x
