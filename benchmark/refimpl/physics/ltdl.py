"""Tree-sparse M = L^T D L factorization of the joint-space inertia matrix
(as ``kinpoly_tpu/physics/ltdl.py``).

M[i, j] != 0 only when dofs i and j lie on one root-to-leaf path, so the
factorization processed leaf-to-root has zero fill-in. Row k of M is packed
as its nonzeros

    R[k, t] = M[k, anc(k)[t]]  for t < depth(k)  (ancestors, root first)
    R[k, depth(k)] = M[k, k]

padded to (nv, Dmax+1). Ancestor chains are nested, so dof j sits at slot
depth(j) in every descendant's packed row.

``factor`` and ``solve`` here are the plain PyTorch versions of the CUDA
kernels in ``csrc/ltdl.cu`` (wrapped by ``ltdl_cuda``); the tests and
``chip_smoke.py`` hold the kernels to them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from refimpl.physics.dynamics import composite_force

DIAG_REG = 1e-6   # relative D floor (modified-LTDL regularization)


class LTDLTopo(NamedTuple):
    """Packing tables of the dof tree: numpy for the level loops, tensors
    (on the model's device) for the batched gathers and the kernels."""
    anc_idx: np.ndarray      # (nv, Dmax+1): ancestors root-first, then k, padded with k
    depth: np.ndarray        # (nv,)
    levels: tuple            # dofs per depth, index = depth
    nv: int
    dmax: int
    anc_idx_t: torch.Tensor  # (nv, Dmax+1) int64
    valid: torch.Tensor      # (nv, Dmax+1) 1 where slot t <= depth[k]
    diag_onehot: torch.Tensor  # (nv, Dmax+1) 1 at slot depth[k]
    kernel_tables: tuple     # int32 (anc (nv*(Dmax+1)), depth (nv))
    preorder: bool           # dofs in depth-first preorder (kernel K2 needs it)


def subtree_end(depth: np.ndarray) -> np.ndarray:
    """end[j] = the first k > j with depth[k] <= depth[j] (nv if none). In
    depth-first preorder the subtree of j is the index range (j, end[j]);
    kernel K2 derives this table from ``depth`` in the same way."""
    nv = len(depth)
    end = np.empty(nv, dtype=np.int64)
    for j in range(nv):
        e = j + 1
        while e < nv and depth[e] > depth[j]:
            e += 1
        end[j] = e
    return end


def column_offsets(depth: np.ndarray) -> np.ndarray:
    """ptr[j]: where column j of L (L[k][depth j] for k in (j, end[j]))
    starts in kernel K2's staged factor, each column padded to a multiple
    of 4 floats (16 bytes); (nv + 1,), the last entry is the columns'
    padded size."""
    end = subtree_end(depth)
    m = end - np.arange(len(depth)) - 1
    return np.concatenate([[0], np.cumsum((m + 3) // 4 * 4)])


def is_preorder(anc_idx: np.ndarray, depth: np.ndarray) -> bool:
    """Whether the descendants of every dof j are exactly (j, end[j])."""
    end = subtree_end(depth)
    nv = len(depth)
    for j in range(nv):
        desc = [k for k in range(nv)
                if depth[k] > depth[j] and anc_idx[k, depth[j]] == j]
        if desc != list(range(j + 1, int(end[j]))):
            return False
    return True


def build_topo(dof_parent: np.ndarray, dtype: torch.dtype, device) -> LTDLTopo:
    nv = len(dof_parent)
    anc = []
    for k in range(nv):
        chain = []
        j = int(dof_parent[k])
        while j >= 0:
            chain.append(j)
            j = int(dof_parent[j])
        anc.append(chain[::-1])
    depth = np.asarray([len(a) for a in anc], dtype=np.int32)
    dmax = int(depth.max())
    anc_idx = np.zeros((nv, dmax + 1), dtype=np.int64)
    for k in range(nv):
        anc_idx[k, :depth[k]] = anc[k]
        anc_idx[k, depth[k]:] = k
    slots = np.arange(dmax + 1)[None, :]
    levels = tuple(np.asarray([k for k in range(nv) if depth[k] == d],
                              dtype=np.int64) for d in range(dmax + 1))
    t = lambda x, dt=dtype: torch.as_tensor(x, dtype=dt, device=device)
    return LTDLTopo(
        anc_idx=anc_idx, depth=depth, levels=levels, nv=nv, dmax=dmax,
        anc_idx_t=t(anc_idx, torch.int64),
        valid=t((slots <= depth[:, None]).astype(np.float64)),
        diag_onehot=t((slots == depth[:, None]).astype(np.float64)),
        kernel_tables=(t(anc_idx.reshape(-1), torch.int32),
                       t(depth, torch.int32)),
        preorder=is_preorder(anc_idx, depth))


def pack(topo: LTDLTopo, M: torch.Tensor) -> torch.Tensor:
    """Dense (..., nv, nv) -> packed (..., nv, Dmax+1)."""
    idx = topo.anc_idx_t.expand(M.shape[:-2] + topo.anc_idx_t.shape)
    return torch.gather(M, -1, idx) * topo.valid.to(M.dtype)


def unpack(topo: LTDLTopo, R: torch.Tensor) -> torch.Tensor:
    """Packed -> dense symmetric (..., nv, nv)."""
    nv, dp1 = topo.nv, topo.dmax + 1
    out = torch.zeros(R.shape[:-2] + (nv * nv,), dtype=R.dtype, device=R.device)
    rows = np.repeat(np.arange(nv), dp1)
    flat = torch.as_tensor(rows * nv + topo.anc_idx.reshape(-1), device=R.device)
    vals = (R * topo.valid.to(R.dtype)).reshape(R.shape[:-2] + (-1,))
    out.index_add_(-1, flat, vals)
    out = out.reshape(R.shape[:-2] + (nv, nv))
    eye = torch.eye(nv, dtype=R.dtype, device=R.device)
    out = out - 0.5 * out * eye
    return out + out.transpose(-1, -2)


def add_diag(topo: LTDLTopo, R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R + diag(v) in packed form."""
    return R + v[..., None] * topo.diag_onehot.to(R.dtype)


def diag_of(topo: LTDLTopo, R: torch.Tensor) -> torch.Tensor:
    return torch.sum(R * topo.diag_onehot.to(R.dtype), dim=-1)


def factor(topo: LTDLTopo, R: torch.Tensor, reg: float = DIAG_REG) -> torch.Tensor:
    """Packed M = L^T D L: slots < depth of the result hold L's
    off-diagonals, slot depth holds D. Plain version of kernel K1.

    Levels are eliminated deepest first; dofs of one level lie in disjoint
    subtrees, so their updates commute and go in as one duplicate-summing
    index_add. Pivots are floored at ``reg * max(|M_kk|, 1)`` of the INPUT
    diagonal, the depth-0 pivots included, so the solve's D^-1 is safe."""
    d0 = diag_of(topo, R)
    dmin = reg * torch.clamp(torch.abs(d0), min=1.0)
    R = R.clone()
    width = topo.dmax + 1
    for d in range(topo.dmax, 0, -1):
        K = torch.as_tensor(topo.levels[d], device=R.device)
        if len(K) == 0:
            continue
        rows = R[..., K, :d + 1]                            # (..., m, d+1)
        Dk = torch.maximum(rows[..., d], dmin[..., K])
        Lk = rows[..., :d] / Dk[..., None]
        R[..., K, :d] = Lk
        R[..., K, d] = Dk
        # ancestor a_t (depth t) loses the packed triangle Lk[t] * rows[:t+1]
        tril = torch.tril(torch.ones((d, d + 1), dtype=R.dtype,
                                     device=R.device))
        upd = Lk[..., :, :, None] * rows[..., None, :] * tril  # (..., m, d, d+1)
        upd = torch.nn.functional.pad(upd, (0, width - d - 1))
        upd = upd.reshape(upd.shape[:-3] + (-1, width))
        tgt = topo.anc_idx_t[K, :d].reshape(-1)
        R.index_add_(-2, tgt, -upd)
    dvec = diag_of(topo, R)
    return add_diag(topo, R, torch.maximum(dvec, dmin) - dvec)


def solve(topo: LTDLTopo, Rf: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b given Rf = factor(R); b (..., nv, r). Plain version of
    kernel K2: L^T y = b by descending depth, D^-1, then L x = z by
    ascending depth."""
    y = b.clone()
    for d in range(topo.dmax, 0, -1):
        K = torch.as_tensor(topo.levels[d], device=b.device)
        if len(K) == 0:
            continue
        Lk = Rf[..., K, :d]
        upd = Lk[..., :, :, None] * y[..., K, None, :]      # (..., m, d, r)
        upd = upd.reshape(upd.shape[:-3] + (-1, y.shape[-1]))
        tgt = topo.anc_idx_t[K, :d].reshape(-1)
        y.index_add_(-2, tgt, -upd)
    x = y / diag_of(topo, Rf)[..., None]
    for d in range(1, topo.dmax + 1):
        K = torch.as_tensor(topo.levels[d], device=b.device)
        if len(K) == 0:
            continue
        Lk = Rf[..., K, :d]
        xa = x[..., topo.anc_idx_t[K, :d], :]                 # (..., m, d, r)
        x[..., K, :] -= torch.einsum("...md,...mdr->...mr", Lk, xa)
    return x


def crba_packed(st, tables, topo: LTDLTopo, ks) -> torch.Tensor:
    """CRBA straight into packed form: R[k, t] = phi_{anc(k)[t]} . F_k, plus
    armature on the diagonal; the dense M is never formed."""
    F = composite_force(tables, ks)
    phi_anc = ks.phi[..., topo.anc_idx_t, :]                # (..., nv, D+1, 6)
    R = torch.einsum("...ktx,...kx->...kt", phi_anc, F)
    return add_diag(topo, R * topo.valid, st.armature)
