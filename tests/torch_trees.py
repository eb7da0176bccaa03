"""Random trees in depth-first preorder and packed SPD systems on them, for
the port's LTDL tests. Imports no JAX, so the GPU tests can use it."""

import numpy as np
import torch

from kinpoly_tpu_torch.physics import ltdl


def random_preorder_parents(rng, nv, max_depth):
    """A random tree in depth-first preorder: dof k's parent is dof k - 1
    (p = 0.8) or a random node of the path from the root to it, no deeper
    than max_depth - 1."""
    parent, path = [-1], [0]
    for _ in range(1, nv):
        top = min(len(path), max_depth)
        i = top - 1 if rng.rand() < 0.8 else rng.randint(0, top)
        parent.append(path[i])
        path = path[:i + 1] + [len(parent) - 1]
    return np.asarray(parent)


def tree_spd_packed(rng, topo, n, zero_pivots=0, dtype=torch.float64,
                    device="cpu"):
    """Packed M = L^T D L of n envs for an arbitrary tree: L unit lower
    triangular with entries on the ancestor pairs only (so no fill-in), D
    in [0.5, 2]; with zero_pivots > 0 that many D_k are 0, which drives
    those pivots into the floor. M is built in float64, then cast."""
    nv, depth, anc = topo.nv, topo.depth, topo.anc_idx
    Lm = np.zeros((n, nv, nv))
    for k in range(nv):
        Lm[:, k, k] = 1.0
        for t in range(depth[k]):
            Lm[:, k, anc[k, t]] = rng.uniform(-0.7, 0.7, n)
    D = rng.uniform(0.5, 2.0, (n, nv))
    if zero_pivots:
        D[:, rng.choice(nv, zero_pivots, replace=False)] = 0.0
    M = np.einsum("nki,nk,nkj->nij", Lm, D, Lm)
    return ltdl.pack(topo, torch.tensor(M, dtype=dtype, device=device))
