"""Random trees in depth-first preorder, packed SPD systems on them and
body trees with seeded poses, for the port's LTDL and kinematics tests.
Imports no JAX, so the GPU tests can use it."""

import numpy as np
import torch

from kinpoly_tpu_torch.anim.spec import SpecTensors
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


def random_body_tree(rng, n_body, max_depth, dtype=torch.float64, device="cpu"):
    """The kinematics' view of a random body tree in preorder: a
    SpecTensors with random bone offsets and centres of mass (within
    0.3 m) and unit masses."""
    parents = random_preorder_parents(rng, n_body, max_depth)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    nv = 6 + 3 * (n_body - 1)
    return SpecTensors(
        parents=tuple(int(p) for p in parents),
        parent_idx=torch.as_tensor(parents[1:], dtype=torch.int64,
                                   device=device),
        body_pos=t(rng.uniform(-0.3, 0.3, (n_body, 3))),
        body_ipos=t(rng.uniform(-0.3, 0.3, (n_body, 3))),
        body_mass=t(np.ones(n_body)),
        body_inertia=t(np.tile(np.eye(3), (n_body, 1, 1))),
        armature=t(np.zeros(nv)), mass_frac=t(np.full(n_body, 1.0 / n_body)))


def seeded_poses(rng, n, n_body):
    """n poses of an n_body tree: root position within 1 m, an
    unnormalised root quaternion (norm 0.5 to 2), hinge angles up to
    +-4 pi."""
    q = np.zeros((n, 7 + 3 * (n_body - 1)))
    q[:, :3] = rng.uniform(-1.0, 1.0, (n, 3))
    root = rng.normal(0, 1, (n, 4))
    q[:, 3:7] = root / np.linalg.norm(root, axis=1, keepdims=True) \
        * rng.uniform(0.5, 2.0, (n, 1))
    q[:, 7:] = rng.uniform(-4 * np.pi, 4 * np.pi, (n, 3 * (n_body - 1)))
    return q
