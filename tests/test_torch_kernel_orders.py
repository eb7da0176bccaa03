"""The order of operations of the CUDA kernels K1 (LTDL factor), K2 (LTDL
solve), K3 (block PSOR), K4a/K4b (dense Cholesky solve) and K4c (solve
with a given factor), emulated on the CPU.

The kernels run only on the card, where ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold them to their plain versions.
Here the emulations check what the kernels compute differently from the
plain versions: K3 keeps v = A f incrementally, starting each sweep from
A f summed afresh during the sweep before, K2 runs its passes over the
subtree ranges of a depth-first preorder (for R > 1 in parent-child units),
from a staged column layout that it derives from the depth table, and K1
eliminates in descending index order with the pending rows of the current
dof's ancestors held one per lane, multiplying by reciprocal pivots.
K4a/K4b factor [A | B]^T (the right-hand sides as extra rows, so the
forward solve comes with the factor) left-looking in panels of 4 columns,
each panel's 4 x 4 pivot block by reciprocal square roots, then solve
L^T X = Y panel by panel from the last; with one right-hand side the
lanes of a warp split each panel's sum. K4c stages a given L as K4a
stages A, multiplies by the reciprocals of its diagonal, and runs the
forward solve as the mirror of that backward solve.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.physics import ltdl as jltdl
from kinpoly_tpu.physics import pallas_chol as jchol
from kinpoly_tpu.physics.pallas_pgs import pgs_solve_pallas
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.physics import contact as ct
from kinpoly_tpu_torch.physics import dynamics as dyn
from kinpoly_tpu_torch.physics import ltdl
from torch_trees import random_preorder_parents, tree_spd_packed

PGS_RTOL, PGS_ATOL = 2e-4, 2e-5   # as tests/test_pallas_pgs.py:69
SOLVE_RTOL = 1e-10                # float64, relative to max |x|
FACTOR_RTOL = 1e-10               # float64, relative to max |Rf|
CHOL_RTOL = 1e-10                 # float64, relative to max |x| and max |L|


# --- K3 ---------------------------------------------------------------------

def pgs_kernel_order(A, rhs, Dinv, R, mu, active, iters):
    """K3's order: each block's residual from v (not from a fresh dot
    product), then v += A[:, 3k:3k+3] (f_new - f_old); beside it, vn +=
    A[:, 3k:3k+3] f_new sums A f afresh from the sweep's final forces, and
    the next sweep starts from v = vn (v = 0 before the first)."""
    K = mu.shape[-1]
    act = active.to(rhs.dtype)
    f = torch.zeros_like(rhs)
    v = torch.zeros_like(rhs)
    for _ in range(iters):
        vn = torch.zeros_like(rhs)
        for k in range(K):
            s = slice(3 * k, 3 * k + 3)
            fk = f[..., s].clone()
            q = rhs[..., s] - v[..., s] - R[..., s] * fk
            g = fk + torch.einsum("...ij,...j->...i", Dinv[..., k, :, :], q)
            fn = torch.clamp(g[..., 0], min=0.0)
            tn = torch.sqrt(g[..., 1] ** 2 + g[..., 2] ** 2 + 1e-24)
            scale = torch.clamp(mu[..., k] * fn / tn, max=1.0)
            new = torch.stack([fn, g[..., 1] * scale, g[..., 2] * scale], -1)
            new = new * act[..., k, None]
            d = new - fk
            cols = A[..., :, 3 * k:3 * k + 3]
            v = v + (cols[..., 0] * d[..., 0:1] + cols[..., 1] * d[..., 1:2]
                     + cols[..., 2] * d[..., 2:3])
            vn = vn + (cols[..., 0] * new[..., 0:1] + cols[..., 1]
                       * new[..., 1:2] + cols[..., 2] * new[..., 2:3])
            f[..., s] = new
        v = vn
    return f


def psor_system(seed: int, n: int, k: int, log_scale: float = 0.0):
    """The SPD systems of tests/test_pallas_pgs.py (A = J J^T + 0.5 I, the
    engine's regularisation, ~30% inactive blocks), with the main path's
    12 floor blocks (mu = 1) before the frictionless ones; rows and columns
    scaled by exp(U(-log_scale, log_scale)) for an ill-conditioned A.
    float64 numpy, bool active."""
    rng = np.random.RandomState(seed)
    c = 3 * k
    J = rng.randn(n, c, 40)
    A = J @ np.swapaxes(J, -1, -2) + np.eye(c) * 0.5
    rhs = rng.randn(n, c)
    S = np.exp(rng.uniform(-log_scale, log_scale, (n, c)))
    A = S[:, :, None] * A * S[:, None, :]
    rhs = S * rhs
    d = np.repeat(rng.uniform(0.85, 0.95, (n, k)), 3, -1)
    active = rng.rand(n, k) > 0.3
    R = (1 - d) / d * np.diagonal(A, axis1=-2, axis2=-1)
    R = np.where(np.repeat(active, 3, -1), R, 1e8)
    A3 = A.reshape(n, k, 3, k, 3)
    D = np.stack([A3[:, i, :, i, :] for i in range(k)], axis=1)
    D = D + R.reshape(n, k, 3)[..., None] * np.eye(3) + 1e-9 * np.eye(3)
    mu = np.broadcast_to(np.where(np.arange(k) < 12, 1.0, 0.0), (n, k)).copy()
    return A, rhs, np.linalg.inv(D), R, mu, active


def _f32(system):
    return [torch.tensor(x, dtype=torch.float32) if x.dtype != bool
            else torch.tensor(x) for x in system]


@pytest.mark.parametrize("k,iters", [(6, 12), (18, 20)])
def test_pgs_kernel_order_matches_pallas(k, iters):
    system = psor_system(0, 5, k)
    ref = np.asarray(pgs_solve_pallas(
        *(jnp.asarray(x.astype(np.float32) if x.dtype != bool else x)
          for x in system), iters=iters, interpret=True))
    out = pgs_kernel_order(*_f32(system), iters).numpy()
    assert np.abs(out).max() > 1e-3            # the system has live forces
    np.testing.assert_allclose(out, ref, rtol=PGS_RTOL, atol=PGS_ATOL)


@pytest.mark.parametrize("k", [18, 24, 36])
def test_pgs_kernel_order_matches_plain(k):
    """At the main path's 18 blocks and the objects slice's 24 (compacted)
    and 36 blocks."""
    args = _f32(psor_system(1, 6, k))
    np.testing.assert_allclose(pgs_kernel_order(*args, 20).numpy(),
                               ct.psor_plain(*args, 20).numpy(),
                               rtol=PGS_RTOL, atol=PGS_ATOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_pgs_kernel_order_drift_bounded_on_ill_conditioned_system(seed):
    """Row scales up to e^3 either way: the incremental v, summed afresh for
    every sweep, stays within twice the plain float32 version's distance from
    the float64 solution."""
    system = psor_system(seed, 40, 18, log_scale=3.0)
    f64 = ct.psor_plain(*(torch.tensor(x) for x in system), 20)
    args = _f32(system)
    e_kernel = float((pgs_kernel_order(*args, 20).double() - f64).abs().max())
    e_plain = float((ct.psor_plain(*args, 20).double() - f64).abs().max())
    assert float(f64.abs().max()) > 1e-3
    assert e_kernel <= 2 * e_plain, (e_kernel, e_plain)


# --- K2 ---------------------------------------------------------------------

def stage_columns(depth, anc_idx, Rf):
    """K2's staging: the live slots of each packed row go to col[ptr[j] +
    k - j - 1] (L[k][t], j = anc(k)[t]) or to dg[k] (the pivot)."""
    nv = len(depth)
    ptr = ltdl.column_offsets(depth)
    col = Rf.new_zeros(Rf.shape[:-2] + (int(ptr[-1]),))
    dg = Rf.new_zeros(Rf.shape[:-2] + (nv,))
    for k in range(nv):
        for t in range(int(depth[k]) + 1):
            if t < depth[k]:
                j = int(anc_idx[k, t])
                col[..., ptr[j] + k - j - 1] = Rf[..., k, t]
            else:
                dg[..., k] = Rf[..., k, t]
    return col, dg


def solve_kernel_order(topo, Rf, B):
    """K2's passes: pass 1 pulls each dof's subtree (descending index),
    pass 2 multiplies by the reciprocal pivots, pass 3 pushes each final
    x_j into its subtree (ascending index). With R > 1 an even dof a whose
    next dof b = a + 1 is its child forms one unit with it: one sweep over
    b's subtree serves both columns, then b's own term, then the rest of
    a's subtree."""
    depth, nv = topo.depth, topo.nv
    paired = B.shape[-1] > 1
    end = ltdl.subtree_end(depth)
    ptr = ltdl.column_offsets(depth)
    col, dg = stage_columns(depth, topo.anc_idx, Rf)
    L = lambda j, lo, hi: col[..., ptr[j] + lo:ptr[j] + hi]   # rows j+1+lo ..
    pair = lambda a: paired and a % 2 == 0 and a + 1 < nv and depth[a + 1] > depth[a]
    dot = lambda l, rows: torch.einsum("...i,...ir->...r", l, rows)
    x = B.clone()
    j = nv - 1
    while j >= 0:
        if j % 2 == 1 and pair(j - 1):
            a, b = j - 1, j
            ma, mb = int(end[a]) - a - 1, int(end[b]) - b - 1
            sub = x[..., b + 1:b + 1 + mb, :]
            x[..., b, :] -= dot(L(b, 0, mb), sub)
            acc = x[..., a, :] - dot(L(a, 1, mb + 1), sub)
            acc = acc - L(a, 0, 1) * x[..., b, :]
            x[..., a, :] = acc - dot(L(a, mb + 1, ma), x[..., a + mb + 2:a + 1 + ma, :])
            j -= 2
        else:
            m = int(end[j]) - j - 1
            x[..., j, :] -= dot(L(j, 0, m), x[..., j + 1:j + 1 + m, :])
            j -= 1
    x = x * (1.0 / dg)[..., None]
    j = 0
    while j < nv:
        if pair(j):
            a, b = j, j + 1
            ma, mb = int(end[a]) - a - 1, int(end[b]) - b - 1
            x[..., b, :] -= L(a, 0, 1) * x[..., a, :]
            x[..., b + 1:b + 1 + mb, :] -= (L(a, 1, mb + 1)[..., None] * x[..., a:a + 1, :]
                                          + L(b, 0, mb)[..., None] * x[..., b:b + 1, :])
            x[..., a + mb + 2:a + 1 + ma, :] -= L(a, mb + 1, ma)[..., None] * x[..., a:a + 1, :]
            j += 2
        else:
            m = int(end[j]) - j - 1
            x[..., j + 1:j + 1 + m, :] -= L(j, 0, m)[..., None] * x[..., j:j + 1, :]
            j += 1
    return x


@pytest.fixture(scope="module")
def humanoid():
    spec = sp.synthetic_spec(0)
    st = sp.spec_tensors(spec, torch.float64, "cpu")
    tables = dyn.build_tables(spec, torch.float64, "cpu")
    topo = ltdl.build_topo(tables.dof_parent, torch.float64, "cpu")
    return spec, st, tables, topo


@pytest.mark.parametrize("nr", [1, 49, 55, 79])
def test_solve_kernel_order_matches_plain(humanoid, nr):
    spec, st, tables, topo = humanoid
    rng = np.random.RandomState(20 + nr)
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], 3, axis=0)
    qpos[:, 7:] += rng.uniform(-0.6, 0.6, (3, 69))
    ks = dyn.kin_state(st, torch.tensor(qpos))
    R = ltdl.crba_packed(st, tables, topo, ks)
    R = ltdl.add_diag(topo, R, torch.tensor(rng.uniform(0, 100, (3, 75))
                                            * spec.timestep))
    Rf = ltdl.factor(topo, R)
    B = torch.tensor(rng.normal(size=(3, 75, nr)))
    ref = ltdl.solve(topo, Rf, B)
    out = solve_kernel_order(topo, Rf, B)
    assert float((out - ref).abs().max()) <= SOLVE_RTOL * float(ref.abs().max())



# --- K1 ---------------------------------------------------------------------

def factor_push_from(depth: np.ndarray) -> np.ndarray:
    """lo[j]: the first depth at which K1 loads fresh input rows when it
    reaches dof j. K1 eliminates in descending index order and lane t of
    its warp holds the pending row of the current dof's ancestor at depth
    t. In depth-first preorder every ancestor of dof j + 1 above its own
    depth is also an ancestor of j, so going from j + 1 to j keeps lanes
    t < depth[j + 1] and loads the rows of j's path at depths lo[j] ..
    depth[j] (none when j is the parent of j + 1, lo = depth + 1). The
    kernel derives the same numbers from the depth table."""
    nxt = np.concatenate([np.asarray(depth[1:], np.int64), [0]])
    return np.minimum(nxt, np.asarray(depth, np.int64) + 1)


def factor_kernel_order(topo, R, reg=ltdl.DIAG_REG):
    """K1's order. Dofs go in descending index (the depth-first preorder
    reversed, so a dof's subtree is done before it). Lane t of the warp
    holds acc[t], the pending packed row of the current dof's ancestor at
    depth t, in registers; arriving at dof j, lanes lo[j] .. depth[j] load
    the input rows of j's new path (slots above the lane's depth zeroed),
    the others keep theirs. Then the row of j (lane depth[j]) is broadcast
    through shared memory, its pivot is floored at reg * max(|M_jj|, 1) of
    the INPUT diagonal and inverted once, L = row * (1 / D) is written out,
    and every lane t < depth[j] subtracts L_t * row[s] from its row: the
    contributions to an ancestor are summed in the walk's order, not level
    by level. Slots s > t of lane t are never read. Padding slots pass
    through."""
    depth, anc, nv = topo.depth, topo.anc_idx, topo.nv
    width = topo.dmax + 1
    lo = factor_push_from(depth)
    out = R.clone()
    acc = R.new_zeros(R.shape[:-2] + (width, width))
    for j in range(nv - 1, -1, -1):
        d = int(depth[j])
        for t in range(int(lo[j]), d + 1):
            acc[..., t, :] = 0.0
            acc[..., t, :t + 1] = R[..., anc[j, t], :t + 1]   # anc[j, d] = j
        row = acc[..., d, :].clone()
        dmin = reg * torch.clamp(R[..., j, d].abs(), min=1.0)
        D = torch.maximum(row[..., d], dmin)
        L = row[..., :d] * (1.0 / D)[..., None]
        out[..., j, :d] = L
        out[..., j, d] = D
        acc[..., :d, :d] -= L[..., :, None] * row[..., None, :d]
    return out


def _assert_factor_close(out, ref):
    err = float((out - ref).abs().max())
    assert err <= FACTOR_RTOL * float(ref.abs().max()), err


@functools.cache
def _jax_factor_fn(parents: tuple):
    # jitted: eager JAX compiles each level's ops one by one
    topo_j = jltdl.build_topo(np.asarray(parents))
    return jax.jit(lambda R: jltdl.factor(topo_j, R))


def _jax_factor(parents, R):
    fn = _jax_factor_fn(tuple(int(p) for p in parents))
    return np.asarray(fn(jnp.asarray(R.numpy())))


@pytest.mark.parametrize("which", ["M", "A"])
def test_factor_kernel_order_matches_jax_on_the_humanoid(humanoid, which):
    """Both systems the engine factors: M, and M + Kd dt."""
    spec, st, tables, topo = humanoid
    rng = np.random.RandomState(40)
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], 4, axis=0)
    qpos[:, 7:] += rng.uniform(-0.6, 0.6, (4, 69))
    R = ltdl.crba_packed(st, tables, topo, dyn.kin_state(st, torch.tensor(qpos)))
    if which == "A":
        R = ltdl.add_diag(topo, R, torch.tensor(rng.uniform(0, 100, (4, 75))
                                                * spec.timestep))
    ref = _jax_factor(tables.dof_parent, R)
    _assert_factor_close(factor_kernel_order(topo, R), torch.tensor(ref))
    _assert_factor_close(ltdl.factor(topo, R), torch.tensor(ref))


@pytest.mark.parametrize("tree", ["chain32", "random"])
def test_factor_kernel_order_matches_jax_on_other_trees(tree):
    """A chain of 32 dofs (the kernel's deepest tree, Dmax + 1 = 32) and a
    random preorder tree with Dmax + 1 <= 32, some of whose pivots are
    floored."""
    rng = np.random.RandomState(41)
    if tree == "chain32":
        parents = np.arange(32) - 1
    else:
        parents = random_preorder_parents(rng, 60, 32)
    topo = ltdl.build_topo(parents, torch.float64, "cpu")
    assert topo.preorder and topo.dmax + 1 <= 32
    if tree == "chain32":
        assert topo.dmax + 1 == 32
    else:
        assert len(topo.levels[0]) == 1 and (np.diff(topo.depth) <= 0).sum() > 3
    R = tree_spd_packed(rng, topo, 3, zero_pivots=0 if tree == "chain32" else 4)
    ref = torch.tensor(_jax_factor(parents, R))
    _assert_factor_close(factor_kernel_order(topo, R), ref)
    dmin = ltdl.DIAG_REG * torch.clamp(ltdl.diag_of(topo, R).abs(), min=1.0)
    floored = int((ltdl.diag_of(topo, ref) == dmin).sum())
    assert floored == (0 if tree == "chain32" else 3 * 4), floored


def test_factor_kernel_order_passes_nonzero_padding_through(humanoid):
    """Padding slots of the input come out unchanged, live slots as if the
    padding were 0."""
    spec, st, tables, topo = humanoid
    rng = np.random.RandomState(42)
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], 4, axis=0)
    qpos[:, 7:] += rng.uniform(-0.6, 0.6, (4, 69))
    R = ltdl.crba_packed(st, tables, topo, dyn.kin_state(st, torch.tensor(qpos)))
    pad = torch.tensor(rng.normal(size=R.shape)) * (1.0 - topo.valid)
    out = factor_kernel_order(topo, R + pad)
    ref = torch.tensor(_jax_factor(tables.dof_parent, R + pad))
    _assert_factor_close(out, ref)
    pad_slots = topo.valid == 0
    assert float(pad[..., pad_slots].abs().min()) > 0
    assert torch.equal(out[..., pad_slots], (R + pad)[..., pad_slots])
    _assert_factor_close(out * topo.valid, factor_kernel_order(topo, R))


# --- topology tables ----------------------------------------------------------

def test_subtree_tables_match_descendants(humanoid):
    """The kernel's subtree ends and column offsets against the descendant
    sets read off the ancestor table."""
    topo = humanoid[3]
    anc, depth, nv = topo.anc_idx, topo.depth, topo.nv
    desc = [[k for k in range(nv) if depth[k] > depth[j] and anc[k, depth[j]] == j]
            for j in range(nv)]
    end = ltdl.subtree_end(depth)
    for j in range(nv):
        assert desc[j] == list(range(j + 1, int(end[j])))
    ptr = ltdl.column_offsets(depth)
    np.testing.assert_array_equal(ptr, np.concatenate(
        [[0], np.cumsum([-(-len(d) // 4) * 4 for d in desc])]))
    assert ptr[-1] - depth.sum() < 4 * nv and depth.sum() == 1146
    assert topo.preorder
    # every live slot of the packed rows lands on its own staged place,
    # inside its column
    slots = [(ptr[anc[k, t]] + k - anc[k, t] - 1, anc[k, t])
             for k in range(nv) for t in range(depth[k])]
    assert len({p for p, _ in slots}) == len(slots) == 1146
    assert all(ptr[j] <= p < ptr[j] + len(desc[j]) for p, j in slots)


def test_preorder_flag_rejects_other_orders():
    # a chain 0-1-2 with a second child 3 of 0: preorder; swapping the
    # children's order to 0, 3, 1, 2 with 3 a child of 1 is not
    pre = ltdl.build_topo(np.array([-1, 0, 1, 0]), torch.float64, "cpu")
    assert pre.preorder
    np.testing.assert_array_equal(ltdl.subtree_end(pre.depth), [4, 3, 3, 4])
    post = ltdl.build_topo(np.array([-1, 0, 0, 1]), torch.float64, "cpu")
    assert not post.preorder


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_factor_push_lanes_keep_the_shared_ancestors(humanoid, seed):
    """Going from dof j + 1 to dof j, K1's lanes t < lo[j] keep their rows:
    those are ancestors of both dofs; lanes lo[j] .. depth[j] take j's own
    path (seed 0: the humanoid; 1, 2: random preorder trees)."""
    if seed == 0:
        topo = humanoid[3]
    else:
        parents = random_preorder_parents(np.random.RandomState(seed), 50, 32)
        topo = ltdl.build_topo(parents, torch.float64, "cpu")
    anc, depth, nv = topo.anc_idx, topo.depth, topo.nv
    lo = factor_push_from(depth)
    assert lo[nv - 1] == 0
    for j in range(nv - 1):
        keep = int(lo[j])
        assert keep <= depth[j + 1]
        np.testing.assert_array_equal(anc[j, :keep], anc[j + 1, :keep])
        if keep == depth[j] + 1:     # j is the parent of j + 1
            assert anc[j + 1, depth[j]] == j


# --- K4a / K4b ----------------------------------------------------------------

def _rsqrt(d):
    with np.errstate(invalid="ignore", divide="ignore"):
        return 1.0 / np.sqrt(d)


def chol_kernel_order(A, B):
    """K4a/K4b's order on float64 numpy inputs; returns (L, X). Rows are
    padded to np = n rounded up to 4 with an identity block, and the
    right-hand sides are extra rows, E = [A | B]^T (upper triangle of A
    never read: it enters as NaN). For each panel j0 of 4 columns, every
    row r >= j0 sums its 4 panel entries over k < j0 in ascending k; the
    4 x 4 block's pivots are taken by reciprocal square roots, each row is
    solved against the block (the diagonal rows giving d * rsqrt(d) and
    zeros above), and the reciprocal pivots are kept. The backward solve
    L^T X = Y goes panel by panel from the last: with R > 1 each
    right-hand side sums its panel entries over k > i0 + 3 in ascending k;
    with R = 1 lane l of a warp sums k = i0 + 4 + l, + 32, ... and a
    butterfly (xor 16, 8, 4, 2, 1) adds the lanes. Then the block, from
    its last column."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    N, n, nr = A.shape[0], A.shape[-1], B.shape[-1]
    npd = (n + 3) // 4 * 4
    low = np.tril(np.ones((n, n), bool))
    E = np.full((N, npd + nr, npd), np.nan)
    E[:, :n, :n] = np.where(low, A, np.nan)
    E[:, n:npd, :] = 0.0
    for r in range(n, npd):
        E[:, r, r] = 1.0
    E[:, npd:, :n] = np.swapaxes(B, 1, 2)
    E[:, npd:, n:] = 0.0
    rinv = np.zeros((N, npd))
    col = lambda v: v[:, None]
    for j0 in range(0, npd, 4):
        acc = E[:, j0:, j0:j0 + 4].copy()
        for k in range(j0):
            acc -= E[:, j0:, k, None] * E[:, None, j0:j0 + 4, k]
        d = acc[:, :4]
        rv0 = _rsqrt(d[:, 0, 0])
        l10 = d[:, 1, 0] * rv0
        rv1 = _rsqrt(d[:, 1, 1] - l10 * l10)
        l20 = d[:, 2, 0] * rv0
        l21 = (d[:, 2, 1] - l20 * l10) * rv1
        rv2 = _rsqrt(d[:, 2, 2] - l20 * l20 - l21 * l21)
        l30 = d[:, 3, 0] * rv0
        l31 = (d[:, 3, 1] - l30 * l10) * rv1
        l32 = (d[:, 3, 2] - l30 * l20 - l31 * l21) * rv2
        rv3 = _rsqrt(d[:, 3, 3] - l30 * l30 - l31 * l31 - l32 * l32)
        L = np.empty_like(acc)
        L[..., 0] = acc[..., 0] * col(rv0)
        L[..., 1] = (acc[..., 1] - L[..., 0] * col(l10)) * col(rv1)
        L[..., 2] = (acc[..., 2] - L[..., 0] * col(l20) - L[..., 1] * col(l21)) * col(rv2)
        L[..., 3] = (acc[..., 3] - L[..., 0] * col(l30) - L[..., 1] * col(l31)
                     - L[..., 2] * col(l32)) * col(rv3)
        for c0 in range(3):
            L[:, c0, c0 + 1:] = 0.0
        E[:, j0:, j0:j0 + 4] = L
        rinv[:, j0:j0 + 4] = np.stack([rv0, rv1, rv2, rv3], -1)
    _backward_order(E, rinv, npd)
    return np.where(low, E[:, :n, :n], 0.0), np.swapaxes(E[:, npd:, :n], 1, 2)


def _butterfly(part):
    """The warp's xor butterfly (16, 8, 4, 2, 1) over the lanes of part
    (N, 32, 4); every lane ends with the same sums, lane 0's returned."""
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, np.arange(32) ^ o]
    return part[:, 0]


def _backward_order(E, rinv, npd):
    """L^T X = Y in place on the right-hand-side rows E[:, npd:] (rows of
    L in E[:, :npd], reciprocal pivots rinv), panel by panel from the last:
    with R > 1 each right-hand side sums its panel entries over k > i0 + 3
    in ascending k; with R = 1 lane l of a warp sums k = i0 + 4 + l, + 32,
    ... and a butterfly adds the lanes. Then the block, from its last
    column."""
    N, nr = E.shape[0], E.shape[1] - npd
    col = lambda v: v[:, None]
    for i0 in range(npd - 4, -1, -4):
        e = E[:, i0:i0 + 4, i0:i0 + 4]
        rv = rinv[:, i0:i0 + 4]
        if nr == 1:
            x = E[:, npd]
            part = np.zeros((N, 32, 4))
            for idx, k in enumerate(range(i0 + 4, npd)):
                part[:, idx % 32] += E[:, k, i0:i0 + 4] * x[:, k, None]
            acc = (x[:, i0:i0 + 4] - _butterfly(part))[:, None]
        else:
            acc = E[:, npd:, i0:i0 + 4].copy()
            for k in range(i0 + 4, npd):
                acc -= E[:, npd:, k, None] * E[:, None, k, i0:i0 + 4]
        x3 = acc[..., 3] * col(rv[:, 3])
        x2 = (acc[..., 2] - col(e[:, 3, 2]) * x3) * col(rv[:, 2])
        x1 = (acc[..., 1] - col(e[:, 2, 1]) * x2 - col(e[:, 3, 1]) * x3) * col(rv[:, 1])
        x0 = (acc[..., 0] - col(e[:, 1, 0]) * x1 - col(e[:, 2, 0]) * x2
              - col(e[:, 3, 0]) * x3) * col(rv[:, 0])
        E[:, npd:, i0:i0 + 4] = np.stack([x0, x1, x2, x3], -1)


def _chol_spd(rng, batch, n):
    """The SPD systems of tests/test_pallas_chol.py."""
    J = rng.randn(batch, n, n + 8)
    return J @ np.swapaxes(J, -1, -2) + np.eye(n) * (n * 0.1)


def _assert_chol_close(L, X, L_ref, X_ref):
    assert float(np.abs(X - X_ref).max()) <= CHOL_RTOL * float(np.abs(X_ref).max())
    assert float(np.abs(L - L_ref).max()) <= CHOL_RTOL * float(np.abs(L_ref).max())


@pytest.mark.parametrize("kernel,nr", [("chol_solve_only", 1),
                                       ("chol_factor_solve", 55)])
def test_chol_kernel_order_matches_pallas(kernel, nr):
    """Against the Pallas kernels in interpret mode, in float64."""
    rng = np.random.RandomState(50 + nr)
    A = _chol_spd(rng, 3, 75)
    B = rng.randn(3, 75, nr)
    L, X = chol_kernel_order(A, B)
    if kernel == "chol_solve_only":
        X_j = np.asarray(jchol.chol_solve_only(A, B, interpret=True))
        L_j = np.linalg.cholesky(A)
    else:
        L_j, X_j = (np.asarray(x) for x in jchol.chol_factor_solve(A, B, interpret=True))
    assert X_j.dtype == np.float64
    _assert_chol_close(L, X, np.tril(L_j), X_j)


@pytest.mark.parametrize("n,nr", [(75, 1), (75, 2), (75, 55), (8, 3), (5, 1),
                                  (1, 2)])
def test_chol_kernel_order_matches_numpy(n, nr):
    """The JAX test's SPD systems at the main path's widths and two, and
    at sizes with 0, 3 and 3 padding rows."""
    rng = np.random.RandomState(60 + n + nr)
    A = _chol_spd(rng, 4, n)
    B = rng.randn(4, n, nr)
    L, X = chol_kernel_order(A, B)
    _assert_chol_close(L, X, np.linalg.cholesky(A), np.linalg.solve(A, B))
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L))


@pytest.mark.parametrize("which,nr", [("M", 55), ("A", 1)])
def test_chol_kernel_order_on_the_humanoid(humanoid, which, nr):
    """The two systems the dense engine solves: M with 55 right-hand sides
    and M + Kd dt with one."""
    spec, st, tables, topo = humanoid
    rng = np.random.RandomState(70)
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], 4, axis=0)
    qpos[:, 7:] += rng.uniform(-0.6, 0.6, (4, 69))
    R = ltdl.crba_packed(st, tables, topo, dyn.kin_state(st, torch.tensor(qpos)))
    A = ltdl.unpack(topo, R).numpy()
    if which == "A":
        A = A + np.eye(75) * rng.uniform(0, 100, (4, 1, 75)) * spec.timestep
    B = rng.randn(4, 75, nr)
    L, X = chol_kernel_order(A, B)
    _assert_chol_close(L, X, np.linalg.cholesky(A), np.linalg.solve(A, B))


@pytest.mark.parametrize("nr", [1, 55])
def test_chol_kernel_order_not_spd_gives_nan(nr):
    rng = np.random.RandomState(80)
    A = _chol_spd(rng, 2, 75)
    A[1, 10, 10] = -1.0
    _, X = chol_kernel_order(A, rng.randn(2, 75, nr))
    assert np.isfinite(X[0]).all() and np.isnan(X[1]).any()


# --- K4c ----------------------------------------------------------------------

def apply_kernel_order(L, B):
    """K4c's order on float64 numpy inputs; returns X = (L L^T)^-1 B. L's
    lower triangle and B are staged as K4a stages A and B (rows padded to
    np = n rounded up to 4 with an identity block, the right-hand sides as
    extra rows with zeros in their padding columns, the upper triangle never
    read: it enters as NaN); the pivots are the reciprocals of L's
    diagonal, taken once. The forward solve L Y = B goes panel by panel
    from the first: with R > 1 each right-hand side sums its 4 panel
    entries over k < j0 in ascending k; with R = 1 lane l of a warp sums
    the chunks k = 4 l .. 4 l + 3, + 128, ... in order and a butterfly adds
    the lanes. Then the 4 x 4 block from its first column, and the backward
    solve as K4a's."""
    L = np.asarray(L, np.float64)
    B = np.asarray(B, np.float64)
    N, n, nr = L.shape[0], L.shape[-1], B.shape[-1]
    npd = (n + 3) // 4 * 4
    low = np.tril(np.ones((n, n), bool))
    E = np.full((N, npd + nr, npd), np.nan)
    E[:, :n, :n] = np.where(low, L, np.nan)
    E[:, n:npd, :] = 0.0
    for r in range(n, npd):
        E[:, r, r] = 1.0
    E[:, npd:, :n] = np.swapaxes(B, 1, 2)
    E[:, npd:, n:] = 0.0
    with np.errstate(divide="ignore"):
        rinv = 1.0 / np.diagonal(E[:, :npd], axis1=1, axis2=2)
    col = lambda v: v[:, None]
    for j0 in range(0, npd, 4):
        d = E[:, j0:j0 + 4, j0:j0 + 4]
        rv = rinv[:, j0:j0 + 4]
        if nr == 1:
            y = E[:, npd]
            part = np.zeros((N, 32, 4))
            for k in range(0, j0, 4):
                for c in range(4):
                    for t in range(4):
                        part[:, k // 4 % 32, c] += E[:, j0 + c, k + t] * y[:, k + t]
            acc = (y[:, j0:j0 + 4] - _butterfly(part))[:, None]
        else:
            acc = E[:, npd:, j0:j0 + 4].copy()
            for k in range(j0):
                acc -= E[:, npd:, k, None] * E[:, None, j0:j0 + 4, k]
        y0 = acc[..., 0] * col(rv[:, 0])
        y1 = (acc[..., 1] - col(d[:, 1, 0]) * y0) * col(rv[:, 1])
        y2 = (acc[..., 2] - col(d[:, 2, 0]) * y0 - col(d[:, 2, 1]) * y1) * col(rv[:, 2])
        y3 = (acc[..., 3] - col(d[:, 3, 0]) * y0 - col(d[:, 3, 1]) * y1
              - col(d[:, 3, 2]) * y2) * col(rv[:, 3])
        E[:, npd:, j0:j0 + 4] = np.stack([y0, y1, y2, y3], -1)
    _backward_order(E, rinv, npd)
    return np.swapaxes(E[:, npd:, :n], 1, 2)


def _assert_apply_close(X, X_ref):
    assert float(np.abs(X - X_ref).max()) <= CHOL_RTOL * float(np.abs(X_ref).max())


@pytest.mark.parametrize("nr", [1, 3, 55])
def test_apply_kernel_order_matches_pallas(nr):
    """Against JAX chol_apply in interpret mode, in float64, with L from
    JAX chol_factor_solve."""
    rng = np.random.RandomState(100 + nr)
    A = _chol_spd(rng, 3, 75)
    B = rng.randn(3, 75, nr)
    L_j, _ = jchol.chol_factor_solve(A, B, interpret=True)
    L_j = np.asarray(L_j)
    X_j = np.asarray(jchol.chol_apply(L_j, B, interpret=True))
    assert X_j.dtype == np.float64
    _assert_apply_close(apply_kernel_order(L_j, B), X_j)


@pytest.mark.parametrize("n,nr", [(75, 1), (75, 2), (75, 55), (8, 3), (5, 1),
                                  (1, 2)])
def test_apply_kernel_order_matches_numpy(n, nr):
    """The JAX test's SPD systems factored by numpy, at the main path's
    widths and two, and at sizes with 0, 3 and 3 padding rows."""
    rng = np.random.RandomState(110 + n + nr)
    A = _chol_spd(rng, 4, n)
    B = rng.randn(4, n, nr)
    _assert_apply_close(apply_kernel_order(np.linalg.cholesky(A), B),
                        np.linalg.solve(A, B))


@pytest.mark.parametrize("which,nr", [("M", 55), ("A", 1)])
def test_apply_kernel_order_on_the_humanoid(humanoid, which, nr):
    """The dense engine's two systems, factored: M with 55 right-hand sides
    and M + Kd dt with one."""
    spec, st, tables, topo = humanoid
    rng = np.random.RandomState(120)
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], 4, axis=0)
    qpos[:, 7:] += rng.uniform(-0.6, 0.6, (4, 69))
    R = ltdl.crba_packed(st, tables, topo, dyn.kin_state(st, torch.tensor(qpos)))
    A = ltdl.unpack(topo, R).numpy()
    if which == "A":
        A = A + np.eye(75) * rng.uniform(0, 100, (4, 1, 75)) * spec.timestep
    B = rng.randn(4, 75, nr)
    _assert_apply_close(apply_kernel_order(np.linalg.cholesky(A), B),
                        np.linalg.solve(A, B))


@pytest.mark.parametrize("nr", [1, 55])
def test_apply_kernel_order_zero_pivot_is_not_finite(nr):
    """A zero on L's diagonal gives non-finite X in that env only."""
    rng = np.random.RandomState(130)
    L = np.linalg.cholesky(_chol_spd(rng, 2, 75))
    L[1, 10, 10] = 0.0
    with np.errstate(invalid="ignore"):
        X = apply_kernel_order(L, rng.randn(2, 75, nr))
    assert np.isfinite(X[0]).all() and not np.isfinite(X[1]).all()


def test_apply_kernel_order_ignores_the_upper_triangle():
    """NaN above L's diagonal changes nothing, bit for bit."""
    rng = np.random.RandomState(140)
    L = np.linalg.cholesky(_chol_spd(rng, 2, 75))
    B = rng.randn(2, 75, 55)
    L_nan = L + np.triu(np.full((75, 75), np.nan), 1)
    for nr in (1, 55):
        X = apply_kernel_order(L_nan, B[..., :nr])
        assert np.isfinite(X).all()
        assert np.array_equal(X, apply_kernel_order(L, B[..., :nr]))
