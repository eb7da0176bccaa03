"""The port's CUDA kernels against their plain PyTorch versions on a card.

Needs an NVIDIA GPU with the CUDA toolkit (sm_90a); skips elsewhere. This
file imports neither JAX nor the JAX package, so it also runs where they
are absent:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from kinpoly_tpu_torch import native
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.physics import contact as ct
from kinpoly_tpu_torch.physics import dynamics as dyn
from kinpoly_tpu_torch.physics import chol, chol_cuda, ltdl, ltdl_cuda, pgs_cuda
from kinpoly_tpu_torch.physics import fk as fklib
from torch_trees import (random_body_tree, random_preorder_parents,
                         seeded_poses, tree_spd_packed)

LTDL_ATOL = 1e-3            # as tests/test_pallas_ltdl.py:48,60
PGS_RTOL, PGS_ATOL = 2e-4, 2e-5   # as tests/test_pallas_pgs.py:69
CHOL_TOL = 5e-3             # as tests/test_pallas_chol.py:22-47
# K5 against the plain float32 code on the card: bit for bit. The kernel
# does the plain code's float32 operations one for one and in its order
# (csrc/fk.cu), and a rounding step there can turn a contact on or off.

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def packed(cuda):
    """Packed M + Kd dt of the synthetic humanoid at 37 seeded poses (an
    env count that fills no block evenly)."""
    spec = sp.synthetic_spec(0)
    st = sp.spec_tensors(spec, torch.float32, cuda)
    tables = dyn.build_tables(spec, torch.float32, cuda)
    topo = ltdl.build_topo(tables.dof_parent, torch.float32, cuda)
    rng = np.random.RandomState(0)
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], 37, axis=0)
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (37, 69))
    ks = dyn.kin_state(st, torch.tensor(qpos, dtype=torch.float32, device=cuda))
    R = ltdl.crba_packed(st, tables, topo, ks)
    kd = torch.tensor(rng.uniform(0, 100, (37, 75)) * spec.timestep,
                      dtype=torch.float32, device=cuda)
    return topo, ltdl.add_diag(topo, R, kd).contiguous(), rng


def test_factor_kernel(packed):
    topo, R, _ = packed
    before = native.LAUNCHES["ltdl_factor"]
    Rf = ltdl_cuda.factor(topo, R)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ltdl_factor"] == before + 1
    assert float((Rf - ltdl.factor(topo, R)).abs().max()) < LTDL_ATOL


@pytest.mark.parametrize("n", [1, 3, 2048, 2049])
def test_factor_kernel_env_counts(packed, n):
    """One env, a block's worth of envs short of full, the main path's 2048
    and one more (a last block with one env)."""
    topo, R, rng = packed
    Rn = R[torch.as_tensor(rng.randint(0, R.shape[0], n), device=R.device)]
    before = native.LAUNCHES["ltdl_factor"]
    Rf = ltdl_cuda.factor(topo, Rn)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ltdl_factor"] == before + 1
    assert Rf.shape == Rn.shape
    assert float((Rf - ltdl.factor(topo, Rn)).abs().max()) < LTDL_ATOL


def test_factor_kernel_passes_nonzero_padding_through(packed):
    topo, R, rng = packed
    invalid = topo.valid == 0
    pad = torch.tensor(rng.normal(size=tuple(R.shape)), dtype=torch.float32,
                       device=R.device) * invalid
    Rp = (R + pad).contiguous()
    Rf = ltdl_cuda.factor(topo, Rp)
    torch.cuda.synchronize()
    assert float((Rf - ltdl.factor(topo, Rp)).abs().max()) < LTDL_ATOL
    assert torch.equal(Rf[..., invalid], Rp[..., invalid])
    assert float(pad[..., invalid].abs().min()) > 0


@pytest.mark.parametrize("tree", ["chain32", "random"])
def test_factor_kernel_other_trees(cuda, tree):
    """A chain of 32 dofs (the wrapper's limit, Dmax + 1 = 32) and a random
    preorder tree of 60 dofs with Dmax + 1 <= 32."""
    rng = np.random.RandomState(9)
    parents = (np.arange(32) - 1 if tree == "chain32"
               else random_preorder_parents(rng, 60, 32))
    topo = ltdl.build_topo(parents, torch.float32, cuda)
    assert topo.preorder and topo.dmax + 1 <= 32
    R = tree_spd_packed(rng, topo, 37, dtype=torch.float32,
                        device=cuda).contiguous()
    Rf = ltdl_cuda.factor(topo, R)
    torch.cuda.synchronize()
    assert float((Rf - ltdl.factor(topo, R)).abs().max()) < LTDL_ATOL


def test_factor_refuses_deep_and_out_of_preorder_trees(cuda):
    deep = ltdl.build_topo(np.arange(33) - 1, torch.float32, cuda)
    with pytest.raises(ValueError):
        ltdl_cuda.factor(deep, torch.ones(2, 33, 33, device=cuda))
    post = ltdl.build_topo(np.array([-1, 0, 0, 1]), torch.float32, cuda)
    with pytest.raises(ValueError):
        ltdl_cuda.factor(post, torch.ones(2, 4, post.dmax + 1, device=cuda))


@pytest.mark.parametrize("nr", [1, 55])
def test_solve_kernel(packed, nr):
    topo, R, rng = packed
    Rf = ltdl.factor(topo, R)
    B = torch.tensor(rng.normal(size=(R.shape[0], 75, nr)),
                     dtype=torch.float32, device=R.device)
    X = ltdl_cuda.solve(topo, Rf, B)
    torch.cuda.synchronize()
    assert float((X - ltdl.solve(topo, Rf, B)).abs().max()) < LTDL_ATOL


def test_pgs_kernel(cuda):
    rng = np.random.RandomState(1)
    n, k = 37, 18
    c = 3 * k
    J = rng.randn(n, c, 40)
    A = J @ np.swapaxes(J, -1, -2) + np.eye(c) * 0.5
    d = np.repeat(rng.uniform(0.85, 0.95, (n, k)), 3, -1)
    active = rng.rand(n, k) > 0.3
    Rr = np.where(np.repeat(active, 3, -1),
                  (1 - d) / d * np.diagonal(A, axis1=-2, axis2=-1), 1e8)
    A3 = A.reshape(n, k, 3, k, 3)
    D = np.stack([A3[:, i, :, i, :] for i in range(k)], axis=1)
    D = D + Rr.reshape(n, k, 3)[..., None] * np.eye(3) + 1e-9 * np.eye(3)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=cuda)
    args = [t(A), t(rng.randn(n, c)), t(np.linalg.inv(D)), t(Rr),
            t(np.full((n, k), 1.0)), torch.tensor(active, device=cuda)]
    f = pgs_cuda.pgs_solve(*args, iters=20)
    ref = ct.psor_plain(*args, iters=20)
    np.testing.assert_allclose(f.cpu().numpy(), ref.cpu().numpy(),
                               rtol=PGS_RTOL, atol=PGS_ATOL)


@pytest.mark.parametrize("n", [37, 1])
@pytest.mark.parametrize("nr", [1, 49, 55, 79])
def test_solve_kernel_widths(packed, nr, n):
    """The main path's widths (1, 55) and the objects slice's (49 with
    compaction, 79 without), on env counts that fill no block evenly."""
    topo, R, _ = packed
    rng = np.random.RandomState(100 + nr)
    Rf = ltdl.factor(topo, R[:n].contiguous())
    B = torch.tensor(rng.normal(size=(n, 75, nr)), dtype=torch.float32,
                     device=R.device)
    key = f"ltdl_solve[R={nr}]"
    before = native.LAUNCHES[key]
    X = ltdl_cuda.solve(topo, Rf, B)
    torch.cuda.synchronize()
    assert native.LAUNCHES[key] == before + 1
    assert float((X - ltdl.solve(topo, Rf, B)).abs().max()) < LTDL_ATOL


def _psor_args(n, k, seed, device):
    rng = np.random.RandomState(seed)
    c = 3 * k
    J = rng.randn(n, c, 40)
    A = J @ np.swapaxes(J, -1, -2) + np.eye(c) * 0.5
    d = np.repeat(rng.uniform(0.85, 0.95, (n, k)), 3, -1)
    active = rng.rand(n, k) > 0.3
    Rr = np.where(np.repeat(active, 3, -1),
                  (1 - d) / d * np.diagonal(A, axis1=-2, axis2=-1), 1e8)
    A3 = A.reshape(n, k, 3, k, 3)
    D = np.stack([A3[:, i, :, i, :] for i in range(k)], axis=1)
    D = D + Rr.reshape(n, k, 3)[..., None] * np.eye(3) + 1e-9 * np.eye(3)
    mu = np.broadcast_to(np.where(np.arange(k) < 12, 1.0, 0.0), (n, k))
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return [t(A), t(rng.randn(n, c)), t(np.linalg.inv(D)), t(Rr), t(mu),
            torch.tensor(active, device=device)]


@pytest.mark.parametrize("n", [37, 1])
@pytest.mark.parametrize("k", [18, 24, 36])
def test_pgs_kernel_sizes(cuda, k, n):
    """C = 54 (main path), 72 and 108 rows (objects slice, with and
    without compaction)."""
    args = _psor_args(n, k, 10 + k, cuda)
    before = native.LAUNCHES["pgs_solve"]
    f = pgs_cuda.pgs_solve(*args, iters=20)
    torch.cuda.synchronize()
    assert native.LAUNCHES["pgs_solve"] == before + 1
    ref = ct.psor_plain(*args, iters=20)
    assert float(ref.abs().max()) > 1e-3
    np.testing.assert_allclose(f.cpu().numpy(), ref.cpu().numpy(),
                               rtol=PGS_RTOL, atol=PGS_ATOL)


def test_kernels_at_and_past_their_shared_memory_limits(packed, cuda):
    """K2 takes 744 right-hand sides of the 75-dof tree and refuses 745;
    K3 takes 79 blocks (237 rows) and refuses 80: one env's shared memory
    against a block's 227 KB."""
    topo, R, rng = packed
    Rf = ltdl.factor(topo, R[:3].contiguous())
    B = torch.tensor(rng.normal(size=(3, 75, 744)), dtype=torch.float32,
                     device=cuda)
    X = ltdl_cuda.solve(topo, Rf, B)
    torch.cuda.synchronize()
    assert float((X - ltdl.solve(topo, Rf, B)).abs().max()) < LTDL_ATOL
    with pytest.raises(ValueError):
        ltdl_cuda.solve(topo, Rf, torch.zeros(3, 75, 745, device=cuda))
    args = _psor_args(2, 79, 7, cuda)
    f = pgs_cuda.pgs_solve(*args, iters=20)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f.cpu().numpy(),
                               ct.psor_plain(*args, iters=20).cpu().numpy(),
                               rtol=PGS_RTOL, atol=PGS_ATOL)
    with pytest.raises(ValueError):
        pgs_cuda.pgs_solve(*_psor_args(2, 80, 7, cuda), iters=20)


def test_solve_refuses_a_tree_out_of_preorder(cuda):
    topo = ltdl.build_topo(np.array([-1, 0, 0, 1]), torch.float32, cuda)
    Rf = torch.ones(2, 4, topo.dmax + 1, device=cuda)
    with pytest.raises(ValueError):
        ltdl_cuda.solve(topo, Rf, torch.ones(2, 4, 3, device=cuda))


def test_wrappers_reject_what_the_kernels_do_not_take(packed):
    topo, R, _ = packed
    with pytest.raises(ValueError):
        ltdl_cuda.factor(topo, R.double())
    with pytest.raises(ValueError):
        ltdl_cuda.factor(topo, R[::2])
    with pytest.raises(ValueError):
        ltdl_cuda.solve(topo, R, torch.zeros(3, 75, 1, device=R.device))


@pytest.fixture(scope="module")
def spd(cuda):
    """37 SPD systems built as tests/test_pallas_chol.py builds them."""
    rng = np.random.RandomState(5)
    J = rng.randn(37, 75, 83)
    A = J @ np.swapaxes(J, -1, -2) + np.eye(75) * 7.5
    return torch.tensor(A, dtype=torch.float32, device=cuda), rng


@pytest.mark.parametrize("nr", [1, 55])
def test_chol_solve_only_kernel(spd, nr):
    A, rng = spd
    B = torch.tensor(rng.normal(size=(37, 75, nr)), dtype=torch.float32,
                     device=A.device)
    key = f"chol_solve_only[R={nr}]"
    before = native.LAUNCHES[key]
    X = chol_cuda.solve_only(A, B)
    torch.cuda.synchronize()
    assert native.LAUNCHES[key] == before + 1
    assert float((X - chol.solve_only(A, B)).abs().max()) < CHOL_TOL
    ref = np.linalg.solve(A.double().cpu().numpy(), B.double().cpu().numpy())
    np.testing.assert_allclose(X.cpu().numpy(), ref, rtol=CHOL_TOL, atol=CHOL_TOL)


def test_chol_factor_solve_and_apply_kernels(spd):
    A, rng = spd
    B = torch.tensor(rng.normal(size=(37, 75, 55)), dtype=torch.float32,
                     device=A.device)
    # only the lower triangle is read
    A_u = A + torch.triu(torch.full_like(A, 1e3), 1)
    L, X = chol_cuda.factor_solve(A_u, B)
    L_p, X_p = chol.factor_solve(A, B)
    torch.cuda.synchronize()
    assert float((L - L_p).abs().max()) < CHOL_TOL
    assert not torch.triu(L, 1).any()
    assert float((X - X_p).abs().max()) < CHOL_TOL
    X2 = chol_cuda.apply(L_p + torch.triu(torch.ones_like(L_p), 1), B)
    assert float((X2 - chol.apply(L_p, B)).abs().max()) < CHOL_TOL


def test_chol_not_spd_gives_nan(spd):
    A, _ = spd
    A = A[:2].clone()
    A[1, 10, 10] = -1.0
    X = chol_cuda.solve_only(A, torch.ones(2, 75, 1, device=A.device))
    assert torch.isfinite(X[0]).all() and torch.isnan(X[1]).any()


def test_chol_wrappers_reject_what_the_kernels_do_not_take(spd):
    A, _ = spd
    B = torch.zeros(37, 75, 1, device=A.device)
    # 722 right-hand sides: the first width past K4a's 227 KB
    for bad in ((A.double(), B.double()), (A[::2], B[::2]),
                (A, torch.zeros(36, 75, 1, device=A.device)),
                (A, torch.zeros(37, 75, 722, device=A.device)),
                (A.transpose(-1, -2), B), (A, B.cpu())):
        with pytest.raises(ValueError):
            chol_cuda.solve_only(*bad)
    with pytest.raises(ValueError):
        chol_cuda.apply(A[..., :74], B)
    # K4c's limit is K4a's, the real 227 KB: R = 100 is taken (past the
    # default 48 KB), and 722, the first width past 227 KB, is refused
    assert chol_cuda.solve_smem_bytes(75, 100) <= chol_cuda.SMEM_MAX
    assert chol_cuda.solve_smem_bytes(75, 721) <= chol_cuda.SMEM_MAX
    with pytest.raises(ValueError):
        chol_cuda.apply(A, torch.zeros(37, 75, 722, device=A.device))


def _chol_gate(X, A, B, plain):
    """Within CHOL_TOL of the plain float32 version and within the JAX
    test's allclose(rtol = atol = CHOL_TOL) of float64."""
    assert float((X - plain).abs().max()) < CHOL_TOL
    ref = np.linalg.solve(A.double().cpu().numpy(), B.double().cpu().numpy())
    np.testing.assert_allclose(X.cpu().numpy(), ref, rtol=CHOL_TOL, atol=CHOL_TOL)


@pytest.mark.parametrize("n", [1, 3, 2048, 2049])
def test_chol_kernels_env_counts(spd, n):
    """One env, three, the main path's 2048 and one more: K4a and K4c at
    R = 1 and 55, K4b at 55 (one block per env)."""
    A37, rng = spd
    A = A37[torch.as_tensor(rng.randint(0, 37, n), device=A37.device)]
    for nr in (1, 55):
        B = torch.tensor(rng.normal(size=(n, 75, nr)), dtype=torch.float32,
                         device=A.device)
        key = f"chol_solve_only[R={nr}]"
        before = native.LAUNCHES[key]
        X = chol_cuda.solve_only(A, B)
        torch.cuda.synchronize()
        assert native.LAUNCHES[key] == before + 1
        _chol_gate(X, A, B, chol.solve_only(A, B))
        L = chol.factor(A)
        key = f"chol_apply[R={nr}]"
        before = native.LAUNCHES[key]
        X = chol_cuda.apply(L, B)
        torch.cuda.synchronize()
        assert native.LAUNCHES[key] == before + 1
        _chol_gate(X, A, B, chol.apply(L, B))
    before = native.LAUNCHES["chol_factor_solve[R=55]"]
    L, X = chol_cuda.factor_solve(A, B)
    torch.cuda.synchronize()
    assert native.LAUNCHES["chol_factor_solve[R=55]"] == before + 1
    L_p, X_p = chol.factor_solve(A, B)
    assert float((L - L_p).abs().max()) < CHOL_TOL
    _chol_gate(X, A, B, X_p)


@pytest.mark.parametrize("nr", [1, 2, 55, 56, 79, 100])
def test_chol_kernels_widths(spd, nr):
    """The main path's widths (1, 55), two, the widths past 55 of one more
    column and of the objects slice (79), and 100 (past the default 48 KB
    of shared memory); K4c on the plain version's factor."""
    A, rng = spd
    B = torch.tensor(rng.normal(size=(37, 75, nr)), dtype=torch.float32,
                     device=A.device)
    X = chol_cuda.solve_only(A, B)
    L, X2 = chol_cuda.factor_solve(A, B)
    L_p = chol.factor(A)
    X3 = chol_cuda.apply(L_p, B)
    torch.cuda.synchronize()
    _chol_gate(X, A, B, chol.solve_only(A, B))
    _chol_gate(X2, A, B, chol.solve_only(A, B))
    assert float((L - L_p).abs().max()) < CHOL_TOL
    _chol_gate(X3, A, B, chol.apply(L_p, B))


@pytest.mark.parametrize("n", [1, 5, 8, 40, 72, 73, 74, 76])
def test_chol_apply_other_sizes(cuda, n):
    """K4c at other sizes, with 0-3 padding rows and folds of other
    lengths, at R = 1, 2 and 55."""
    rng = np.random.RandomState(90 + n)
    J = rng.randn(3, n, n + 8)
    A64 = J @ np.swapaxes(J, -1, -2) + np.eye(n) * (n * 0.1)
    A = torch.tensor(A64, dtype=torch.float32, device=cuda)
    L = chol.factor(A)
    for nr in (1, 2, 55):
        B = torch.tensor(rng.normal(size=(3, n, nr)), dtype=torch.float32,
                         device=cuda)
        X = chol_cuda.apply(L, B)
        torch.cuda.synchronize()
        _chol_gate(X, A, B, chol.apply(L, B))


def test_chol_kernels_ignore_the_upper_triangle(spd):
    """NaN above the diagonal of A (or of L, for K4c) changes nothing, bit
    for bit, and L comes out exactly zero above the diagonal."""
    A, rng = spd
    B = torch.tensor(rng.normal(size=(37, 75, 55)), dtype=torch.float32,
                     device=A.device)
    A_nan = A + torch.triu(torch.full_like(A, float("nan")), 1)
    for nr in (1, 55):
        Bn = B[..., :nr].contiguous()
        assert torch.equal(chol_cuda.solve_only(A_nan, Bn),
                           chol_cuda.solve_only(A, Bn))
    L, X = chol_cuda.factor_solve(A_nan, B)
    L0, X0 = chol_cuda.factor_solve(A, B)
    torch.cuda.synchronize()
    assert torch.equal(L, L0) and torch.equal(X, X0)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert bool((torch.diagonal(L, dim1=-2, dim2=-1) > 0).all())
    L_nan = L + torch.triu(torch.full_like(L, float("nan")), 1)
    for nr in (1, 55):
        Bn = B[..., :nr].contiguous()
        X_nan = chol_cuda.apply(L_nan, Bn)
        assert torch.isfinite(X_nan).all()
        assert torch.equal(X_nan, chol_cuda.apply(L, Bn))


def test_chol_apply_zero_pivot_gives_non_finite(spd):
    """A zero on L's diagonal gives non-finite X in that env only, as the
    plain version's division does."""
    A, _ = spd
    L = chol.factor(A[:2])
    L[1, 10, 10] = 0.0
    for nr in (1, 55):
        B = torch.ones(2, 75, nr, device=A.device)
        X = chol_cuda.apply(L, B)
        assert torch.isfinite(X[0]).all() and not torch.isfinite(X[1]).all()
        assert not torch.isfinite(chol.apply(L, B)[1]).all()


def test_chol_kernels_at_their_shared_memory_limit(spd):
    """K4a, K4b and K4c take 721 right-hand sides of a 75 x 75 system (one
    env's rows within a block's 227 KB)."""
    A, rng = spd
    A = A[:3].contiguous()
    B = torch.tensor(rng.normal(size=(3, 75, 721)), dtype=torch.float32,
                     device=A.device)
    X = chol_cuda.solve_only(A, B)
    L, X2 = chol_cuda.factor_solve(A, B)
    X3 = chol_cuda.apply(L, B)
    torch.cuda.synchronize()
    _chol_gate(X, A, B, chol.solve_only(A, B))
    assert torch.equal(X, X2)
    _chol_gate(X3, A, B, chol.apply(L, B))


def _fk_case(st, qpos, frames):
    """K5 once (one launch, counted) and the plain code on the card."""
    key = "fk_tree[frames]" if frames else "fk_tree"
    before = native.LAUNCHES[key]
    got = fklib.fk_frames(st, qpos) if frames else (fklib.fk(st, qpos), None)
    torch.cuda.synchronize()
    assert native.LAUNCHES[key] == before + 1
    plain = fklib._fk_plain(st, qpos)
    ref = tuple(plain) + (tuple(fklib.dof_frames(st, qpos, plain))
                          if frames else ())
    for g, r in zip(tuple(got[0]) + (tuple(got[1]) if frames else ()), ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert torch.equal(g, r), float((g - r).abs().max())
    return got


@pytest.mark.parametrize("frames", [False, True])
@pytest.mark.parametrize("n", [1, 31, 1024, 4097])
def test_fk_kernel_env_counts(cuda, n, frames):
    """One env, a block short of full, the cell's 1024 and a last block
    with one env; unnormalised roots, hinge angles up to +-4 pi."""
    st = sp.spec_tensors(sp.synthetic_spec(0), torch.float32, cuda)
    q = seeded_poses(np.random.RandomState(n), n, 24)
    _fk_case(st, torch.tensor(q, dtype=torch.float32, device=cuda), frames)


@pytest.mark.parametrize("frames", [False, True])
def test_fk_kernel_leading_dims_and_strides(cuda, frames):
    """A (T, N) leading shape comes back as (T, N, ...); a non-contiguous
    pose gives the outputs of its contiguous copy, which the wrapper
    makes (the plain code's sums over a strided quaternion add in another
    order, so there only its contiguous copy is the reference)."""
    st = sp.spec_tensors(sp.synthetic_spec(0), torch.float32, cuda)
    q = torch.tensor(seeded_poses(np.random.RandomState(11), 3 * 37, 24),
                     dtype=torch.float32, device=cuda).reshape(3, 37, 76)
    got = _fk_case(st, q, frames)
    assert got[0].xpos.shape == (3, 37, 24, 3)
    strided = q.reshape(-1, 76).t().contiguous().t()
    assert not strided.is_contiguous()
    again = (fklib.fk_frames(st, strided) if frames
             else (fklib.fk(st, strided), None))
    for a, b in zip(tuple(got[0]) + (tuple(got[1]) if frames else ()),
                    tuple(again[0]) + (tuple(again[1]) if frames else ())):
        assert torch.equal(a.reshape(b.shape), b)


@pytest.mark.parametrize("frames", [False, True])
@pytest.mark.parametrize("n_body,max_depth,seed",
                         [(32, 32, 1), (32, 6, 2), (17, 4, 3), (2, 2, 4), (1, 1, 5)])
def test_fk_kernel_other_trees(cuda, n_body, max_depth, seed, frames):
    rng = np.random.RandomState(seed)
    st = random_body_tree(rng, n_body, max_depth, torch.float32, cuda)
    q = torch.tensor(seeded_poses(rng, 97, n_body), dtype=torch.float32,
                     device=cuda)
    _fk_case(st, q, frames)


def test_fk_kernel_refuses_what_it_cannot_take(cuda):
    rng = np.random.RandomState(6)
    big = random_body_tree(rng, 33, 8, torch.float32, cuda)
    q = torch.zeros(4, 7 + 3 * 32, device=cuda)
    with pytest.raises(ValueError, match="33 bodies"):
        fklib.fk(big, q)
    st = random_body_tree(rng, 4, 4, torch.float32, cuda)._replace(
        parents=(-1, 0, 3, 1))
    with pytest.raises(ValueError, match="preorder"):
        fklib.fk_frames(st, torch.zeros(4, 16, device=cuda))
    st = sp.spec_tensors(sp.synthetic_spec(0), torch.float32, cuda)
    with pytest.raises(ValueError, match="float32"):
        fklib.fk(st, torch.zeros(4, 76, device=cuda, dtype=torch.float64))


def test_fk_with_a_gradient_takes_the_plain_code(cuda):
    """Under grad, a pose that requires one launches nothing and
    back-propagates; under no_grad the same pose launches K5."""
    st = sp.spec_tensors(sp.synthetic_spec(0), torch.float32, cuda)
    q = torch.tensor(seeded_poses(np.random.RandomState(12), 8, 24),
                     dtype=torch.float32, device=cuda, requires_grad=True)
    before = dict(native.LAUNCHES)
    res, df = fklib.fk_frames(st, q)
    (fklib.fk(st, q).xipos.sum() + res.xpos.sum() + df.axis.sum()).backward()
    torch.cuda.synchronize()
    assert dict(native.LAUNCHES) == before
    assert bool(torch.isfinite(q.grad).all()) and float(q.grad.abs().max()) > 0
    with torch.no_grad():
        fklib.fk(st, q)
    assert native.LAUNCHES["fk_tree"] == before.get("fk_tree", 0) + 1


def _chip_smoke():
    """The repo root's chip_smoke.py as a module (its helpers)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ar_control_step_on_the_card(cuda):
    """One control step of the AR env's physics (five movable objects,
    contact plan, compaction (16, 8)) on the card: 30 K1, 15 K2 at R = 1,
    15 K2 at R = 49 and 15 K3 launches, and K5 once for the contact plan
    and once with the frames in each substep; humanoid and object state within
    1e-3 of the CPU float64 plain path, with the box resting on each
    env's right hand."""
    from kinpoly_tpu_torch.config.defaults import uhc_control_params
    from kinpoly_tpu_torch.physics import engine as eng

    spec = sp.synthetic_spec(0, with_objects=True)
    kw = dict(with_objects=True, movable_objects=True, compact_k=(16, 8))
    card = eng.build_model(spec, uhc_control_params(spec), device=cuda, **kw)
    cpu = eng.build_model(spec, uhc_control_params(spec), device="cpu",
                          dtype=torch.float64, **kw)
    rng = np.random.RandomState(9)
    n = 8
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], n, axis=0)
    qpos[:, 7:] += rng.uniform(-0.05, 0.05, (n, 69))
    qvel = rng.normal(0, 0.3, (n, 75))
    obj = np.zeros((n, 5, 7))
    obj[:, :, 0] = (np.arange(5) + 1) * 100.0
    obj[:, :, 1] = 100.0
    obj[:, :, 2] = [0.38, 0.22, 0.79, 0.69, 0.37]
    obj[:, :, 3] = 1.0
    obj[:, 1, :3] = _chip_smoke().box_on_hand(cpu, torch.tensor(qpos)).numpy()
    action = rng.normal(0, 0.2, (n, 75))
    outs = []
    for m in (card, cpu):
        t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=m.device)
        state = eng.SimState(t(qpos), t(qvel), t(obj), t(np.zeros((n, 5, 6))))
        native.LAUNCHES.clear()
        s = eng.control_step(m, state, t(action), t(qpos[:, 7:]),
                             t(np.asarray([0.7071, 0.7071, 0.0, 0.0])))
        if m is card:
            torch.cuda.synchronize()
            assert dict(native.LAUNCHES) == {
                "ltdl_factor": 30, "ltdl_solve[R=1]": 15,
                "ltdl_solve[R=49]": 15, "pgs_solve": 15,
                "fk_tree": 1, "fk_tree[frames]": 15}
        outs.append([x.double().cpu() for x in s])
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    assert all(bool(torch.isfinite(x).all()) for x in outs[0])
    assert err < 1e-3, err
