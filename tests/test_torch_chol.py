"""Port parity: the plain dense Cholesky routines (the oracles of kernels
K4a-c) against numpy in float64, against the JAX package's Pallas kernels
(interpret mode, as tests/test_pallas_chol.py runs them) in float32, and
the dense solver without the kernel against ``dynamics.chol_solve``."""

import numpy as np
import pytest
import torch

from kinpoly_tpu.physics import dynamics as jdyn
from kinpoly_tpu.physics import pallas_chol as jchol
from kinpoly_tpu_torch.physics import chol
from kinpoly_tpu_torch.physics import dynamics as tdyn

N = 75
F64_RTOL = 1e-9      # float64 against numpy, relative to max |x|
PALLAS_TOL = 5e-3    # the JAX kernel test's tolerance (tests/test_pallas_chol.py)


def _spd(rng, batch, n=N):
    """The SPD systems of tests/test_pallas_chol.py."""
    J = rng.randn(batch, n, n + 8)
    return J @ np.swapaxes(J, -1, -2) + np.eye(n) * (n * 0.1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("nr", [1, 55])
def test_plain_matches_numpy_f64(nr):
    rng = np.random.RandomState(nr)
    A = _spd(rng, 4)
    B = rng.randn(4, N, nr)
    X_ref = np.linalg.solve(A, B)
    L_ref = np.linalg.cholesky(A)
    # the upper triangle is never read
    A_t = torch.tensor(A + np.triu(rng.randn(4, N, N), 1) * 1e3)
    L, X = chol.factor_solve(A_t, torch.tensor(B))
    assert _rel(L.numpy(), L_ref) < F64_RTOL
    assert np.array_equal(np.triu(L.numpy(), 1), np.zeros_like(L_ref))
    assert _rel(X.numpy(), X_ref) < F64_RTOL
    assert _rel(chol.solve_only(A_t, torch.tensor(B)).numpy(), X_ref) < F64_RTOL
    L_u = torch.tensor(L_ref + np.triu(rng.randn(4, N, N), 1))
    assert _rel(chol.apply(L_u, torch.tensor(B)).numpy(), X_ref) < F64_RTOL


def test_plain_not_spd_gives_nan():
    rng = np.random.RandomState(0)
    A = _spd(rng, 2)
    A[1, 10, 10] = -1.0
    X = chol.solve_only(torch.tensor(A), torch.tensor(rng.randn(2, N, 3)))
    assert torch.isfinite(X[0]).all() and torch.isnan(X[1]).any()


@pytest.mark.parametrize("nr", [1, 55])
def test_plain_f32_matches_pallas(nr):
    """All three Pallas kernels (interpret mode) against the plain float32
    versions on the same inputs; both within the JAX test's tolerance."""
    rng = np.random.RandomState(10 + nr)
    A = _spd(rng, 3).astype(np.float32)
    B = rng.randn(3, N, nr).astype(np.float32)
    X_ref = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
    At, Bt = torch.tensor(A), torch.tensor(B)

    X_j = np.asarray(jchol.chol_solve_only(A, B, interpret=True))
    X_t = chol.solve_only(At, Bt).numpy()
    L_j, X2_j = (np.asarray(x) for x in jchol.chol_factor_solve(A, B, interpret=True))
    L_t, X2_t = (x.numpy() for x in chol.factor_solve(At, Bt))
    X3_j = np.asarray(jchol.chol_apply(L_j, B, interpret=True))
    X3_t = chol.apply(torch.tensor(L_j), Bt).numpy()

    errs = {"solve_only": np.abs(X_t - X_j).max(),
            "factor": np.abs(L_t - np.tril(L_j)).max(),
            "factor_solve": np.abs(X2_t - X2_j).max(),
            "apply": np.abs(X3_t - X3_j).max()}
    print(f"R={nr} plain f32 vs Pallas: {errs}")
    assert max(errs.values()) < PALLAS_TOL, errs
    for X in (X_t, X2_t, X3_t):
        np.testing.assert_allclose(X, X_ref, rtol=PALLAS_TOL, atol=PALLAS_TOL)


@pytest.mark.parametrize("vec", [True, False])
def test_chol_solve_matches_jax(vec):
    rng = np.random.RandomState(3)
    A = _spd(rng, 3)
    b = rng.randn(3, N) if vec else rng.randn(3, N, 7)
    x_j = np.asarray(jdyn.chol_solve(A, b))
    x_t = tdyn.chol_solve(torch.tensor(A), torch.tensor(b)).numpy()
    assert _rel(x_t, x_j) < F64_RTOL
