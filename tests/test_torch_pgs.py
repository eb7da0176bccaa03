"""Port parity: the plain block-PSOR of kinpoly_tpu_torch (kernel K3's plain
version) against kinpoly_tpu's Pallas PSOR kernel in interpret mode, at the
UHC env's sizes (C = 54 rows, K = 18 blocks, 20 sweeps). The CUDA kernel
is held to the plain version in tests/test_torch_kernels_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.physics.pallas_pgs import pgs_solve_pallas
from kinpoly_tpu_torch.physics import contact as tct
from kinpoly_tpu_torch.physics import pgs_cuda

N, K, ITERS = 5, 18, 20
RTOL, ATOL = 2e-4, 2e-5     # f32, as tests/test_pallas_pgs.py:69
F64_TOL = 1e-9


def _system(seed: int, dtype):
    """An SPD Delassus system J M^-1 J^T + R with the engine's
    regularisation, some inactive blocks and limit-like frictionless
    blocks (mu = 0)."""
    rng = np.random.RandomState(seed)
    C = 3 * K
    J = rng.randn(N, C, 40)
    A = J @ np.swapaxes(J, -1, -2) + np.eye(C) * 0.5
    rhs = rng.randn(N, C)
    d = rng.uniform(0.85, 0.95, (N, K))
    active = rng.rand(N, K) > 0.3
    diagA = np.diagonal(A, axis1=-2, axis2=-1)
    R = (1 - np.repeat(d, 3, -1)) / np.repeat(d, 3, -1) * diagA
    R = np.where(np.repeat(active, 3, -1), R, 1e8)
    A3 = A.reshape(N, K, 3, K, 3)
    D = np.stack([A3[:, k, :, k, :] for k in range(K)], axis=1)
    D = D + R.reshape(N, K, 3)[..., None] * np.eye(3) + 1e-9 * np.eye(3)
    Dinv = np.linalg.inv(D)
    mu = np.where(np.arange(K) < 12, 1.0, 0.0)[None].repeat(N, 0)
    return [x.astype(dtype) for x in (A, rhs, Dinv, R, mu)] + [active]


@pytest.mark.parametrize("dtype,tol", [(np.float32, None), (np.float64, F64_TOL)])
def test_psor_matches_pallas(dtype, tol):
    A, rhs, Dinv, R, mu, active = _system(0, dtype)
    ref = np.asarray(pgs_solve_pallas(
        *(jnp.asarray(x) for x in (A, rhs, Dinv, R, mu, active)),
        iters=ITERS, interpret=True))
    out = tct.psor_plain(*(torch.tensor(x) for x in (A, rhs, Dinv, R, mu, active)),
                         iters=ITERS).numpy()
    assert np.abs(out).max() > 1e-3            # the system has live forces
    if tol is None:
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    else:
        assert float(np.abs(out - ref).max()) < tol
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(pgs_cuda.pgs_solve(
        *(torch.tensor(x) for x in (A, rhs, Dinv, R, mu, active)),
        iters=ITERS).numpy(), out)
