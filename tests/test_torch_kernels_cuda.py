"""The port's CUDA kernels against their plain PyTorch versions on a card.

Needs an NVIDIA GPU with the CUDA toolkit (sm_90a); skips elsewhere. This
file imports neither JAX nor the JAX package, so it also runs where they
are absent:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from kinpoly_tpu_torch import native
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.physics import contact as ct
from kinpoly_tpu_torch.physics import dynamics as dyn
from kinpoly_tpu_torch.physics import ltdl, ltdl_cuda, pgs_cuda

LTDL_ATOL = 1e-3            # as tests/test_pallas_ltdl.py:48,60
PGS_RTOL, PGS_ATOL = 2e-4, 2e-5   # as tests/test_pallas_pgs.py:69

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


def test_wrappers_reject_what_the_kernels_do_not_take(packed):
    topo, R, _ = packed
    with pytest.raises(ValueError):
        ltdl_cuda.factor(topo, R.double())
    with pytest.raises(ValueError):
        ltdl_cuda.factor(topo, R[::2])
    with pytest.raises(ValueError):
        ltdl_cuda.solve(topo, R, torch.zeros(3, 75, 1, device=R.device))
