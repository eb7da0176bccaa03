"""Port parity: the plain LTDL solve of kinpoly_tpu_torch (kernel K2's plain
version) against kinpoly_tpu's Pallas solve kernel in interpret mode,
float64 on the CPU, on the synthetic humanoid, at both widths the UHC env
solves: one right-hand side (the stable-PD solve) and 55 (the fused
[tau - C, J^T] solve: 1 + 3 x 18 columns)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kinpoly_tpu.physics.pallas_ltdl as pltdl
from kinpoly_tpu.anim import mjcf
from kinpoly_tpu.physics import dynamics as jdyn
from kinpoly_tpu.physics import ltdl as jltdl
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.physics import dynamics as tdyn
from kinpoly_tpu_torch.physics import ltdl as tltdl

TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def small_tiles():
    old = (pltdl.FACTOR_TILE, pltdl.SOLVE_TILE, pltdl.RHS_CHUNK)
    pltdl.FACTOR_TILE, pltdl.SOLVE_TILE, pltdl.RHS_CHUNK = 8, 8, 32
    yield
    pltdl.FACTOR_TILE, pltdl.SOLVE_TILE, pltdl.RHS_CHUNK = old


def solve_case(n_rhs: int, seed: int):
    """(port solution, Pallas solution) of M x = b at random poses."""
    spec = sp.synthetic_spec(0)
    jspec = mjcf.HumanoidSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    q0, _ = sp.standing_pose(spec)
    rng = np.random.RandomState(seed)
    n = 4
    qpos = np.repeat(q0[None], n, axis=0)
    qpos[:, 7:] += rng.uniform(-0.6, 0.6, (n, 69))
    tj = jdyn.build_tables(jspec)
    topo_j = jltdl.build_topo(tj.dof_parent)
    st = sp.spec_tensors(spec, torch.float64, "cpu")
    tt = tdyn.build_tables(spec, torch.float64, "cpu")
    topo_t = tltdl.build_topo(tt.dof_parent, torch.float64, "cpu")
    kj = jdyn.kin_state(jspec, tj, jnp.asarray(qpos))
    Rf_j = jltdl.factor(topo_j, jltdl.crba_packed(jspec, tj, topo_j, kj,
                                                  via_dense=False))
    B = rng.normal(size=(n, 75, n_rhs))
    X_k = jnp.moveaxis(pltdl.ltdl_solve_pallas(
        topo_j, jnp.moveaxis(Rf_j, 0, -1), jnp.moveaxis(jnp.asarray(B), 0, -1),
        interpret=True), -1, 0)
    X_t = tltdl.solve(topo_t, torch.tensor(np.asarray(Rf_j)), torch.tensor(B))
    return X_t.numpy(), np.asarray(X_k)


@pytest.mark.parametrize("n_rhs,seed", [(1, 11), (55, 12)])
def test_solve_matches_pallas_kernel(n_rhs, seed):
    X_t, X_k = solve_case(n_rhs, seed)
    assert X_t.shape == X_k.shape
    assert float(np.abs(X_t - X_k).max()) < TOL
