"""Port parity: the plain LTDL factor/solve of kinpoly_tpu_torch (kernels
K1/K2's plain versions) against kinpoly_tpu's jnp path and its Pallas
factor kernel in interpret mode, float64 on the CPU, on the synthetic
humanoid. The CUDA kernels are held to these plain versions in
tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import dataclasses

import jax
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
from kinpoly_tpu_torch.physics import ltdl_cuda

TOL = 1e-9          # f64 parity of the plain versions


@pytest.fixture(scope="module", autouse=True)
def small_tiles():
    old = (pltdl.FACTOR_TILE, pltdl.SOLVE_TILE, pltdl.RHS_CHUNK)
    pltdl.FACTOR_TILE, pltdl.SOLVE_TILE, pltdl.RHS_CHUNK = 8, 8, 32
    yield
    pltdl.FACTOR_TILE, pltdl.SOLVE_TILE, pltdl.RHS_CHUNK = old


@pytest.fixture(scope="module")
def setup():
    spec = sp.synthetic_spec(0)
    jspec = mjcf.HumanoidSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    q0, _ = sp.standing_pose(spec)
    rng = np.random.RandomState(5)
    n = 6
    qpos = np.repeat(q0[None], n, axis=0)
    qpos[:, 7:] += rng.uniform(-0.6, 0.6, (n, 69))
    st = sp.spec_tensors(spec, torch.float64, "cpu")
    tt = tdyn.build_tables(spec, torch.float64, "cpu")
    tj = jdyn.build_tables(jspec)
    topo_t = tltdl.build_topo(tt.dof_parent, torch.float64, "cpu")
    topo_j = jltdl.build_topo(tj.dof_parent)
    kt = tdyn.kin_state(st, torch.tensor(qpos))
    kj = jdyn.kin_state(jspec, tj, jnp.asarray(qpos))
    R_t = tltdl.crba_packed(st, tt, topo_t, kt)
    R_j = jltdl.crba_packed(jspec, tj, topo_j, kj, via_dense=False)
    M_t = tdyn.mass_matrix(st, tt, kt)
    # the stable-PD system M + Kd dt, as the engine factors it
    kd = torch.tensor(rng.uniform(0, 100, (n, 75)) * spec.timestep)
    A_t = tltdl.add_diag(topo_t, R_t, kd)
    A_j = jltdl.add_diag(topo_j, R_j, jnp.asarray(kd.numpy()))
    # jitted: eager JAX compiles each level's ops one by one
    return dict(topo_t=topo_t, topo_j=topo_j, R_t=R_t, R_j=R_j, M_t=M_t,
                A_t=A_t, A_j=A_j, rng=rng, n=n,
                jfactor=jax.jit(lambda R: jltdl.factor(topo_j, R)),
                jsolve=jax.jit(lambda Rf, B: jltdl.solve(topo_j, Rf, B)))


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err < tol, err


def test_topology(setup):
    t, j = setup["topo_t"], setup["topo_j"]
    np.testing.assert_array_equal(t.anc_idx, j.anc_idx)
    np.testing.assert_array_equal(t.depth, j.depth)
    assert (t.nv, t.dmax) == (75, 29)


def test_pack_unpack_crba(setup):
    s = setup
    _close(s["R_t"].numpy(), s["R_j"], TOL)
    _close(tltdl.pack(s["topo_t"], s["M_t"]).numpy(), s["R_t"].numpy(), TOL)
    _close(tltdl.unpack(s["topo_t"], s["R_t"]).numpy(), s["M_t"].numpy(), TOL)


@pytest.mark.parametrize("which", ["M", "A"])
def test_factor_matches_jax(setup, which):
    s = setup
    Rt, Rj = (s["R_t"], s["R_j"]) if which == "M" else (s["A_t"], s["A_j"])
    Rf_t = tltdl.factor(s["topo_t"], Rt)
    _close(Rf_t.numpy(), s["jfactor"](Rj), TOL)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(ltdl_cuda.factor(s["topo_t"], Rt).numpy(),
                                  Rf_t.numpy())


def test_factor_matches_pallas_kernel(setup):
    """Both systems the engine factors (M and M + Kd dt), in one
    interpret-mode call of the Pallas kernel (lowering it takes ~1 min)."""
    s = setup
    Rt = torch.cat([s["R_t"], s["A_t"]])
    Rj = jnp.concatenate([s["R_j"], s["A_j"]])
    Rf_k = jnp.moveaxis(pltdl.ltdl_factor_pallas(
        s["topo_j"], jnp.moveaxis(Rj, 0, -1), interpret=True), -1, 0)
    _close(tltdl.factor(s["topo_t"], Rt).numpy(), Rf_k, TOL)


@pytest.mark.parametrize("nr", [1, 55])
def test_solve_matches_jax(setup, nr):
    s = setup
    B = s["rng"].normal(size=(s["n"], 75, nr))
    Rf_t = tltdl.factor(s["topo_t"], s["R_t"])
    Rf_j = s["jfactor"](s["R_j"])
    X_t = tltdl.solve(s["topo_t"], Rf_t, torch.tensor(B))
    _close(X_t.numpy(), s["jsolve"](Rf_j, jnp.asarray(B)), TOL)
    # and it solves M x = b
    _close((s["M_t"] @ X_t).numpy(), B, 1e-8)
    np.testing.assert_array_equal(
        ltdl_cuda.solve(s["topo_t"], Rf_t, torch.tensor(B)).numpy(), X_t.numpy())
