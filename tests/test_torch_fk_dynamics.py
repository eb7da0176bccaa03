"""Port parity: kinematics and rigid-body dynamics of kinpoly_tpu_torch
against kinpoly_tpu, float64 on the CPU, on the synthetic SMPL humanoid."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.anim import mjcf
from kinpoly_tpu.physics import dynamics as jdyn
from kinpoly_tpu.physics import fk as jfk
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.physics import dynamics as tdyn
from kinpoly_tpu_torch.physics import fk as tfk

FK_TOL = 1e-10      # stated in the port's plan: FK to 1e-10
DYN_TOL = 1e-9      # mass matrix and bias force to 1e-9


@pytest.fixture(scope="module")
def setup():
    spec = sp.synthetic_spec(0)
    jspec = mjcf.HumanoidSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    q0, _ = sp.standing_pose(spec)
    rng = np.random.RandomState(3)
    n = 6
    qpos = np.repeat(q0[None], n, axis=0)
    qpos[:, :3] += rng.normal(0, 0.2, (n, 3))
    qpos[:, 3:7] += rng.normal(0, 0.3, (n, 4))       # unnormalised on purpose
    qpos[:, 7:] += rng.uniform(-1.0, 1.0, (n, 69))
    qvel = rng.normal(0, 2.0, (n, 75))
    st = sp.spec_tensors(spec, torch.float64, "cpu")
    return spec, jspec, st, qpos, qvel


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err < tol, err


def test_synthetic_spec_shape():
    spec = sp.synthetic_spec(0)
    assert spec.body_names == tuple(mjcf.SMPL_BONE_NAMES)
    assert (spec.nq, spec.nv) == (76, 75)
    assert abs(spec.body_mass.sum() - 70.0) < 1e-9
    assert spec.jnt_range.shape == (69, 2)
    assert spec.timestep == pytest.approx(1.0 / 450.0)
    q0, v0 = sp.standing_pose(spec)
    assert q0.shape == (76,) and v0.shape == (75,)


def test_fk_matches_jax(setup):
    _, jspec, st, qpos, _ = setup
    rt = tfk.fk(st, torch.tensor(qpos))
    rj = jfk.fk(jspec, jnp.asarray(qpos))
    for a, b in zip(rt, rj):
        _close(a.numpy(), b, FK_TOL)
    _close(tfk.body_quat_sim(torch.tensor(qpos)).numpy(),
           jfk.body_quat_sim(jspec, jnp.asarray(qpos)), FK_TOL)
    _close(tfk.com(st, rt).numpy(), jfk.com(jspec, rj), FK_TOL)


def test_dof_frames_match_jax(setup):
    _, jspec, st, qpos, _ = setup
    tq = torch.tensor(qpos)
    dt = tfk.dof_frames(st, tq, tfk.fk(st, tq))
    jq = jnp.asarray(qpos)
    dj = jfk.dof_frames(jspec, jq, jfk.fk(jspec, jq))
    _close(dt.axis.numpy(), dj.axis, FK_TOL)
    _close(dt.anchor.numpy(), dj.anchor, FK_TOL)


def test_mass_matrix_and_bias_match_jax(setup):
    spec, jspec, st, qpos, qvel = setup
    tt = tdyn.build_tables(spec, torch.float64, "cpu")
    tj = jdyn.build_tables(jspec)
    np.testing.assert_array_equal(tt.dof_parent, tj.dof_parent)
    kt = tdyn.kin_state(st, torch.tensor(qpos))
    kj = jdyn.kin_state(jspec, tj, jnp.asarray(qpos))
    _close(kt.phi.numpy(), kj.phi, DYN_TOL)
    _close(tdyn.mass_matrix(st, tt, kt).numpy(),
           jdyn.mass_matrix(jspec, tj, kj), DYN_TOL)
    _close(tdyn.bias_force(tt, kt, torch.tensor(qvel)).numpy(),
           jdyn.bias_force(jspec, tj, kj, jnp.asarray(qvel)), DYN_TOL)
