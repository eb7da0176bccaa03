"""Port parity: one physics substep and one 15-substep control step of
kinpoly_tpu_torch against kinpoly_tpu (solver "ltdl", contacts and the
contact plan on), float64 on the CPU, on the synthetic humanoid: a
standing-like batch and a fast-falling impact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.anim import mjcf
from kinpoly_tpu.config import defaults as jdefaults
from kinpoly_tpu.physics import engine as jeng
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config import defaults as tdefaults
from kinpoly_tpu_torch.physics import engine as teng

TOL = 1e-7
BASE_ROT = np.asarray([0.7071, 0.7071, 0.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def models():
    spec = sp.synthetic_spec(0)
    jspec = mjcf.HumanoidSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec),
                          solver="ltdl")
    tm = teng.build_model(spec, tdefaults.uhc_control_params(spec),
                          device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(tm.cand_verts.numpy(), jm.cand_verts)
    np.testing.assert_array_equal(tm.cand_body.numpy(), jm.cand_body)
    return spec, jm, tm


def _case(spec, kind: str, seed: int = 0, n: int = 3):
    rng = np.random.RandomState(seed)
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], n, axis=0)
    qpos[:, 7:] += rng.uniform(-0.15, 0.15, (n, 69))
    qvel = rng.normal(0, 0.5, (n, 75))
    if kind == "impact":
        # dropped from 3 cm above contact at 4 m/s: feet cross the floor
        # within the control step
        qpos[:, 2] += 0.03
        qvel[:, :3] = [0.3, -0.2, -4.0]
    else:
        qpos[:, 2] -= 0.01          # feet 1 cm in the floor
    action = rng.normal(0, 0.3, (n, 75))
    target = qpos[:, 7:] + rng.uniform(-0.05, 0.05, (n, 69))
    return qpos, qvel, action, target


def _jax_state(qpos, qvel):
    return jeng.SimState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))


def _torch_state(qpos, qvel):
    return teng.SimState(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err < tol, err


@pytest.mark.parametrize("kind", ["stand", "impact"])
def test_substep_matches_jax(models, kind):
    spec, jm, tm = models
    qpos, qvel, action, target = _case(spec, kind)
    ctrl = action[:, :69]
    vf = action[:, 69:]
    jplan = jeng.build_contact_plan(jm, jnp.asarray(qpos))
    tplan = teng.build_contact_plan(tm, torch.tensor(qpos))
    np.testing.assert_array_equal(tplan.floor_idx.numpy(), jplan.floor_idx)
    np.testing.assert_array_equal(tplan.lim_idx.numpy(), jplan.lim_idx)
    # one jitted program: eager JAX compiles every primitive on its own
    sj = jax.jit(lambda *a: jeng.substep(jm, *a[:5], plan=a[5]))(
        _jax_state(qpos, qvel), jnp.asarray(ctrl), jnp.asarray(vf),
        jnp.asarray(target), jnp.asarray(BASE_ROT), jplan)
    st = teng.substep(tm, _torch_state(qpos, qvel), torch.tensor(ctrl),
                      torch.tensor(vf), torch.tensor(target),
                      torch.tensor(BASE_ROT).double(), plan=tplan)
    _close(st.qvel.numpy(), sj.qvel)
    _close(st.qpos.numpy(), sj.qpos)
    assert float(np.abs(np.asarray(sj.qvel) - qvel).max()) > 1e-3


@pytest.mark.parametrize("kind", ["stand", "impact"])
def test_control_step_matches_jax(models, kind):
    spec, jm, tm = models
    qpos, qvel, action, target = _case(spec, kind, seed=1)
    sj = jeng.control_step(jm, _jax_state(qpos, qvel), jnp.asarray(action),
                           jnp.asarray(target), jnp.asarray(BASE_ROT))
    st = teng.control_step(tm, _torch_state(qpos, qvel), torch.tensor(action),
                           torch.tensor(target), torch.tensor(BASE_ROT).double())
    _close(st.qvel.numpy(), sj.qvel)
    _close(st.qpos.numpy(), sj.qpos)
    if kind == "impact":
        # the floor stopped the fall
        assert float(np.asarray(sj.qvel)[:, 2].max()) > -3.0


@pytest.mark.parametrize("kind", ["stand", "impact"])
def test_control_step_unplanned_matches_jax(models, kind):
    """plan_contacts=False: every substep ranks every floor candidate and
    every joint limit (floor_contacts / joint_limit_contacts)."""
    spec, jm, tm = models
    jm = dataclasses.replace(jm, plan_contacts=False)
    tm = dataclasses.replace(tm, plan_contacts=False)
    qpos, qvel, action, target = _case(spec, kind, seed=2)
    sj = jeng.control_step(jm, _jax_state(qpos, qvel), jnp.asarray(action),
                           jnp.asarray(target), jnp.asarray(BASE_ROT))
    st = teng.control_step(tm, _torch_state(qpos, qvel), torch.tensor(action),
                           torch.tensor(target), torch.tensor(BASE_ROT).double())
    _close(st.qvel.numpy(), sj.qvel)
    _close(st.qpos.numpy(), sj.qpos)
    if kind == "impact":
        assert float(np.asarray(sj.qvel)[:, 2].max()) > -3.0


@pytest.fixture(scope="module")
def dense_models(models):
    """The dense solver: JAX's XLA Cholesky against the port's K4a route
    (``use_pallas_chol``, the plain version on the CPU) and its PyTorch
    Cholesky route; the same function in all three."""
    spec, jm, tm = models
    jm = dataclasses.replace(jm, solver="dense")
    tms = {"k4a": dataclasses.replace(tm, solver="dense", use_pallas_chol=True),
           "torch": dataclasses.replace(tm, solver="dense")}
    return spec, jm, tms


@pytest.mark.parametrize("kind", ["stand", "impact"])
def test_dense_substep_matches_jax(dense_models, kind):
    spec, jm, tms = dense_models
    qpos, qvel, action, target = _case(spec, kind, seed=3)
    jplan = jeng.build_contact_plan(jm, jnp.asarray(qpos))
    sj = jax.jit(lambda *a: jeng.substep(jm, *a[:5], plan=a[5]))(
        _jax_state(qpos, qvel), jnp.asarray(action[:, :69]),
        jnp.asarray(action[:, 69:]), jnp.asarray(target),
        jnp.asarray(BASE_ROT), jplan)
    for tm in tms.values():
        st = teng.substep(tm, _torch_state(qpos, qvel),
                          torch.tensor(action[:, :69]),
                          torch.tensor(action[:, 69:]), torch.tensor(target),
                          torch.tensor(BASE_ROT).double(),
                          plan=teng.build_contact_plan(tm, torch.tensor(qpos)))
        _close(st.qvel.numpy(), sj.qvel)
        _close(st.qpos.numpy(), sj.qpos)


def test_dense_control_step_matches_jax(dense_models):
    spec, jm, tms = dense_models
    qpos, qvel, action, target = _case(spec, "impact", seed=4)
    sj = jeng.control_step(jm, _jax_state(qpos, qvel), jnp.asarray(action),
                           jnp.asarray(target), jnp.asarray(BASE_ROT))
    st = teng.control_step(tms["k4a"], _torch_state(qpos, qvel),
                           torch.tensor(action), torch.tensor(target),
                           torch.tensor(BASE_ROT).double())
    _close(st.qvel.numpy(), sj.qvel)
    _close(st.qpos.numpy(), sj.qpos)


def test_build_model_solver_names():
    spec = sp.synthetic_spec(0)
    ctrl = tdefaults.uhc_control_params(spec)
    build = lambda **kw: teng.build_model(spec, ctrl, device="cpu", **kw)
    assert build(use_pallas_chol=True).solver == "dense"
    assert build(solver="pallas_ltdl").solver == "ltdl"
    assert build().solver == "ltdl"
    with pytest.raises(ValueError):
        build(solver="qr")
