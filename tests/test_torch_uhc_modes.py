"""Port parity of the UHC controller's remaining engine modes against
kinpoly_tpu, float64 on the CPU, on the synthetic humanoid: explicit
residual forces (``rfc_explicit``, for every body and for a subset, with
and without torques, in a substep and a control step), meta-PD gains per
substep (meta 0, -1 and above 9, where the clip binds), and the
contacts-off control step on the LTDL and dense solvers, without and with
movable objects (which then fall as free bodies)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.config import defaults as jdefaults
from kinpoly_tpu.physics import dynamics as jdyn
from kinpoly_tpu.physics import engine as jeng
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config import defaults as tdefaults
from kinpoly_tpu_torch.physics import dynamics as tdyn
from kinpoly_tpu_torch.physics import engine as teng

from test_torch_engine_objects import make_batch
from test_torch_objects import jax_spec

torch.set_num_threads(1)

TOL = 1e-7            # physics state, as tests/test_torch_engine.py
FORCE_TOL = 1e-8      # generalized forces of the same float64 kinematics
BASE_ROT = np.asarray([0.7071, 0.7071, 0.0, 0.0], np.float32)
SUBSET = ("L_Ankle", "R_Hand", "Head", "Pelvis")


def _models(ctrl_kw=None, with_objects=False, **model_kw):
    spec = sp.synthetic_spec(0, with_objects=with_objects)
    jspec = jax_spec(spec)
    ctrl_kw = ctrl_kw or {}
    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec, **ctrl_kw),
                          with_objects=with_objects, **model_kw)
    tm = teng.build_model(spec, tdefaults.uhc_control_params(spec, **ctrl_kw),
                          device="cpu", dtype=torch.float64,
                          with_objects=with_objects, **model_kw)
    assert tm.ctrl.vf_dim == jm.ctrl.vf_dim
    assert tm.ctrl.vf_bodies == jm.ctrl.vf_bodies
    return spec, jm, tm


def _case(spec, ctrl, n=3, seed=0, meta=None):
    """A standing-like batch 1 cm in the floor, a seeded action of the
    control params' width (joint targets, residual forces of |vf| up to
    ~1, meta-PD entries `meta` if given) and expert pose."""
    rng = np.random.RandomState(seed)
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], n, axis=0)
    qpos[:, 7:] += rng.uniform(-0.15, 0.15, (n, 69))
    qpos[:, 2] -= 0.01
    qvel = rng.normal(0, 0.5, (n, 75))
    parts = [rng.normal(0, 0.3, (n, 69)), rng.normal(0, 0.5, (n, ctrl.vf_dim))]
    if meta is not None:
        parts.append(np.broadcast_to(meta, (n, 30)))
    target = qpos[:, 7:] + rng.uniform(-0.05, 0.05, (n, 69))
    return qpos, qvel, np.concatenate(parts, axis=-1), target


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


@pytest.mark.parametrize("torque", [True, False])
@pytest.mark.parametrize("bodies", ["all", "subset"])
def test_rfc_explicit_matches_jax(bodies, torque):
    vb = "all" if bodies == "all" else SUBSET
    spec, jm, tm = _models(dict(rfc_mode="explicit", vf_bodies=vb,
                                residual_force_torque=torque))
    assert tm.ctrl.vf_dim == (9 if torque else 6) * (24 if bodies == "all" else 4)
    qpos, _, action, _ = _case(spec, tm.ctrl)
    vf = action[:, 69:]
    jks = jdyn.kin_state(jm.spec, jm.tables, jnp.asarray(qpos))
    tks = tdyn.kin_state(tm.st, torch.tensor(qpos))
    qj = jeng.rfc_explicit(jm, jks, jnp.asarray(vf))
    qt = teng.rfc_explicit(tm, tks, torch.tensor(vf))
    assert qt.shape == (3, 75)
    _close(qt.numpy(), qj, FORCE_TOL)
    assert float(np.abs(np.asarray(qj)).max()) > 1.0      # forces reach the dofs


@pytest.mark.parametrize("torque", [True, False])
def test_explicit_substep_matches_jax(torque):
    spec, jm, tm = _models(dict(rfc_mode="explicit", vf_bodies=SUBSET,
                                residual_force_torque=torque))
    qpos, qvel, action, target = _case(spec, tm.ctrl, seed=1)
    jplan = jeng.build_contact_plan(jm, jnp.asarray(qpos))
    sj = jax.jit(lambda s, a, t, p: jeng.substep(
        jm, s, a[:, :69], a[:, 69:], t, jnp.asarray(BASE_ROT), plan=p))(
        jeng.SimState(jnp.asarray(qpos), jnp.asarray(qvel)),
        jnp.asarray(action), jnp.asarray(target), jplan)
    st = teng.substep(tm, teng.SimState(torch.tensor(qpos), torch.tensor(qvel)),
                      torch.tensor(action[:, :69]), torch.tensor(action[:, 69:]),
                      torch.tensor(target), torch.tensor(BASE_ROT).double(),
                      teng.build_contact_plan(tm, torch.tensor(qpos)))
    _close(st.qvel.numpy(), sj.qvel)
    _close(st.qpos.numpy(), sj.qpos)


def _control_step_both(jm, tm, qpos, qvel, action, target, with_contacts=True,
                       obj=None, objv=None):
    if obj is not None:
        js = jeng.SimState(*map(jnp.asarray, (qpos, qvel, obj, objv)))
        ts = teng.SimState(*map(torch.tensor, (qpos, qvel, obj, objv)))
    else:
        js = jeng.SimState(jnp.asarray(qpos), jnp.asarray(qvel))
        ts = teng.SimState(torch.tensor(qpos), torch.tensor(qvel))
    sj = jax.jit(lambda s, a, t: jeng.control_step(
        jm, s, a, t, jnp.asarray(BASE_ROT), with_contacts=with_contacts))(
        js, jnp.asarray(action), jnp.asarray(target))
    st = teng.control_step(tm, ts, torch.tensor(action), torch.tensor(target),
                           torch.tensor(BASE_ROT).double(),
                           with_contacts=with_contacts)
    return sj, st


# meta-PD entries: 0 keeps the gains, -1 switches them off, 9.5 is clipped
# to a scale of 10, and a mix of per-substep values
META = {"zero": 0.0, "off": -1.0, "clipped": 9.5,
        "mixed": np.linspace(-1.5, 11.0, 30)}


@pytest.fixture(scope="module")
def explicit_meta():
    return _models(dict(rfc_mode="explicit", vf_bodies="all", meta_pd=True,
                        rfc_scale=100.0, rfc_lim=100.0))


@pytest.mark.parametrize("meta", list(META))
def test_explicit_meta_pd_control_step_matches_jax(explicit_meta, meta):
    spec, jm, tm = explicit_meta
    assert 69 + tm.ctrl.vf_dim + 2 * tm.n_substeps == 315
    qpos, qvel, action, target = _case(spec, tm.ctrl, seed=2, meta=META[meta])
    sj, st = _control_step_both(jm, tm, qpos, qvel, action, target)
    _close(st.qvel.numpy(), sj.qvel)
    _close(st.qpos.numpy(), sj.qpos)
    assert np.isfinite(st.qpos.numpy()).all()


def test_meta_pd_gains_change_the_step(explicit_meta):
    """meta -1 (no PD) and 9.5 (ten times the gains) move the joints
    otherwise than meta 0."""
    spec, jm, tm = explicit_meta
    out = {}
    for meta in ("zero", "off", "clipped"):
        qpos, qvel, action, target = _case(spec, tm.ctrl, seed=2, meta=META[meta])
        out[meta] = teng.control_step(
            tm, teng.SimState(torch.tensor(qpos), torch.tensor(qvel)),
            torch.tensor(action), torch.tensor(target),
            torch.tensor(BASE_ROT).double()).qpos[:, 7:]
    assert float((out["off"] - out["zero"]).abs().max()) > 1e-3
    assert float((out["clipped"] - out["zero"]).abs().max()) > 1e-3


@pytest.mark.parametrize("solver", ["ltdl", "dense"])
def test_contacts_off_control_step_matches_jax(solver):
    spec, jm, tm = _models(solver=solver)
    qpos, qvel, action, target = _case(spec, tm.ctrl, seed=3)
    sj, st = _control_step_both(jm, tm, qpos, qvel, action, target,
                                with_contacts=False)
    _close(st.qvel.numpy(), sj.qvel)
    _close(st.qpos.numpy(), sj.qpos)
    # without the floor the feet sink: the step differs from the contacted one
    on = teng.control_step(tm, teng.SimState(torch.tensor(qpos), torch.tensor(qvel)),
                           torch.tensor(action), torch.tensor(target),
                           torch.tensor(BASE_ROT).double())
    assert float((on.qpos - st.qpos).abs().max()) > 1e-3


@pytest.mark.parametrize("solver", ["ltdl", "dense"])
def test_contacts_off_movable_objects_fall_as_jax(solver):
    """Movable objects under contacts off: gravity and the gyroscopic
    term alone (the box spinning), the orientation updated by a left
    product with the world rotation."""
    spec, jm, tm = _models(with_objects=True, movable_objects=True,
                           solver=solver)
    qpos, qvel, obj, objv, action, target = make_batch(spec, tm.st)
    objv[:, :, 3:] = np.random.RandomState(4).normal(0, 2.0, objv[:, :, 3:].shape)
    sj, st = _control_step_both(jm, tm, qpos, qvel, action, target,
                                with_contacts=False, obj=obj, objv=objv)
    for f in ("qpos", "qvel", "obj_qpos", "obj_qvel"):
        _close(getattr(st, f).numpy(), getattr(sj, f))
    dt = tm.control_dt
    # free fall: v_z drops by g t, nothing holds the objects up
    np.testing.assert_allclose(st.obj_qvel[..., 2].numpy(),
                               objv[..., 2] - 9.81 * dt, rtol=0, atol=1e-9)
    assert float((st.obj_qpos[..., 3:] - torch.tensor(obj[..., 3:])).abs().max()) > 1e-3


def test_contacts_off_step_runs_no_contact_plan(monkeypatch):
    """Without contacts the control step builds no plan and no contact
    rows, on either solver."""
    spec, _, tm = _models()
    calls = []
    monkeypatch.setattr(teng, "build_contact_plan",
                        lambda *a, **k: calls.append("plan"))
    monkeypatch.setattr(teng, "_contact_accel",
                        lambda *a, **k: calls.append("contacts"))
    qpos, qvel, action, target = _case(spec, tm.ctrl, seed=5)
    out = teng.control_step(tm, teng.SimState(torch.tensor(qpos), torch.tensor(qvel)),
                            torch.tensor(action), torch.tensor(target),
                            torch.tensor(BASE_ROT).double(), with_contacts=False)
    assert calls == [] and torch.isfinite(out.qpos).all()


def test_control_params_fields_match_jax():
    """uhc_control_params with every residual-force knob, field for field."""
    spec = sp.synthetic_spec(0)
    jspec = jax_spec(spec)
    for kw in (dict(), dict(rfc_mode="explicit"),
               dict(rfc_mode="explicit", vf_bodies=SUBSET, meta_pd=True,
                    residual_force_torque=False, rfc_scale=50.0, rfc_lim=80.0)):
        jc = jdefaults.uhc_control_params(jspec, **kw)
        tc = tdefaults.uhc_control_params(spec, **kw)
        for f in dataclasses.fields(jc):
            a, b = getattr(jc, f.name), getattr(tc, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name
        assert (tc.vf_dim, tc.body_vf_dim) == (jc.vf_dim, jc.body_vf_dim)
