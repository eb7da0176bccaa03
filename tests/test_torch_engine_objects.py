"""Port parity: one physics substep and one 15-substep control step with the
scene objects, kinpoly_tpu_torch against kinpoly_tpu (solver "ltdl", the
contact plan on), float64 on the CPU, on the synthetic humanoid and its
five objects, with movable objects and active-set compaction (16, 8) as
the AR scripts build them; the other two configurations (static objects
posed per control step, and movable objects with split object-floor rows
and no compaction) run in ``test_torch_engine_objects_static.py`` and
``test_torch_engine_objects_movable.py`` with this file's helpers (each
configuration's two JAX compiles take ~45 s). Three cases run as envs of
one batch: push (the box on the right hand), drop (the box falling onto
the floor beside the humanoid) and sit (the chair's seat under the
pelvis)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.config import defaults as jdefaults
from kinpoly_tpu.physics import engine as jeng
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config import defaults as tdefaults
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.physics import engine as teng
from kinpoly_tpu_torch.physics import fk as tfk

from test_torch_objects import jax_spec

torch.set_num_threads(1)

TOL = 1e-7                   # physics state, as tests/test_torch_engine.py
BASE_ROT = np.asarray([0.7071, 0.7071, 0.0, 0.0], np.float32)
CASES = ("push", "drop", "sit")
CONFIGS = {"static": dict(),
           "movable": dict(movable_objects=True),
           "merged": dict(movable_objects=True, split_of=False),
           "compact": dict(movable_objects=True, compact_k=(16, 8))}
BOX, CHAIR = 1, 0


def _lowest(spec, st, qpos, body):
    """(N, 3) the lowest contact candidate of `body` per env."""
    verts, vbody = teng.ct.select_contact_vertices(
        spec, per_body=teng.ct.FOOT_BODIES, default_k=4)
    v = torch.tensor(verts[vbody == body])
    res = tfk.fk(st, torch.tensor(qpos))
    w = res.xpos[:, body, None] + tmath.quat_rot_vec(res.xquat[:, body, None], v)
    return w[torch.arange(w.shape[0]), w[..., 2].argmin(-1)].numpy()


def make_batch(spec, st, seed=0, per_case=2):
    """Humanoid and object states of per_case envs per case (CASES order),
    an action and expert pose per env."""
    rng = np.random.RandomState(seed)
    n = per_case * len(CASES)
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], n, axis=0)
    qpos[:, 7:] += rng.uniform(-0.1, 0.1, (n, 69))
    qpos[:, 2] -= 0.005
    qvel = rng.normal(0, 0.3, (n, 75))
    obj = np.zeros((n, 5, 7))
    obj[:, :, 0] = (np.arange(5) + 1) * 100.0
    obj[:, :, 1] = 100.0
    obj[:, :, 2] = [0.38, 0.22, 0.79, 0.69, 0.37]      # parked, at rest
    obj[:, :, 3] = 1.0
    objv = np.zeros((n, 5, 6))
    hand = _lowest(spec, st, qpos, spec.body_index("R_Hand"))
    pelvis = _lowest(spec, st, qpos, 0)
    for i in range(n):
        case = CASES[i // per_case]
        if case == "push":                 # box top 5 mm above the hand
            obj[i, BOX, :3] = hand[i] + [0, 0, -0.02 + 0.005]
            objv[i, BOX] = rng.normal(0, 0.2, 6)
        elif case == "drop":               # 1.5 cm above the floor, falling
            obj[i, BOX, :3] = [qpos[i, 0] + 0.6, qpos[i, 1], 0.22 + 0.015]
            objv[i, BOX, :3] = [0.2, 0.0, -1.0]
            objv[i, BOX, 3:] = rng.normal(0, 1.0, 3)
        else:                              # the seat top 5 mm into the pelvis
            obj[i, CHAIR, :3] = pelvis[i] + [0, 0, -0.02 + 0.005]
    action = rng.normal(0, 0.3, (n, 75))
    target = qpos[:, 7:] + rng.uniform(-0.05, 0.05, (n, 69))
    return qpos, qvel, obj, objv, action, target


def run_config(config: str, steps=("substep", "control_step")) -> dict:
    """Both packages' `steps` of one configuration on the batch: {name:
    (jax state, torch state)}."""
    kw = CONFIGS[config]
    movable = "movable_objects" in kw
    spec = sp.synthetic_spec(0, with_objects=True)
    jspec = jax_spec(spec)
    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec),
                          solver="ltdl", with_objects=True, **kw)
    tm = teng.build_model(spec, tdefaults.uhc_control_params(spec),
                          device="cpu", dtype=torch.float64,
                          with_objects=True, **kw)
    qpos, qvel, obj, objv, action, target = make_batch(spec, tm.st)
    if movable:
        jstate = jeng.SimState(*map(jnp.asarray, (qpos, qvel, obj, objv)))
        tstate = teng.SimState(*map(torch.tensor, (qpos, qvel, obj, objv)))
        jobj = tobj = None
    else:
        jstate = jeng.SimState(jnp.asarray(qpos), jnp.asarray(qvel))
        tstate = teng.SimState(torch.tensor(qpos), torch.tensor(qvel))
        jobj, tobj = jnp.asarray(obj), torch.tensor(obj)
    base_rot = jnp.asarray(BASE_ROT)

    def jsub(s, a, tg, o):
        plan = jeng.build_contact_plan(jm, s.qpos, s.obj_qpos if movable else o)
        return jeng.substep(jm, s, a[:69], a[69:], tg, base_rot, obj_qpos=o,
                            plan=plan)

    def jctl(s, a, tg, o):
        return jeng.control_step(jm, s, a, tg, base_rot, obj_qpos=o)

    axes = (0, 0, 0, 0 if jobj is not None else None)
    args = (jnp.asarray(action), jnp.asarray(target), jobj)
    a, tg = torch.tensor(action), torch.tensor(target)
    plan = teng.build_contact_plan(
        tm, tstate.qpos, tstate.obj_qpos if movable else tobj)
    torch_fns = dict(
        substep=lambda: teng.substep(tm, tstate, a[:, :69], a[:, 69:], tg,
                                     torch.tensor(BASE_ROT), plan, tobj),
        control_step=lambda: teng.control_step(
            tm, tstate, a, tg, torch.tensor(BASE_ROT), obj_qpos=tobj))
    jax_fns = dict(substep=jsub, control_step=jctl)
    return {name: (jax.jit(jax.vmap(jax_fns[name], in_axes=axes))(jstate, *args),
                   torch_fns[name]()) for name in steps}


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


def check_case(out: dict, config: str, step: str, case: str) -> None:
    """Humanoid (and movable object) state of the case's envs within TOL."""
    js, ts = out[step]
    rows = slice(2 * CASES.index(case), 2 * CASES.index(case) + 2)
    for f in ("qpos", "qvel") + (("obj_qpos", "obj_qvel")
                                 if config != "static" else ()):
        _close(getattr(js, f)[rows], getattr(ts, f)[rows])
    if config == "static":
        assert ts.obj_qpos is None


@pytest.fixture(scope="module")
def runs():
    return run_config("compact")


@pytest.mark.parametrize("step", ["substep", "control_step"])
@pytest.mark.parametrize("case", CASES)
def test_compact_step_matches_jax(runs, step, case):
    check_case(runs, "compact", step, case)


def test_cases_touch():
    """The push and sit envs start with an active humanoid-object contact,
    the drop envs with none."""
    spec = sp.synthetic_spec(0, with_objects=True)
    tm = teng.build_model(spec, tdefaults.uhc_control_params(spec),
                          device="cpu", dtype=torch.float64, with_objects=True)
    qpos, _, obj, _, _, _ = make_batch(spec, tm.st)
    world = teng._cand_world(tm, tfk.fk(tm.st, torch.tensor(qpos)))
    cs = teng.ct.object_contacts(tm.scene, torch.tensor(obj), world,
                                 tm.cand_body, tm.object_top_k)
    touch = cs.active.any(dim=-1).numpy()
    assert touch.tolist() == [True, True, False, False, True, True]


def test_compact_rows_ties():
    """Compaction ranks by (active, depth) with jax.lax.top_k's order on
    ties: parked objects resting at equal heights tie exactly."""
    rng = np.random.RandomState(3)
    n, nb, nob = 2, 6, 4
    J = rng.normal(size=(n, 3 * nb, 5))
    depth = np.round(rng.uniform(-0.01, 0.01, (n, nb + nob)), 3)
    depth[:, nb:] = 0.001                           # exact object-floor ties
    depth[:, 1] = depth[:, 4]
    active = depth > 0
    friction = rng.uniform(0, 1, (n, nb + nob))
    row_live = rng.rand(3 * (nb + nob)) > 0.3
    Jo = rng.normal(size=(n, 3 * (nb + nob), 6))
    obj_rows = rng.randint(-1, 5, (n, 3 * (nb + nob)))
    outj = jeng._compact_rows((4, 3), *map(jnp.asarray, (
        J, depth, active, friction, row_live, Jo, obj_rows)))
    outt = teng._compact_rows((4, 3), *map(torch.tensor, (
        J, depth, active, friction, row_live, Jo, obj_rows)))
    for a, b in zip(outj, outt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
