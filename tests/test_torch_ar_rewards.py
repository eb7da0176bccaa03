"""Port parity: the kin-poly rewards and the AR env in mode "train",
kinpoly_tpu_torch against kinpoly_tpu, float64 on the CPU:
``dynamic_supervision_v2``-``_v6`` and ``constant`` on the same random
inputs (the config's weights and the functions' defaults), the registry's
errors, and one AR env step in mode "train" (the controller's actions
sampled at log-std -30, so that the two packages' draws differ by about
1e-13; the ground-truth termination at a tight threshold) whose every
reward id is then computed by both envs from the step's own state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.physics import fk as jfk
from kinpoly_tpu.rl import rewards as jrw
from kinpoly_tpu_torch.config.defaults import KinPolyConfig
from kinpoly_tpu_torch.physics import fk as tfk
from kinpoly_tpu_torch.rl import rewards as trw

from test_torch_env_ar import OBS_TOL, STATE_TOL, build_envs

torch.set_num_threads(1)

TOL = 1e-10          # the reward formulas alone, float64
IDS = ("dynamic_supervision_v2", "dynamic_supervision_v3",
       "dynamic_supervision_v4", "dynamic_supervision_v5",
       "dynamic_supervision_v6", "constant")
GT_THRESH = 0.6      # summed body distance to the ground truth (m)


def _close(a, b, tol):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b)
        return
    assert float(np.abs(a - b).max()) <= tol


def _quats(rng, n, k):
    q = rng.normal(size=(n, k, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(n, 4 * k)


def _inputs(seed=0, n=6):
    rng = np.random.RandomState(seed)
    hp = np.concatenate([rng.normal(size=(n, 3)), _quats(rng, n, 1)], -1)
    thp = hp + np.concatenate([rng.normal(0, 0.1, (n, 3)),
                               rng.normal(0, 0.05, (n, 4))], -1)
    thp[:, 3:] /= np.linalg.norm(thp[:, 3:], axis=-1, keepdims=True)
    q = rng.normal(0, 0.3, (n, 76))
    q[:, 3:7] = _quats(rng, n, 1)
    return dict(
        head_pose=hp, tgt_head_pose=thp, bquat=_quats(rng, n, 24),
        wbpos=rng.normal(size=(n, 72)), tgt_bquat=_quats(rng, n, 24),
        tgt_wbpos=rng.normal(size=(n, 72)), gt_bquat=_quats(rng, n, 24),
        gt_prev_bquat=_quats(rng, n, 24), gt_wbpos=rng.normal(size=(n, 72)),
        gt_bangvel=rng.normal(size=(n, 72)), bangvel=rng.normal(size=(n, 72)),
        b_diffw=rng.uniform(0.5, 2.0, 23), tgt_qpos=q,
        ar_qpos=q + rng.normal(0, 0.05, q.shape),
        ar_bquat=_quats(rng, n, 24), ar_prev_bquat=_quats(rng, n, 24),
        prev_bquat=_quats(rng, n, 24))


@pytest.mark.parametrize("rid", IDS)
@pytest.mark.parametrize("weights", ["kin_poly", "defaults", "v_ord_1"])
def test_kin_poly_reward_formulas(rid, weights):
    """Each reward and its components on the same inputs."""
    raw = _inputs(seed=IDS.index(rid))
    ws = dict(v_ord=1, k_act_v=0.3) if weights == "v_ord_1" else (
        {} if weights == "defaults" else dataclasses.asdict(
            KinPolyConfig().reward_weights()))
    dt = 1.0 / 30
    rj, cj = jrw.get_kin_poly_reward(rid)(
        jrw.ARRewardInputs(**{k: jnp.asarray(v) for k, v in raw.items()}), ws, dt)
    rt, ct = trw.get_kin_poly_reward(rid)(
        trw.ARRewardInputs(**{k: torch.tensor(v) for k, v in raw.items()}), ws, dt)
    _close(rj, rt, TOL)
    _close(cj, ct, TOL)
    assert float(rt.min()) >= 0.0


@pytest.mark.parametrize("rid", ["quat_v2", "deep_mimic", "nonexistent",
                                 "dynamic_supervision_v1"])
def test_kin_poly_registry_errors(rid):
    """The same KeyError, message included; the fine-tune ids resolve in
    both registries, to the port's fine_tune functions, which give the
    JAX functions' results (tests/test_torch_fine_tune.py)."""
    from test_torch_fine_tune import fine_tune_inputs

    with pytest.raises(KeyError) as ej:
        jrw.get_kin_poly_reward(rid)
    with pytest.raises(KeyError) as et:
        trw.get_kin_poly_reward(rid)
    assert str(ej.value) == str(et.value)
    assert sorted(trw.KIN_POLY_REWARDS) == sorted(jrw.KIN_POLY_REWARDS)
    assert sorted(trw.FINE_TUNE_REWARDS) == sorted(jrw.FINE_TUNE_REWARDS)
    jin, tin = fine_tune_inputs(np.random.RandomState(4), 8, perfect=False)
    for ft in trw.FINE_TUNE_REWARDS:
        assert trw.get_kin_poly_reward(ft) is trw.FINE_TUNE_REWARDS[ft]
        rj, cj = jrw.get_kin_poly_reward(ft)(jin, {}, 1.0 / 30)
        rt, ct = trw.get_kin_poly_reward(ft)(tin, {}, 1.0 / 30)
        _close(rj, rt, TOL)
        _close(cj, ct, TOL)


@pytest.fixture(scope="module")
def stepped():
    """One env step in mode "train" from the reset of one env per take,
    in both packages, under the port policy's mean action."""
    e = build_envs(mode="train", reward_id="dynamic_supervision_v6",
                   body_diff_gt_thresh=GT_THRESH, cc_log_std=-30.0)
    keys = jax.random.split(jax.random.PRNGKey(3), e.n)
    js, jobs = jax.jit(jax.vmap(lambda k, i: e.jenv.reset(k, i)))(
        keys, jnp.arange(e.n, dtype=jnp.int32))
    ts, tobs = e.tenv.reset(torch.arange(e.n))
    with torch.no_grad():
        a = e.tp.action_mean(e.tp.init_carry(e.n, tobs), tobs)[1]
        e.jout = jax.jit(jax.vmap(e.jenv.step))(js, jnp.asarray(a.numpy()))
        e.tout = e.tenv.step(ts, a, generator=torch.Generator().manual_seed(0))
    e.js, e.ts, e.action = js, ts, a
    return e


def test_train_step(stepped):
    """State, observation, the v6 reward and its components, the sampled
    controller action, and the ground-truth termination."""
    e = stepped
    (js, jobs, jr, jd, jinfo), (ts, tobs, tr, td, tinfo) = e.jout, e.tout
    for f in ("qpos", "qvel", "obj_qpos", "obj_qvel"):
        _close(getattr(js.sim, f), getattr(ts.sim, f), STATE_TOL)
    _close(jobs, tobs, OBS_TOL)
    _close(jr, tr, OBS_TOL)
    _close(jinfo["reward_info"], tinfo.reward_info, OBS_TOL)
    assert tinfo.reward_info.shape == (e.n, 5)
    _close(jinfo["cc_action"], tinfo.cc_action, OBS_TOL)
    for f in ("fail", "end"):
        _close(jinfo[f], getattr(tinfo, f), 0)
    _close(jd, td, 0)
    # the ground-truth distance failed some env, and wild turns it off
    assert bool(tinfo.fail.any())
    e.tenv.wild = True
    with torch.no_grad():
        wild = e.tenv.step(e.ts, e.action,
                           generator=torch.Generator().manual_seed(0))[4]
    e.tenv.wild = False
    assert int(wild.fail.sum()) < int(tinfo.fail.sum())
    # the controller's action is a sample: noise at log-std -30
    with torch.no_grad():
        cc_mean = e.tenv.cc_policy(tinfo.cc_state)[0]
    diff = float((tinfo.cc_action - cc_mean).abs().max())
    assert 0.0 < diff < 1e-11


@pytest.mark.parametrize("rid", IDS + ("dynamic_supervision_v1",))
def test_reward_dispatch_after_step(stepped, rid):
    """Every reward id from both envs' own reward inputs (sim, AR target,
    ground truth and AR rollout at the new frame) after the step."""
    e = stepped
    jnew, tnew = e.jout[0], e.tout[0]
    jenv, tenv = e.jenv, e.tenv
    jrw_old, trw_old, tfn_old = jenv.rw, tenv.rw, tenv.reward_fn
    jenv.rw = dataclasses.replace(jenv.rw, reward_id=rid)
    tenv.rw = dataclasses.replace(tenv.rw, reward_id=rid)
    tenv.reward_fn = (None if rid == "dynamic_supervision_v1"
                      else trw.get_kin_poly_reward(rid))
    try:
        def jreward(state, new):
            fk_cur = jfk.fk(e.jspec, new.sim.qpos)
            target, _ = jenv.target_frame(new.target_qpos)
            return jenv._reward(
                state, new.sim, fk_cur, jfk.body_quat_sim(e.jspec, new.sim.qpos),
                state.prev_bquat, state.prev_hpos,
                jfk.body_quat_sim(e.jspec, new.target_qpos), target, None,
                new.cur_t)
        rj, cj = jax.jit(jax.vmap(jreward))(e.js, jnew)
        with torch.no_grad():
            target, _ = tenv.target_frame(tnew.target_qpos)
            rt, ct = tenv._reward(
                e.ts, tfk.fk(e.tm.st, tnew.sim.qpos),
                tfk.body_quat_sim(tnew.sim.qpos),
                tfk.body_quat_sim(tnew.target_qpos), target, None, tnew.cur_t)
    finally:
        jenv.rw, tenv.rw, tenv.reward_fn = jrw_old, trw_old, tfn_old
    _close(rj, rt, OBS_TOL)
    _close(cj, ct, OBS_TOL)
