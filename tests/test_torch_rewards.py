"""Port parity of the UHC reward family, observation v2 and the head and
root-height terminations against kinpoly_tpu, float64 on the CPU.

Every UHC reward id runs on the same seeded numpy inputs on both sides;
the env-level tests step both envs on the synthetic humanoid from the same
states, also with explicit residual forces and meta-PD under both
``*_explicit`` rewards."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.anim import mjcf
from kinpoly_tpu.config import config as jconfig
from kinpoly_tpu.config import defaults as jdefaults
from kinpoly_tpu.data import expert as jexpert
from kinpoly_tpu.envs import humanoid_im as jenv_mod
from kinpoly_tpu.physics import engine as jeng
from kinpoly_tpu.rl import rewards as jrw
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import UHCConfig, uhc_control_params
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, make_bank
from kinpoly_tpu_torch.physics import engine as teng
from kinpoly_tpu_torch.rl import rewards as trw
from kinpoly_tpu_torch.scripts.eval_uhc import make_clips

# many tiny torch ops: one intra-op thread per process keeps several test
# workers from oversubscribing the CPU
torch.set_num_threads(1)

REWARD_TOL = 1e-10   # the same float64 inputs through both formulas
STEP_TOL = 1e-8      # reward after one control step of float64 physics
ENV_TOL = 1e-7       # obs and state after one control step, as elsewhere
IDS = sorted(set(trw.UHC_REWARDS) | set(trw.LEGACY_IMITATION_REWARDS))


def test_reward_ids_cover_the_jax_registry():
    jax_ids = set(jrw.UHC_REWARDS) | set(jrw.LEGACY_IMITATION_REWARDS)
    assert set(IDS) == jax_ids
    assert trw.NEEDS_LOCAL_IDS == jrw.NEEDS_LOCAL_IDS
    for rid in jax_ids:
        assert callable(trw.get_uhc_reward(rid))
    with pytest.raises(KeyError, match="unknown"):
        trw.get_uhc_reward("no_such_reward")


def _quats(rng, n, k):
    q = rng.normal(0, 1, (n, k, 4))
    q[..., 0] += 2.0        # near identity, as body quats of a tracked pose
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(n, 4 * k)


def _reward_inputs(seed, n=6):
    """Seeded numpy inputs for every RewardInputs field of the port; the
    expert side near the simulated one, as in tracking."""
    rng = np.random.RandomState(seed)
    sim = dict(bquat=_quats(rng, n, 24), wbquat=_quats(rng, n, 24),
               wbpos=rng.normal(0, 0.5, (n, 72)),
               body_com=rng.normal(0, 0.5, (n, 72)),
               com=rng.normal(0, 0.5, (n, 3)), ee_wpos=rng.normal(0, 0.5, (n, 15)),
               bangvel=rng.normal(0, 2, (n, 72)),
               head_pose=np.concatenate([rng.normal(0, 1, (n, 3)),
                                         _quats(rng, n, 1)], -1),
               qpos=np.concatenate([rng.normal(0, 1, (n, 3)), _quats(rng, n, 1),
                                    rng.normal(0, 0.3, (n, 69))], -1),
               rq_rmh=_quats(rng, n, 1), rlinv=rng.normal(0, 1, (n, 3)),
               rlinv_local=rng.normal(0, 1, (n, 3)),
               rangv=rng.normal(0, 1, (n, 3)), ee_pos=rng.normal(0, 0.5, (n, 15)))
    out = dict(sim)
    for k, v in sim.items():
        if k == "head_pose":
            continue
        e = v + rng.normal(0, 0.05, v.shape)
        if k in ("bquat", "wbquat", "rq_rmh"):
            e = e.reshape(n, -1, 4)
            e = (e / np.linalg.norm(e, axis=-1, keepdims=True)).reshape(n, -1)
        if k == "qpos":
            e[:, 3:7] /= np.linalg.norm(e[:, 3:7], axis=-1, keepdims=True)
        out[f"e_{k}"] = e
    out.update(vf=rng.normal(0, 0.5, (n, 6)),
               vf_cp=rng.normal(0, 0.1, (n, 24, 3)),
               vf_force=rng.normal(0, 0.1, (n, 24, 6)),
               b_diffw=rng.uniform(0, 1, 23), jpos_diffw=rng.uniform(0, 1, 24))
    assert set(out) == set(trw.RewardInputs._fields)
    return out


@pytest.mark.parametrize("reward_id", IDS)
def test_reward_matches_jax(reward_id):
    inp = _reward_inputs(seed=len(reward_id))
    ws = {f.name: getattr(cfg, f.name) for cfg in [UHCConfig().env_config()]
          for f in dataclasses.fields(cfg)}
    jr, jc = jrw.get_uhc_reward(reward_id)(
        jrw.RewardInputs(**{k: jnp.asarray(v) for k, v in inp.items()}), ws)
    tr, tc = trw.get_uhc_reward(reward_id)(
        trw.RewardInputs(**{k: torch.tensor(v) for k, v in inp.items()}), ws)
    assert tr.dtype == torch.float64 and tr.shape == (6,)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=REWARD_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=REWARD_TOL)
    assert float(tr.std()) > 0          # the inputs reach every env's reward


# -- the env with the other rewards, observation v2, head/root termination


@pytest.fixture(scope="module")
def world():
    spec = sp.synthetic_spec(0)
    jspec = mjcf.HumanoidSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    takes = make_clips(spec, 3, 5, seed=11)
    for t in takes:
        t[:, 2] += 0.5      # in the air: a lowered env falls without contact
    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec),
                          solver="ltdl")
    jbank = jexpert.stack_bank([jexpert.from_qpos(
        jspec, t.astype(np.float64), dt=jm.control_dt) for t in takes])
    tm = teng.build_model(spec, uhc_control_params(spec), device="cpu",
                          dtype=torch.float64)
    q0, v0 = sp.standing_pose(spec)
    return dict(jm=jm, jbank=jbank, tm=tm, tbank=make_bank(spec, tm, takes),
                q0=q0, v0=v0, jcfg=jconfig.UHCConfig("uhc", "results"))


@pytest.fixture(scope="module")
def explicit_world(world):
    """`world` with explicit residual forces on every body and meta-PD
    (a 315-wide action), residual forces clipped at uhc.yml's limit."""
    spec = sp.synthetic_spec(0)
    jspec = mjcf.HumanoidSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    kw = dict(rfc_mode="explicit", meta_pd=True, rfc_lim=100.0)
    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec, **kw),
                          solver="ltdl")
    tm = teng.build_model(spec, uhc_control_params(spec, **kw), device="cpu",
                          dtype=torch.float64)
    takes = [t.astype(np.float64) for t in make_clips(spec, 3, 5, seed=11)]
    for t in takes:
        t[:, 2] += 0.5
    return dict(world, jm=jm, tm=tm, tbank=make_bank(spec, tm, takes),
                jbank=jexpert.stack_bank([jexpert.from_qpos(
                    jspec, t, dt=jm.control_dt) for t in takes]))


def _step_both(w, drop=0.0, **cfg_kw):
    """Reset 3 envs on their clips, lower env 0 by `drop`, one control step
    of a seeded action of the env's width on both sides."""
    jcfg = dataclasses.replace(w["jcfg"].env_config(), **cfg_kw)
    tcfg = dataclasses.replace(UHCConfig().env_config(), **cfg_kw)
    jenv = jenv_mod.HumanoidImEnv(w["jm"], jcfg, w["jbank"], w["q0"], w["v0"],
                                  mode="test")
    tenv = HumanoidImEnv(w["tm"], tcfg, w["tbank"], mode="test")
    n = 3
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    js, jobs = jax.vmap(lambda k, i: jenv.reset(k, i, deterministic=True))(
        keys, jnp.arange(n))
    ts, tobs = tenv.reset(torch.arange(n))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0, atol=ENV_TOL)
    lowered = np.asarray(js.sim.qpos).copy()
    lowered[0, 2] -= drop
    js = js._replace(sim=js.sim._replace(qpos=jnp.asarray(lowered)))
    ts = ts._replace(sim=ts.sim._replace(qpos=torch.tensor(lowered)))
    assert tenv.action_dim == jenv.action_dim
    action = np.random.RandomState(3).normal(0, 0.3, (n, tenv.action_dim))
    jout = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(action))
    tout = tenv.step(ts, torch.tensor(action))
    return tobs, jout, tout


def test_step_quat_v2_matches_jax(world):
    _, (js2, jobs2, jr, jd, jinfo), (ts2, tobs2, tr, td, tinfo) = _step_both(
        world, reward_id="quat_v2")
    np.testing.assert_allclose(ts2.sim.qpos.numpy(), np.asarray(js2.sim.qpos),
                               rtol=0, atol=ENV_TOL)
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=0, atol=ENV_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=STEP_TOL)
    assert tinfo.reward_info.shape == (3, 5)
    np.testing.assert_allclose(tinfo.reward_info.numpy(),
                               np.asarray(jinfo["reward_info"]), rtol=0,
                               atol=STEP_TOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_observation_v2_matches_jax(world):
    tobs, (_, jobs2, *_), (_, tobs2, *_) = _step_both(world, obs_v=2)
    assert tobs.shape == tobs2.shape == (3, 640)
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=0, atol=ENV_TOL)


@pytest.mark.parametrize("term", ["Head", "root"])
def test_head_and_root_termination_match_jax(world, term):
    """Env 0 starts 0.15 m below its clip's lowest pelvis and head height
    and fails at once; the others track."""
    _, (_, _, _, jd, jinfo), (_, _, _, td, tinfo) = _step_both(
        world, drop=0.15, env_term_body=term)
    np.testing.assert_array_equal(tinfo.fail.numpy(), np.asarray(jinfo["fail"]))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tinfo.fail.tolist() == [True, False, False]


@pytest.mark.parametrize("reward_id", ["world_rfc_explicit", "local_rfc_explicit"])
def test_step_explicit_meta_pd_matches_jax(explicit_world, reward_id):
    """One env step with a 315-wide action: explicit residual forces on
    every body, per-substep PD gains, and the explicit reward's vf and cp
    terms."""
    _, (js2, jobs2, jr, jd, jinfo), (ts2, tobs2, tr, td, tinfo) = _step_both(
        explicit_world, reward_id=reward_id, w_cp=0.1, k_cp=10.0)
    np.testing.assert_allclose(ts2.sim.qpos.numpy(), np.asarray(js2.sim.qpos),
                               rtol=0, atol=ENV_TOL)
    np.testing.assert_allclose(ts2.sim.qvel.numpy(), np.asarray(js2.sim.qvel),
                               rtol=0, atol=ENV_TOL)
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=0, atol=ENV_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=STEP_TOL)
    assert tinfo.reward_info.shape == (3, 6 if reward_id.startswith("world") else 7)
    np.testing.assert_allclose(tinfo.reward_info.numpy(),
                               np.asarray(jinfo["reward_info"]), rtol=0,
                               atol=STEP_TOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the cp and vf terms are live: neither saturates at 0 or 1
    assert 0.0 < float(tinfo.reward_info[:, -1].min()) < 1.0
