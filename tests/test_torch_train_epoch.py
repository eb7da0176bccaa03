"""Port parity of the whole UHC training iteration: two
``UHCAgent.train_epoch`` calls of kinpoly_tpu_torch against
kinpoly_tpu.rl.agent_uhc, float64 on the CPU, from the same start weights.

2 envs x 3 control steps on one 3-frame clip (every env ends on the last
step and is reset), narrow nets, noise rate 0 and reactive rate 0 (so
every draw is deterministic on both sides), one minibatch holding the
whole batch (so the permutation cannot matter). Both start from the same
weights and the same seeded running norm (empty stats would divide
rounding noise of 1e-18 in resting obs entries by their 1e-6 std floor,
and Adam would turn the resulting 1e-12 gradients into 1e-8 steps).
Compared: the updated weights, the running norm, the metrics, the clip
mining history.

With noise rate 0 every action is the policy's mean, so the exact policy
gradient is 0: the port's float64 rounding leaves ~1e-12 of it, which Adam
normalises into steps the size of the learning rate. The adaptive schedule
therefore sets the policy's learning rate to 0 on both sides (which also
drives ``set_policy_lr``); test_torch_train.py holds the PPO update of the
policy against JAX on explored actions."""

import dataclasses
import os

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
from kinpoly_tpu.rl import agent_uhc as jagent_mod
from kinpoly_tpu.rl import ppo as jppo
from kinpoly_tpu.rl import rollout as jro
from kinpoly_tpu.rl import running_norm as jrn
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import UHCConfig, uhc_control_params
from kinpoly_tpu_torch.data import banks
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, make_bank
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.physics import engine as teng
from kinpoly_tpu_torch.rl import agent_uhc as tagent_mod
from kinpoly_tpu_torch.rl import rollout as tro
from kinpoly_tpu_torch.rl import running_norm as trn
from kinpoly_tpu_torch.scripts.eval_uhc import make_clips

# many tiny torch ops: one intra-op thread per process keeps several test
# workers from oversubscribing the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_TOL = 1e-9    # weights after 2 x 2 Adam steps, float64
METRIC_TOL = 1e-9
NORM_TOL = 1e-10    # running norm after two Chan merges of env obs
CFG = dict(n_envs=2, rollout_steps=3, num_optim_epoch=2, mini_batch_size=64,
           num_primitive=2, policy_hsize=(16, 8), value_hsize=(16, 8),
           noise_rate=0.0, seed=3)


def _agents(takes):
    """The JAX and the port agent on an env over `takes` (equal lengths),
    from the same start weights and running norm."""
    spec = sp.synthetic_spec(0)
    jspec = mjcf.HumanoidSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    q0, v0 = sp.standing_pose(spec)

    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec),
                          solver="ltdl")
    jbank = jexpert.stack_bank([jexpert.from_qpos(
        jspec, take.astype(np.float64), dt=jm.control_dt) for take in takes])
    jcfg = dataclasses.replace(jconfig.UHCConfig("uhc", "results").env_config(),
                               reactive_rate=0.0)
    jenv = jenv_mod.HumanoidImEnv(jm, jcfg, jbank, q0, v0, mode="train")
    jagent = jagent_mod.UHCAgent(jenv, jagent_mod.UHCTrainConfig(**CFG))
    f64 = lambda t: jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), t)
    pp, vp = (f64(jagent.train_state.policy_params),
              f64(jagent.train_state.value_params))
    jagent.train_state = jppo.TrainState(pp, vp, jagent.policy_opt.init(pp),
                                         jagent.value_opt.init(vp))

    tm = teng.build_model(spec, uhc_control_params(spec), device="cpu",
                          dtype=torch.float64)
    tcfg = dataclasses.replace(UHCConfig().env_config(), reactive_rate=0.0)
    tenv = HumanoidImEnv(tm, tcfg, make_bank(spec, tm, takes), q0, v0,
                         mode="train")
    tagent = tagent_mod.UHCAgent(tenv, tagent_mod.UHCTrainConfig(**CFG))
    tagent.policy.load_state_dict(weights.policy_state_dict(jax.device_get(pp)))
    tagent.value.load_state_dict(weights.value_state_dict(jax.device_get(vp)))
    rng = np.random.RandomState(7)
    norm = (np.float32(50.0), rng.normal(0, 0.5, 784).astype(np.float32),
            rng.uniform(10, 60, 784).astype(np.float32))
    jagent.norm = jrn.RunningNorm(*map(jnp.asarray, norm))
    tagent.norm = trn.RunningNorm(*map(torch.tensor, norm))
    return jagent, tagent


@pytest.fixture(scope="module")
def agents():
    return _agents(make_clips(sp.synthetic_spec(0), 1, 3, seed=9))


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol, err


def _check_epochs(jagent, tagent, n):
    """`n` train_epoch calls on both sides agree after each."""
    adaptive = dict(noise_rate=0.0, policy_lr=0.0)
    for _ in range(n):
        jm = jagent.train_epoch(adaptive=adaptive)
        tm = tagent.train_epoch(adaptive=adaptive)
        for k, v in jm.items():
            if k != "T_iter":
                _close(tm[k], v, METRIC_TOL)
        for got, want in ((weights.policy_params(tagent.policy.state_dict()),
                           jagent.train_state.policy_params),
                          (weights.value_params(tagent.value.state_dict()),
                           jagent.train_state.value_params)):
            assert jax.tree.structure(got) == jax.tree.structure(want)
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                _close(g, w, PARAM_TOL)
        assert float(tagent.norm.count) == float(jagent.norm.count)
        assert tagent.norm.count.dtype == torch.float32
        _close(tagent.norm.mean.numpy(), jagent.norm.mean, NORM_TOL)
        _close(tagent.norm.m2.numpy() / float(tagent.norm.count),
               np.asarray(jagent.norm.m2) / float(jagent.norm.count), NORM_TOL)
        _close(tagent.success_ewma, jagent.success_ewma, 1e-12)
        np.testing.assert_array_equal(tagent.seen, jagent.seen)
    return tm


def test_train_epoch_matches_jax(agents):
    jagent, tagent = agents
    start = [p.detach().clone() for p in tagent.value.parameters()]
    tm = _check_epochs(jagent, tagent, 2)
    assert tagent.epoch == jagent.epoch == 2
    assert tm["episode_done"] == 2.0 and tagent.seen.all()
    assert max(float((p.detach() - s).abs().max())
               for p, s in zip(tagent.value.parameters(), start)) > 1e-5


def test_train_epoch_on_the_real_bank_matches_jax():
    """One iteration on two takes of data_bank/clips24.pkl cut to 4 frames
    (SMPL-reference motion driven on the synthetic humanoid), read by the
    port's bank reader. The two sides would sample their start clips from
    different streams, so env i starts on take i on both; no episode ends
    within the 3 steps, so no clip is sampled in the iteration."""
    takes = list(banks.load_takes(os.path.join(ROOT, "data_bank/clips24.pkl"))
                 .values())[:2]
    jagent, tagent = _agents([t[:4] for t in takes])
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    js, jobs = jax.vmap(lambda k, i: jagent.env.reset(k, i, deterministic=True))(
        keys, jnp.arange(2))
    jagent._carry = jro.RolloutState(env_state=js, obs=jobs,
                                     rng=jax.random.PRNGKey(1))
    tagent._carry = tro.RolloutState(*tagent.env.reset(torch.arange(2)))
    tm = _check_epochs(jagent, tagent, 1)
    assert tagent.epoch == jagent.epoch == 1
    assert tm["reward_mean"] > 0
