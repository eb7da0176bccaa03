"""Port parity of the UHC training resets and the rollout against
kinpoly_tpu, float64 on the CPU, on the synthetic humanoid.

JAX's PRNG streams cannot be reproduced in torch, so the value comparisons
use draws that are deterministic on both sides (noise rate 0, reactive
rate 0 or 1, one-hot clip probabilities, a one-state hard bank); the draws
themselves are checked for their distribution."""

import dataclasses
import functools

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
from kinpoly_tpu.models import nets as jnets
from kinpoly_tpu.physics import engine as jeng
from kinpoly_tpu.rl import rollout as jro
from kinpoly_tpu.rl import running_norm as jrn
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import UHCConfig, uhc_control_params
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, make_bank
from kinpoly_tpu_torch.models import nets as tnets
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.physics import engine as teng
from kinpoly_tpu_torch.rl import rollout as tro
from kinpoly_tpu_torch.rl import running_norm as trn
from kinpoly_tpu_torch.scripts.eval_uhc import make_clips

# many tiny torch ops: one intra-op thread per process keeps several test
# workers from oversubscribing the CPU
torch.set_num_threads(1)

ENV_TOL = 1e-7      # physics in float64, as test_torch_engine
FRAMES = (3, 4, 6)  # clip lengths: the first ends inside a short rollout


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
    assert err <= tol, err
    return err


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)


# -- env resets and the rollout ------------------------------------------


@pytest.fixture(scope="module")
def worlds():
    spec = sp.synthetic_spec(0)
    jspec = mjcf.HumanoidSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    takes = [c[:t] for c, t in zip(make_clips(spec, 3, max(FRAMES), seed=5),
                                   FRAMES)]
    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec),
                          solver="ltdl")
    jbank = jexpert.stack_bank([
        jexpert.from_qpos(jspec, t.astype(np.float64), dt=jm.control_dt,
                          pad_to=max(FRAMES)) for t in takes])
    tm = teng.build_model(spec, uhc_control_params(spec), device="cpu",
                          dtype=torch.float64)
    tbank = make_bank(spec, tm, takes)
    q0, v0 = sp.standing_pose(spec)
    rng = np.random.RandomState(6)
    hard = (q0[None] + np.concatenate([np.zeros((1, 7)),
                                       rng.uniform(-0.2, 0.2, (1, 69))], -1),
            rng.normal(0, 0.3, (1, 75)))
    return dict(spec=spec, jm=jm, jbank=jbank, tm=tm, tbank=tbank, q0=q0,
                v0=v0, hard=hard, jcfg=jconfig.UHCConfig("uhc", "results"))


def _envs(w, **cfg_kw):
    jcfg = dataclasses.replace(w["jcfg"].env_config(), **cfg_kw)
    tcfg = dataclasses.replace(UHCConfig().env_config(), **cfg_kw)
    jenv = jenv_mod.HumanoidImEnv(w["jm"], jcfg, w["jbank"], w["q0"], w["v0"],
                                  mode="train", hard_states=w["hard"])
    tenv = HumanoidImEnv(w["tm"], tcfg, w["tbank"], w["q0"], w["v0"],
                         mode="train", hard_states=w["hard"])
    return jenv, tenv


@pytest.mark.parametrize("reactive_v", [1, 2])
@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_training_reset(worlds, reactive_v, rate):
    jenv, tenv = _envs(worlds, reactive_v=reactive_v, reactive_rate=rate)
    clips = np.asarray([0, 2, 1, 2])
    keys = jax.random.split(jax.random.PRNGKey(0), len(clips))
    js, jobs = jax.jit(jax.vmap(jenv.reset))(keys, jnp.asarray(clips))
    ts, tobs = tenv.reset(torch.tensor(clips), deterministic=False,
                          generator=torch.Generator().manual_seed(0))
    _close(ts.sim.qpos.numpy(), js.sim.qpos, ENV_TOL)
    _close(ts.sim.qvel.numpy(), js.sim.qvel, ENV_TOL)
    _close(ts.prev_bquat.numpy(), js.prev_bquat, ENV_TOL)
    _close(tobs.numpy(), jobs, ENV_TOL)
    expert = tenv.reset(torch.tensor(clips))[0].sim.qpos.numpy()
    moved = np.abs(ts.sim.qpos.numpy() - expert).max()
    assert (moved > 1e-3) == (rate == 1.0)


def test_training_reset_draws(worlds):
    """The reactive share follows reactive_rate, hard states are drawn
    uniformly, joint noise has the configured std."""
    q0, v0 = worlds["q0"], worlds["v0"]
    hq = q0[None].repeat(3, 0)
    hq[:, 7] = [0.1, 0.2, 0.3]
    hard = (hq, np.zeros((3, 75)))
    n = 3000
    clips = torch.zeros(n, dtype=torch.int64)
    g = torch.Generator().manual_seed(1)
    for v, noise in ((1, 0.0), (2, 0.0), (1, 0.05)):
        cfg = dataclasses.replace(UHCConfig().env_config(), reactive_v=v,
                                  reactive_rate=0.3, env_init_noise=noise)
        env = HumanoidImEnv(worlds["tm"], cfg, worlds["tbank"], q0, v0,
                            hard_states=hard)
        s, _ = env.reset(clips, deterministic=False, generator=g)
        expert = worlds["tbank"].qpos[0, 0].numpy()
        qpos = s.sim.qpos.numpy()
        if noise:
            d = qpos[:, 7:] - expert[7:]
            own = np.abs(qpos[:, 2] - expert[2]) < 1e-12
            assert abs(d[own].std() - noise) < 0.002
        else:
            reactive = np.abs(qpos[:, 7] - expert[7]) > 1e-9
            assert abs(reactive.mean() - 0.3) < 0.03
            if v == 2:
                counts = np.bincount(np.round(qpos[reactive, 7] * 10).astype(int))
                assert (np.abs(counts[1:] / reactive.sum() - 1 / 3) < 0.05).all()


def test_sample_clips_distribution():
    p = torch.tensor([0.5, 0.0, 0.2, 0.3], dtype=torch.float64)
    idx = tro.sample_clips(p, 20000, torch.Generator().manual_seed(0))
    share = np.bincount(idx.numpy(), minlength=4) / 20000
    np.testing.assert_allclose(share, p.numpy(), atol=0.015)
    one_hot = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=torch.float64)
    assert (tro.sample_clips(one_hot, 500, torch.Generator()) == 2).all()


def test_rollout_exploration_share(worlds):
    """With noise_rate 0.4 about 40% of the actions are explored and carry
    noise of the policy's std."""
    _, tenv = _envs(worlds, reactive_rate=0.0)
    pol = tnets.PolicyMCP(784, 75, num_primitive=2, hidden=(8,),
                          composer_hidden=(4,)).double()
    tnets.init_flax_(pol, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    probs = torch.full((3,), 1 / 3, dtype=torch.float64)
    carry = tro.init_rollout_state(tenv, g, 200, probs)
    _, traj = tro.make_rollout(tenv, pol, 1, noise_rate=0.4)(
        carry, trn.init(784), probs, g)
    assert abs(float(traj.exps.mean()) - 0.4) < 0.07
    with torch.no_grad():
        mean, log_std = pol(traj.obs[0])
    z = ((traj.actions[0] - mean) / torch.exp(log_std))[traj.exps[0] > 0]
    assert abs(float(z.std()) - 1.0) < 0.05
    assert float((traj.actions[0] - mean)[traj.exps[0] == 0].abs().max()) == 0.0


def _rollouts_match(worlds, noise_rate, mean_action):
    """Five control steps of 3 envs and a one-hot clip distribution on the
    3-frame clip: every env ends at step 3 and is auto-reset; every
    trajectory field agrees."""
    jenv, tenv = _envs(worlds, reactive_rate=0.0)
    jpol = jnets.PolicyMCP(action_dim=75, num_primitive=2, hidden=(16,),
                           composer_hidden=(8,))
    pp = _f64(jpol.init(jax.random.PRNGKey(3), jnp.zeros((1, 784))))
    tpol = tnets.PolicyMCP(784, 75, num_primitive=2, hidden=(16,),
                           composer_hidden=(8,)).double()
    tpol.load_state_dict(weights.policy_state_dict(jax.device_get(pp)))
    rng = np.random.RandomState(7)
    norm_np = (np.float32(50.0), rng.normal(0, 0.5, 784).astype(np.float32),
               rng.uniform(10, 60, 784).astype(np.float32))
    probs = np.asarray([1.0, 0.0, 0.0])
    n, steps = 3, 5

    carry = jro.init_rollout_state(jenv, jax.random.PRNGKey(1), n,
                                   jnp.asarray(probs))
    jrollout = jro.make_rollout(jenv, jpol.apply, steps, noise_rate=noise_rate)
    jcarry, jtraj = jax.jit(functools.partial(jrollout, mean_action=mean_action))(
        carry, pp, jrn.RunningNorm(*norm_np), jnp.asarray(probs))
    g = torch.Generator().manual_seed(1)
    tprobs = torch.tensor(probs)
    tcarry = tro.init_rollout_state(tenv, g, n, tprobs)
    tcarry, ttraj = tro.make_rollout(tenv, tpol, steps, noise_rate=noise_rate)(
        tcarry, trn.RunningNorm(*map(torch.tensor, norm_np)), tprobs, g,
        mean_action=mean_action)

    assert np.asarray(jtraj.masks)[2].sum() == 0      # all ended at step 3
    for name in ttraj._fields:
        t, j = getattr(ttraj, name).numpy(), np.asarray(getattr(jtraj, name))
        if t.dtype == bool or np.issubdtype(t.dtype, np.integer):
            np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=name)
        else:
            _close(t, j, ENV_TOL)
    _close(tcarry.obs.numpy(), jcarry.obs, ENV_TOL)
    _close(tcarry.env_state.sim.qpos.numpy(), jcarry.env_state.sim.qpos, ENV_TOL)
    np.testing.assert_array_equal(tcarry.env_state.cur_t.numpy(),
                                  np.asarray(jcarry.env_state.cur_t))
    return ttraj


def test_rollout_matches_jax(worlds):
    """Noise rate 0: every action is the policy's mean."""
    _rollouts_match(worlds, noise_rate=0.0, mean_action=False)


def test_mean_action_rollout_matches_jax(worlds):
    """Noise rate 1 with mean_action: no action is explored."""
    traj = _rollouts_match(worlds, noise_rate=1.0, mean_action=True)
    assert float(traj.exps.abs().max()) == 0.0


def test_mean_action_keeps_the_draws(worlds):
    """mean_action draws what an exploring rollout draws, so the generator
    ends in the same state."""
    _, tenv = _envs(worlds, reactive_rate=0.0)
    pol = tnets.PolicyMCP(784, 75, num_primitive=2, hidden=(8,),
                          composer_hidden=(4,)).double()
    tnets.init_flax_(pol, torch.Generator().manual_seed(0))
    probs = torch.full((3,), 1 / 3, dtype=torch.float64)
    ends = []
    for mean_action in (False, True):
        g = torch.Generator().manual_seed(4)
        carry = tro.init_rollout_state(tenv, g, 5, probs)
        tro.make_rollout(tenv, pol, 4, noise_rate=0.5)(
            carry, trn.init(784), probs, g, mean_action=mean_action)
        ends.append(torch.rand(3, generator=g))
    assert torch.equal(ends[0], ends[1])
