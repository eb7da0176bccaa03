"""Port parity: the trained UHC controller, the imitation env and coverage
evaluation of kinpoly_tpu_torch against kinpoly_tpu, float64 on the CPU, on
the synthetic humanoid; and the port's UHC config against uhc.yml."""

import dataclasses
import os
import pickle

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
from kinpoly_tpu.rl import agent_uhc as jagent_mod
from kinpoly_tpu.rl import running_norm as jrn
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import UHCConfig, uhc_control_params
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, make_bank
from kinpoly_tpu_torch.models import nets as tnets
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.physics import engine as teng
from kinpoly_tpu_torch.rl import running_norm as trn
from kinpoly_tpu_torch.rl.agent_uhc import UHCAgent
from kinpoly_tpu_torch.scripts.eval_uhc import make_clips

# many tiny torch ops: one intra-op thread per process keeps several test
# workers from oversubscribing the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results/motion_im/uhc/models/iter_13000.p")
NET_TOL = 1e-10     # f64 forward pass of the same float32 weights
ENV_TOL = 1e-7      # one control step of f64 physics, as test_torch_engine
FRAMES = (3, 4, 6)  # clip lengths: two end inside a 4-step evaluation


@pytest.fixture(scope="module")
def blob():
    with open(CKPT, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def envs():
    spec = sp.synthetic_spec(0)
    jspec = mjcf.HumanoidSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    takes = [c[:t] for c, t in zip(make_clips(spec, 3, max(FRAMES), seed=2),
                                   FRAMES)]
    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec),
                          solver="ltdl")
    jcfg = jconfig.UHCConfig("uhc", "results")
    jbank = jexpert.stack_bank([
        jexpert.from_qpos(jspec, t.astype(np.float64), dt=jm.control_dt,
                          pad_to=max(FRAMES)) for t in takes])
    q0, v0 = sp.standing_pose(spec)
    jenv = jenv_mod.HumanoidImEnv(jm, jcfg.env_config(), jbank, q0, v0,
                                  mode="test")
    tm = teng.build_model(spec, uhc_control_params(spec), device="cpu",
                          dtype=torch.float64)
    tenv = HumanoidImEnv(tm, UHCConfig().env_config(),
                         make_bank(spec, tm, takes))
    return jenv, tenv, jcfg


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err < tol, err


def test_checkpoint_policy_value_norm(blob):
    ck = weights.load_uhc_checkpoint(CKPT)
    assert ck["epoch"] == blob["epoch"]
    obs = np.random.RandomState(0).normal(0, 3, (5, 784))
    jnorm = jrn.RunningNorm(*blob["norm"])
    x_j = jrn.apply(jnorm, jnp.asarray(obs))
    x_t = trn.apply(ck["norm"], torch.tensor(obs))
    _close(x_t.numpy(), x_j, NET_TOL)

    mean_j, log_std_j = jnets.PolicyMCP(action_dim=75).apply(
        blob["policy_params"], x_j)
    pol = tnets.PolicyMCP(784, 75).double()
    pol.load_state_dict(ck["policy"])
    with torch.no_grad():
        mean_t, log_std_t = pol(x_t)
    _close(mean_t.numpy(), mean_j, NET_TOL)
    _close(log_std_t.numpy(), log_std_j, NET_TOL)

    val = tnets.Value(784).double()
    val.load_state_dict(ck["value"])
    with torch.no_grad():
        v_t = val(x_t)
    _close(v_t.numpy(), jnets.Value().apply(blob["value_params"], x_j), NET_TOL)


def test_env_reset_and_step(envs):
    jenv, tenv, _ = envs
    n = len(FRAMES)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    js, jobs = jax.vmap(lambda k, i: jenv.reset(k, i, deterministic=True))(
        keys, jnp.arange(n))
    ts, tobs = tenv.reset(torch.arange(n))
    assert tobs.shape == (n, 784)
    _close(tobs.numpy(), jobs, ENV_TOL)

    action = np.random.RandomState(1).normal(0, 0.3, (n, 75))
    js2, jobs2, jr, jd, jinfo = jax.jit(jax.vmap(jenv.step))(
        js, jnp.asarray(action))
    ts2, tobs2, tr, td, tinfo = tenv.step(ts, torch.tensor(action))
    _close(ts2.sim.qpos.numpy(), js2.sim.qpos, ENV_TOL)
    _close(tobs2.numpy(), jobs2, ENV_TOL)
    _close(tr.numpy(), jr, ENV_TOL)
    _close(tinfo.reward_info.numpy(), jinfo["reward_info"], ENV_TOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tinfo.fail.numpy(), np.asarray(jinfo["fail"]))
    _close(tinfo.percent.numpy(), jinfo["percent"], 1e-12)


def test_eval_coverage(envs):
    jenv, tenv, jcfg = envs
    jagent = jagent_mod.UHCAgent(jenv, jcfg.train_config())
    jagent.load_checkpoint(CKPT)
    jcov, jinfo = jagent.eval_coverage(max_steps=4)
    agent = UHCAgent(tenv, UHCConfig())
    agent.load_checkpoint(CKPT)
    cov, info = agent.eval_coverage(max_steps=4)
    assert cov == jcov
    np.testing.assert_array_equal(info["succ"], jinfo["succ"])
    _close(info["percent"], jinfo["percent"], 1e-12)
    assert info["succ"][:2].all()       # the short clips were tracked to their end


@pytest.mark.parametrize("fix_std", [True, False])
def test_policy_gaussian_matches_flax(fix_std):
    """PolicyGaussian with a fixed and a learnable log-std: flax weights in,
    the same outputs, and the port's weights back out as the flax tree."""
    jpol = jnets.PolicyGaussian(action_dim=75, hidden=(32, 16),
                                log_std_init=-1.5, fix_std=fix_std)
    params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jpol.init(jax.random.PRNGKey(4), jnp.zeros((1, 784))))
    if not fix_std:
        params["params"]["log_std"] = np.linspace(-2.0, -1.0, 75)
    x = np.random.RandomState(5).normal(0, 1, (6, 784))
    mean_j, log_std_j = jpol.apply(params, jnp.asarray(x))
    pol = tnets.PolicyGaussian(784, 75, hidden=(32, 16), log_std_init=-1.5,
                               fix_std=fix_std).double()
    pol.load_state_dict(weights.policy_state_dict(params))
    with torch.no_grad():
        mean_t, log_std_t = pol(torch.tensor(x))
    _close(mean_t.numpy(), mean_j, NET_TOL)
    _close(log_std_t.detach().numpy(), log_std_j, NET_TOL)
    back = weights.policy_params(pol.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)
    fresh = tnets.init_flax_(tnets.PolicyGaussian(784, 75, fix_std=fix_std),
                             torch.Generator().manual_seed(0))
    assert jax.tree.structure(weights.policy_params(fresh.state_dict())) == \
        jax.tree.structure(jnets.PolicyGaussian(action_dim=75, fix_std=fix_std)
                           .init(jax.random.PRNGKey(0), jnp.zeros((1, 784))))


def test_gauss_actor_type(envs):
    _, tenv, _ = envs
    cfg = dataclasses.replace(UHCConfig(), actor_type="gauss", fix_std=False)
    agent = UHCAgent(tenv, cfg)
    assert isinstance(agent.policy, tnets.PolicyGaussian)
    assert float(agent.policy.log_std.detach().max()) == cfg.log_std


def test_eval_coverage_stochastic_band(envs):
    """With a log-std of -30 the sampled runs track as the deterministic
    one does; JAX gives the same coverage and band."""
    jenv, tenv, jcfg = envs
    jagent = jagent_mod.UHCAgent(
        jenv, dataclasses.replace(jcfg.train_config(), log_std=-30.0))
    jagent.load_checkpoint(CKPT)
    jcov, jinfo = jagent.eval_coverage(max_steps=4, stochastic_seeds=2)
    agent = UHCAgent(tenv, dataclasses.replace(UHCConfig(), log_std=-30.0))
    agent.load_checkpoint(CKPT)
    cov, info = agent.eval_coverage(max_steps=4, stochastic_seeds=2)
    assert cov == jcov
    assert info["coverage_seeds"] == [cov, cov] == jinfo["coverage_seeds"]
    assert info["coverage_mean"] == cov and info["coverage_std"] == 0.0
    np.testing.assert_array_equal(info["succ"], jinfo["succ"])


def _config_matches_yaml(name):
    yml = jconfig.load_yaml(name)
    cfg = UHCConfig.named(name)
    names = {f.name for f in dataclasses.fields(cfg)} - {"name"}
    assert set(yml) <= names
    for k, v in yml.items():
        got = getattr(cfg, k)
        assert (tuple(v) if isinstance(v, list) else v) == got, k
    # the fields the YAML does not set hold the JAX config's defaults
    jcfg = jconfig.UHCConfig(name, "results")
    for k in sorted(names - set(yml) - {"adp_iter_cp", "adp_noise_rate_cp",
                                        "adp_log_std_cp", "adp_policy_lr_cp"}):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    assert cfg.adaptive_params(7) == jcfg.adaptive_params(7)
    assert cfg.name == jconfig.UHCConfig(name, "results").id
    assert cfg.model_dir("out") == jconfig.UHCConfig(name, "out").model_dir


def test_uhc_config_matches_yaml():
    _config_matches_yaml("uhc")
    assert UHCConfig() == UHCConfig.named("uhc")


def test_uhc_quatv2_config_matches_yaml():
    _config_matches_yaml("uhc_quatv2")
