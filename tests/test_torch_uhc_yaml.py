"""Port parity of the UHC configuration read from a YAML against
kinpoly_tpu: the port's YAML reader against PyYAML's ``safe_load`` on the
repo's six configs and on one that uses explicit residual forces, meta-PD
and adaptive schedules; ``UHCConfig.from_yaml``, ``control_params``,
``env_config`` and the adaptive schedules against the JAX ``UHCConfig``;
the trainer's physics under the config's control parameters (residual
forces clipped at ``residual_force_lim``); and checkpoints of a 315-wide
explicit + meta-PD policy read both ways."""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from kinpoly_tpu.config import config as jconfig
from kinpoly_tpu.models import nets as jnets
from kinpoly_tpu.physics import engine as jeng
from kinpoly_tpu.rl import running_norm as jrn
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config import config as tconfig
from kinpoly_tpu_torch.config.defaults import (NAMED_CONFIGS, NAMED_KIN_CONFIGS,
                                               UHCConfig)
from kinpoly_tpu_torch.physics import engine as teng
from kinpoly_tpu_torch.rl import running_norm as trn
from kinpoly_tpu_torch.scripts.eval_uhc import make_clips
from kinpoly_tpu_torch.scripts.train_uhc import build_trainer

from test_torch_objects import jax_spec

torch.set_num_threads(1)

YAML_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kinpoly_tpu", "config", "yaml")
TOL = 1e-7          # physics state, as tests/test_torch_engine.py
NET_TOL = 1e-10     # f64 forward pass of the same weights
BASE_ROT = np.asarray([0.7071, 0.7071, 0.0, 0.0], np.float32)

with open(os.path.join(YAML_DIR, "uhc.yml")) as _f:
    UHC_YML = _f.read()

# uhc.yml with explicit residual forces on every body, meta-PD, the
# local_rfc_explicit reward, adaptive schedules and the scalars whose
# resolution is easy to get wrong
EXPLICIT_YML = UHC_YML.replace("residual_force_mode: implicit", """\
residual_force_mode: explicit
residual_force_bodies: all
residual_force_torque: yes
meta_pd: true
env_expert_trail_steps: 2
env_init_noise: 0.01""").replace("reward_id: world_rfc_implicit",
                                 "reward_id: local_rfc_explicit").replace(
    "  k_vf: 1.0", """\
  k_vf: 1.0
  w_cp: 0.1      # contact points
  k_cp: 10.0
  w_rp: 0.1
  w_r: 0.3       # read by no reward
""") + """\
adp_iter_cp: [0, 100, 1000]
adp_noise_rate_cp: [1.0, 0.5, 0.0]
adp_log_std_cp: [-2.3, -2.5, -2.9]
adp_policy_lr_cp: [5.0e-5, 2.0e-5, 1.0e-5]
wandb_entity: ~
note_lr: 1e-4
"""


def _yaml(tmp_path, text, name="my_explicit.yml"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _same(a, b, ordered=True):
    """Equal values and types, NaN equal to NaN, through dicts (their keys
    in the same order if `ordered`) and lists."""
    if isinstance(a, dict):
        keys = list(a) == list(b) if ordered else set(a) == set(b)
        return (isinstance(b, dict) and keys
                and all(_same(a[k], b[k], ordered) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y, ordered) for x, y in zip(a, b)))
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(os.listdir(YAML_DIR)))
def test_load_yaml_matches_safe_load(name):
    path = os.path.join(YAML_DIR, name)
    with open(path) as f:
        want = yaml.safe_load(f)
    assert _same(tconfig.load_yaml(path), want)


def test_load_yaml_resolves_scalars_as_safe_load(tmp_path):
    text = EXPLICIT_YML + """\
ints: [0, -3, +4, 1200]
floats: [.5, 1.5, 3., 1.0e+3, -2.5e-3, .5e-3]
strings: [abc, 'it''s', "dq", 1e5, 1.0e5, 'yes', -.5, 1e+3]
bools: [yes, No, on, OFF, True, false]
nested:
  a:
    b: ~
    c:
  d: text with spaces   # a comment
"""
    got = tconfig.load_yaml(_yaml(tmp_path, text))
    assert _same(got, yaml.safe_load(text))
    assert got["note_lr"] == "1e-4" and got["wandb_entity"] is None
    assert got["adp_policy_lr_cp"][0] == 5.0e-5
    assert got["residual_force_torque"] is True


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n", "a: {b: 1}\n", "a: &x 1\n", "a: *x\n", "a: !!int 1\n",
    "a: |\n  x\n", "a: 2001-12-14\n", "a:\n\tb: 1\n", "a: b: c\n",
    "a: [[1], 2]\n", "a: 1\n---\nb: 2\n", "a:\n    b: 1\n  c: 2\n",
    # YAML 1.1 numbers the configs do not use
    "a: 0x1f\n", "a: 017\n", "a: 1_000\n", "a: 0b101\n", "a: 1:30\n",
    "a: 1:30.5\n", "a: [1.5, -.inf]\n", "a: .NaN\n", "a: 1_0.5\n"])
def test_load_yaml_refuses_what_it_does_not_read(tmp_path, text):
    with pytest.raises(ValueError):
        tconfig.load_yaml(_yaml(tmp_path, text, "bad.yml"))


def test_load_yaml_unknown_name():
    # load_yaml reads files only; names go through UHCConfig.load
    for name in ("no_such_config", "uhc"):
        with pytest.raises(FileNotFoundError, match="named config"):
            tconfig.load_yaml(name)
    with pytest.raises(ValueError, match="unknown UHC config"):
        UHCConfig.load("no_such_config")
    assert UHCConfig.load("uhc") == UHCConfig.named("uhc")
    assert set(NAMED_CONFIGS) | set(NAMED_KIN_CONFIGS) == {
        os.path.splitext(n)[0] for n in os.listdir(YAML_DIR)}


def _check_config(cfg: UHCConfig, jcfg):
    """Every field of the port's config against the JAX config's
    attribute of that name, the schedules as arrays."""
    assert cfg.name == jcfg.id
    assert cfg.model_dir("out") == jcfg.model_dir.replace("results", "out", 1)
    for f in dataclasses.fields(cfg):
        if f.name == "name":
            continue
        got = getattr(cfg, f.name)
        # value_htype is read by no JAX code; the JAX config keeps it in
        # its YAML dict
        want = (getattr(jcfg, f.name) if hasattr(jcfg, f.name)
                else jcfg.cfg_dict[f.name])
        if f.name.startswith("adp_"):
            default = {"adp_log_std_cp": [cfg.log_std],
                       "adp_policy_lr_cp": [cfg.policy_lr]}.get(f.name)
            np.testing.assert_array_equal(
                np.asarray(default if got is None else got), want)
        else:
            assert (list(got) if isinstance(got, tuple) and isinstance(
                want, list) else got) == want, f.name
    for i in (0, 50, 100, 550, 1000, 5000):
        assert cfg.adaptive_params(i) == pytest.approx(
            jcfg.adaptive_params(i), rel=1e-15, abs=0), i
    je, te = jcfg.env_config(), cfg.env_config()
    for f in dataclasses.fields(je):
        assert getattr(te, f.name) == getattr(je, f.name), f.name
    spec = sp.synthetic_spec(0)
    jc, tc = jcfg.control_params(jax_spec(spec)), cfg.control_params(spec)
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


def test_config_from_explicit_yaml_matches_jax(tmp_path):
    path = _yaml(tmp_path, EXPLICIT_YML)
    cfg = UHCConfig.from_yaml(path)
    _check_config(cfg, jconfig.UHCConfig(path, "results"))
    assert UHCConfig.load(path) == cfg and cfg.name == "my_explicit"
    assert cfg.env_config().w_cp == 0.1 and cfg.env_config().k_cp == 10.0
    ctrl = cfg.control_params(sp.synthetic_spec(0))
    assert (ctrl.rfc_mode, ctrl.meta_pd, ctrl.rfc_lim) == ("explicit", True, 100.0)
    assert 69 + ctrl.vf_dim + 2 * 15 == 315


@pytest.mark.parametrize("name", sorted(NAMED_CONFIGS))
def test_named_config_matches_jax(name):
    cfg = UHCConfig.load(name)
    assert cfg == UHCConfig.named(name)
    assert cfg == UHCConfig.from_yaml(os.path.join(YAML_DIR, f"{name}.yml"))
    _check_config(cfg, jconfig.UHCConfig(name, "results"))


def test_trainer_clips_residual_forces_as_jax():
    """train_uhc's physics takes the config's control parameters: one
    control step with |vf| > 1 (residual forces over uhc.yml's
    residual_force_lim of 100 N) gives the JAX trainer's state."""
    spec = sp.synthetic_spec(0)
    takes = {f"c{i}": c for i, c in enumerate(make_clips(spec, 2, 4, seed=1))}
    agent = build_trainer(takes, UHCConfig(), n_envs=2, rollout_steps=2,
                          device="cpu", dtype=torch.float64)
    tm = agent.env.model
    jm = jeng.build_model(jax_spec(spec), jconfig.UHCConfig(
        "uhc", "results").control_params(jax_spec(spec)), solver="ltdl")
    rng = np.random.RandomState(6)
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], 3, axis=0)
    qpos[:, 7:] += rng.uniform(-0.1, 0.1, (3, 69))
    qpos[:, 2] += 0.3                       # in the air: the forces move it
    qvel = rng.normal(0, 0.3, (3, 75))
    action = rng.normal(0, 0.3, (3, 75))
    action[:, 69:] = rng.choice([-1, 1], (3, 6)) * rng.uniform(1.5, 3.0, (3, 6))
    target = qpos[:, 7:]
    sj = jeng.control_step(jm, jeng.SimState(jnp.asarray(qpos), jnp.asarray(qvel)),
                           jnp.asarray(action), jnp.asarray(target),
                           jnp.asarray(BASE_ROT))
    st = teng.control_step(tm, teng.SimState(torch.tensor(qpos), torch.tensor(qvel)),
                           torch.tensor(action), torch.tensor(target),
                           torch.tensor(BASE_ROT).double())
    for a, b in ((st.qvel, sj.qvel), (st.qpos, sj.qpos)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) < TOL
    assert tm.ctrl.rfc_lim == 100.0


@pytest.fixture(scope="module")
def explicit_agent(tmp_path_factory):
    path = _yaml(tmp_path_factory.mktemp("cfg"), EXPLICIT_YML)
    spec = sp.synthetic_spec(0)
    takes = {f"c{i}": c for i, c in enumerate(make_clips(spec, 2, 4, seed=2))}
    return build_trainer(takes, UHCConfig.from_yaml(path), n_envs=2,
                         rollout_steps=2, device="cpu", dtype=torch.float64)


def test_explicit_policy_checkpoint_runs_in_jax(explicit_agent, tmp_path):
    """The port's 315-wide policy, saved and applied with the JAX nets."""
    agent = explicit_agent
    assert agent.env.action_dim == 315
    path = agent.save_checkpoint(str(tmp_path / "iter_0000.p"))
    with open(path, "rb") as f:
        blob = pickle.load(f)
    obs = np.random.RandomState(0).normal(0, 1, (4, agent.obs_dim))
    x_j = jrn.apply(jrn.RunningNorm(*blob["norm"]), jnp.asarray(obs))
    mean_j, log_std_j = jnets.PolicyMCP(action_dim=315).apply(
        blob["policy_params"], x_j)
    with torch.no_grad():
        mean_t, log_std_t = agent.policy(trn.apply(agent.norm, torch.tensor(obs)))
    assert mean_t.shape == (4, 315)
    np.testing.assert_allclose(mean_t.numpy(), mean_j, rtol=0, atol=NET_TOL)
    np.testing.assert_allclose(log_std_t.numpy(), log_std_j, rtol=0, atol=NET_TOL)
    assert float(log_std_t[0, -1]) == -2.3


def test_jax_explicit_policy_checkpoint_loads(explicit_agent, tmp_path):
    """A 315-wide JAX policy, saved as the JAX trainer saves it, read by
    the port's trainer: the same actions."""
    agent = explicit_agent
    obs = np.random.RandomState(1).normal(0, 1, (4, agent.obs_dim))
    net = jnets.PolicyMCP(action_dim=315)
    params = jax.device_get(net.init(jax.random.PRNGKey(3), jnp.asarray(obs)))
    vparams = jax.device_get(jnets.Value().init(jax.random.PRNGKey(4),
                                                jnp.asarray(obs)))
    norm = jrn.RunningNorm(np.float32(5.0),
                           np.zeros(agent.obs_dim, np.float32),
                           np.ones(agent.obs_dim, np.float32))
    path = tmp_path / "iter_0007.p"
    with open(path, "wb") as f:
        pickle.dump(dict(policy_params=params, value_params=vparams, norm=norm,
                         success_ewma=np.zeros(2), seen=np.zeros(2, bool),
                         epoch=7, cfg={}), f)
    agent.load_checkpoint(str(path))
    assert agent.epoch == 7
    x = jrn.apply(norm, jnp.asarray(obs))
    mean_j, _ = net.apply(params, x)
    with torch.no_grad():
        mean_t, _ = agent.policy(trn.apply(agent.norm, torch.tensor(obs)))
    np.testing.assert_allclose(mean_t.numpy(), mean_j, rtol=0, atol=NET_TOL)
