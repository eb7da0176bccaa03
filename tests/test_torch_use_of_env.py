"""Port parity: the AR env under the use_of config (policy_v 2: the action
is the next qpos, the observation ends with the AR rollout's pose; the
optical-flow features and the step context in the observation; the
dynamic_supervision_v3 reward at use_of.yml's weights), kinpoly_tpu_torch
against kinpoly_tpu, float64 on the CPU: the context build, reset and two
env steps under the port policy's mean actions (the residual head's
output kernel made non-zero), in mode "test" and in mode "train" (the
controller's log-std pinned at -30, so that the packages' different
random streams do not matter; the ground-truth termination on), the
latter in ``test_torch_use_of_env_train.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env_ar import _close, _state, build_envs

torch.set_num_threads(1)

SMALL = dict(rnn_hdim=16, mlp_hsize=(16,))
TOL = 1e-9           # the context: float64 kinematics and a small net
OBS_TOL = 1e-6       # observation, reward, controller action


def stepped_envs(mode: str):
    """build_envs under use_of in `mode`, the reset of one env per take in
    both packages and two env steps from there under the port policy's
    mean actions."""
    e = build_envs(mode=mode, small=SMALL, cfg_name="use_of",
                   cc_log_std=-30.0 if mode == "train" else -2.3)
    keys = jax.random.split(jax.random.PRNGKey(3), e.n)
    js, jobs = jax.jit(jax.vmap(lambda k, i: e.jenv.reset(k, i)))(
        keys, jnp.arange(e.n, dtype=jnp.int32))
    ts, tobs = e.tenv.reset(torch.arange(e.n))
    e.mode, e.reset_out = mode, ((js, jobs), (ts, tobs))
    jstep = jax.jit(jax.vmap(e.jenv.step))
    e.steps, e.actions = [], []
    carry = e.tp.init_carry(e.n, tobs)
    with torch.no_grad():
        for _ in range(2):
            carry, a = e.tp.action_mean(carry, tobs)
            jout = jstep(js, jnp.asarray(a.numpy()))
            tout = e.tenv.step(ts, a)
            e.steps.append((jout, tout))
            e.actions.append(a)
            js, ts, tobs = jout[0], tout[0], tout[1]
    return e


@pytest.fixture(scope="module")
def env():
    return stepped_envs("test")


def test_config_and_context(env):
    """The envs run policy_v 2 with the 76-d action and the v3 reward; the
    context carries the flow features and the step context features."""
    assert env.tenv.policy_v == env.jenv.policy_v == 2
    assert env.tenv.action_dim == env.jenv.action_dim == 76
    assert env.tenv.rw.reward_id == "dynamic_supervision_v3"
    assert env.tctx.of.shape == (env.n, 10, 512)
    assert env.tctx.context_feat.shape == (env.n, 10, SMALL["rnn_hdim"])
    for f in env.jctx._fields:
        a, b = getattr(env.jctx, f), getattr(env.tctx, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _close(a, b, TOL)


def test_reset_obs(env):
    """The observation: the step context, the AR state, the action
    one-hot, the flow features, then the AR pose at frame 0."""
    (js, jobs), (ts, tobs) = env.reset_out
    _state(js, ts)
    _close(jobs, tobs, OBS_TOL)
    _close(env.tctx.ar_qpos[:, 0], tobs[:, -76:], 0)
    _close(env.tctx.of[:, 0], tobs[:, -76 - 512:-76], 0)


@pytest.mark.parametrize("k", [0, 1])
def test_step(env, k):
    """Step k + 1: state, observation (the AR pose at frame k + 1 last),
    reward and its components, termination, the controller's action and
    observation."""
    (js, jobs, jr, jd, jinfo), (ts, tobs, tr, td, tinfo) = env.steps[k]
    _state(js, ts)
    _close(jobs, tobs, OBS_TOL)
    _close(jr, tr, OBS_TOL)
    _close(jinfo["reward_info"], tinfo.reward_info, OBS_TOL)
    _close(jd, td, 0)
    for f in ("fail", "end"):
        _close(jinfo[f], getattr(tinfo, f), 0)
    _close(jinfo["cc_action"], tinfo.cc_action, OBS_TOL)
    _close(jinfo["cc_state"], tinfo.cc_state, OBS_TOL)
    _close(env.tctx.ar_qpos[:, k + 1], tobs[:, -76:], 0)
    # the action: the AR pose at frame k plus the head's residual
    delta = env.actions[k] - env.tctx.ar_qpos[:, k]
    assert 0 < float(delta.abs().max()) < 0.1
    assert np.isfinite(tr.numpy()).all() and float(tr.min()) > 0.0
