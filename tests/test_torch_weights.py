"""Checkpoints both ways between the port and the JAX package, and the
port's flax-style initialisation of fresh nets."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.models import nets as jnets
from kinpoly_tpu.rl import running_norm as jrn
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import UHCConfig, uhc_control_params
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, make_bank
from kinpoly_tpu_torch.models import nets as tnets
from kinpoly_tpu_torch.physics import engine as teng
from kinpoly_tpu_torch.rl import agent_uhc as tagent_mod
from kinpoly_tpu_torch.rl import running_norm as trn
from kinpoly_tpu_torch.scripts.eval_uhc import make_clips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results/motion_im/uhc/models/iter_13000.p")
NET_TOL = 1e-10     # f64 forward pass of the same weights


def _agent(dtype, **cfg_kw):
    spec = sp.synthetic_spec(0)
    m = teng.build_model(spec, uhc_control_params(spec), device="cpu",
                         dtype=dtype)
    env = HumanoidImEnv(m, UHCConfig().env_config(),
                        make_bank(spec, m, make_clips(spec, 2, 3, seed=0)))
    tc = UHCConfig().train_config()
    for k, v in cfg_kw.items():
        setattr(tc, k, v)
    return tagent_mod.UHCAgent(env, tc)


@pytest.mark.parametrize("fix_std", [True, False])
def test_saved_checkpoint_runs_in_jax(tmp_path, fix_std):
    """The port's checkpoint, read with plain pickle and applied with the
    JAX nets, gives the port's outputs."""
    agent = _agent(torch.float64, fix_std=fix_std)
    rng = np.random.RandomState(0)
    agent.norm = trn.RunningNorm(torch.tensor(37.0), torch.tensor(
        rng.normal(0, 1, 784), dtype=torch.float32), torch.tensor(
        rng.uniform(10, 90, 784), dtype=torch.float32))
    if not fix_std:
        agent._set_log_std(-1.7)
    path = agent.save_checkpoint(str(tmp_path / "iter_0000.p"))
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert set(blob) == {"policy_params", "value_params", "norm",
                         "success_ewma", "seen", "epoch", "cfg"}
    obs = rng.normal(0, 3, (5, 784))
    x_j = jrn.apply(jrn.RunningNorm(*blob["norm"]), jnp.asarray(obs))
    x_t = trn.apply(agent.norm, torch.tensor(obs))
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0, atol=NET_TOL)
    mean_j, log_std_j = jnets.PolicyMCP(action_dim=75, fix_std=fix_std).apply(
        blob["policy_params"], x_j)
    with torch.no_grad():
        mean_t, log_std_t = agent.policy(x_t)
        v_t = agent.value(x_t)
    np.testing.assert_allclose(mean_t.numpy(), mean_j, rtol=0, atol=NET_TOL)
    np.testing.assert_allclose(log_std_t.detach().numpy(), log_std_j, rtol=0, atol=NET_TOL)
    assert float(log_std_t[0, 0].detach()) == (-2.3 if fix_std else -1.7)
    np.testing.assert_allclose(
        v_t.numpy(), jnets.Value().apply(blob["value_params"], x_j),
        rtol=0, atol=NET_TOL)


def test_checkpoint_round_trip(tmp_path):
    """iter_13000.p -> port -> saved file -> port loader: identical
    outputs, norm and epoch."""
    a = _agent(torch.float32)
    a.load_checkpoint(CKPT)
    path = a.save_checkpoint(str(tmp_path / "iter_13000.p"))
    b = _agent(torch.float32)
    b.load_checkpoint(path)
    obs = torch.tensor(np.random.RandomState(1).normal(0, 3, (7, 784)),
                       dtype=torch.float32)
    with torch.no_grad():
        for x, y in zip(a.policy(trn.apply(a.norm, obs)),
                        b.policy(trn.apply(b.norm, obs))):
            assert torch.equal(x, y)
        assert torch.equal(a.value(obs), b.value(obs))
    for x, y in zip(a.norm, b.norm):
        assert torch.equal(x, y)
    assert a.epoch == b.epoch == 13000


def test_fresh_init_matches_flax():
    """Fresh nets draw as flax does: zero biases, kernels from a normal
    truncated at 2 sigma with variance 1 / fan_in (the MCP bank's per
    primitive); torch's default Linear init would differ on all three."""
    pol = tnets.PolicyMCP(784, 75)
    val = tnets.Value(784)
    g = torch.Generator().manual_seed(0)
    tnets.init_flax_(pol, g)
    tnets.init_flax_(val, g)
    jp = jax.device_get(jnets.PolicyMCP(action_dim=75).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 784))))["params"]
    jv = jax.device_get(jnets.Value().init(
        jax.random.PRNGKey(1), jnp.zeros((1, 784))))["params"]
    pairs = [(pol.composer.layers[0].weight.T, jp["MLP_0"]["Dense_0"]["kernel"]),
             (pol.composer_head.weight.T, jp["Dense_0"]["kernel"]),
             (pol.bank.w_512_784, jp["_PrimitiveBank_0"]["w_512_784"]),
             (pol.bank.w_75_256, jp["_PrimitiveBank_0"]["w_75_256"]),
             (val.mlp.layers[1].weight.T, jv["MLP_0"]["Dense_1"]["kernel"]),
             (val.head.weight.T, jv["Dense_0"]["kernel"])]
    for t, j in pairs:
        t = t.detach().numpy()
        assert t.shape == j.shape
        fan_in = j.shape[-2]
        for w in (t, j):
            assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.1
            assert np.abs(w).max() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
    for b in (pol.composer.layers[0].bias, pol.bank.b_512_784, val.head.bias):
        assert not b.detach().any()
