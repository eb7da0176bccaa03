"""Port parity: the AR trainer under the use_of config (policy_v 2, the
optical-flow features in every batch), kinpoly_tpu_torch against
kinpoly_tpu, float64 on the CPU, on the train-mode envs of
``test_torch_env_ar.build_envs`` at small widths with the same initial
parameters in both packages: a warm start (``train_init``: an init-state
and a full-AR step, which reach only the arnet) followed by the composite
update on one fixed trajectory (PPO and step BC, which reach only the
residual head; the supervised chain's momentum still moves the arnet, as
optax's does over the whole tree), the value net over the observation
with the AR pose, and checkpoints as {"arnet", "delta"} both ways. The
JAX agent's ``_rollout`` is replaced on the instance by a function that
returns the trajectory, as in ``test_torch_agent_ar.py``."""

import dataclasses
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.data import statear as jsa
from kinpoly_tpu.models import nets as jnets
from kinpoly_tpu.rl import agent_ar as jaa
from kinpoly_tpu.rl import rollout_ar as jroa
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.rl import agent_ar as taa
from kinpoly_tpu_torch.rl import rollout_ar as troa

from test_torch_agent_ar import _close, _close_trees, _f64
from test_torch_env_ar import build_envs

torch.set_num_threads(1)

TOL = 1e-9           # parameters and metrics after a few float64 updates
SMALL = dict(rnn_hdim=16, mlp_hsize=(16,), add_noise=False)
T, N = 4, 3          # the fixed trajectory
CFG = dict(batch_size=2, fr_num=8, n_envs=N, rollout_steps=T,
           num_optim_epoch=2, num_step_update=2, seed=1, log_std=-3.5)


@pytest.fixture(scope="module")
def ag():
    e = build_envs(mode="train", small=SMALL, cfg_name="use_of", n_frames=8)
    ja = jaa.AgentAR(e.jenv, jsa.StateARDataset(e.takes, fr_num=CFG["fr_num"]),
                     jaa.ARTrainConfig(**CFG))
    ta = taa.AgentAR(e.tenv, e.ds, taa.ARTrainConfig(**CFG))
    params = _f64(ja.params)
    # the head's output kernel is zero at init: give it values, so that the
    # observation's inner entries reach the actions
    params["delta"]["params"]["fc"]["kernel"] = np.random.RandomState(3).normal(
        0, 1e-2, params["delta"]["params"]["fc"]["kernel"].shape)
    init = dict(params=params, value=_f64(ja.value_params),
                cc=_f64(e.jenv.cc_policy_params))
    ns = types.SimpleNamespace(e=e, ja=ja, ta=ta, init=init)
    ns.traj = _trajectory(ns)
    return ns


def _load_policy(ta, params):
    ta.policy.net.load_state_dict(weights.trajar_from_jax(params["arnet"]))
    ta.policy.delta_net.load_state_dict(weights.delta_from_jax(params["delta"]))


def reset(ns, **over):
    """Both agents at the initial parameters, fresh optimiser states and
    the window sampler at its seed (after the construction-time draw)."""
    ja, ta, init = ns.ja, ns.ta, ns.init
    ja.cfg = dataclasses.replace(jaa.ARTrainConfig(**CFG), **over)
    ta.cfg = dataclasses.replace(taa.ARTrainConfig(**CFG), **over)
    ja.params, ja.value_params, ja.cc_params = (init["params"], init["value"],
                                                init["cc"])
    ja.sup_opt_state = ja.sup_opt.init(ja.params)
    ja.pol_opt_state = ja.pol_opt.init(ja.params)
    ja.val_opt_state = ja.val_opt.init(ja.value_params)
    ja.cc_opt_state = ja.cc_opt.init(ja.cc_params)
    _load_policy(ta, init["params"])
    ta.value.load_state_dict(weights.value_state_dict(init["value"]))
    ta.cc_policy.load_state_dict(weights.policy_state_dict(init["cc"]))
    for opt in (ta.sup_opt, ta.pol_opt, ta.val_opt, ta.cc_opt):
        opt.reset()
    for a in (ja, ta):
        a.np_rng = np.random.RandomState(CFG["seed"])
        a.dataset.get_batch(a.np_rng, 1, use_of=True)
        a.epoch, a.freq = 0, {}


def _trajectory(ns):
    """A (T, N) record: observations ending in poses near the takes',
    actions sampled near the initial policy's means with their log-probs,
    rewards, episode ends, sim and ground-truth poses, controller
    observations and actions."""
    reset(ns)
    e, ta = ns.e, ns.ta
    rng = np.random.RandomState(11)
    d = ta.policy.delta_net.rnn.input_size
    q = e.clip.qpos                                   # (4 takes, 8, 76)
    pick = lambda off: np.stack([q[n % q.shape[0], t + off] for t in range(T)
                                 for n in range(N)]).reshape(T, N, 76)

    def noisy(x, s):
        x = x + rng.normal(0, s, x.shape)
        x[..., 3:7] /= np.linalg.norm(x[..., 3:7], axis=-1, keepdims=True)
        return x

    obs = rng.normal(0, 0.5, (T, N, d))
    obs[..., -76:] = noisy(pick(0), 0.01)
    masks = np.ones((T, N))
    masks[1, 0] = masks[2, 2] = 0.0
    prev = np.concatenate([np.ones((1, N)), masks[:-1]])
    with torch.no_grad():
        means = ta.policy.action_means_over_time(torch.tensor(obs),
                                                 torch.tensor(prev)).numpy()
    actions = means + np.exp(ta.cfg.log_std) * rng.normal(0, 0.7, means.shape)
    log_probs = jnets.gaussian_log_prob(
        jnp.asarray(actions), jnp.asarray(means),
        jnp.full(means.shape, ta.cfg.log_std))
    cc_state = rng.normal(0, 1.0, (T, N, 784))
    with torch.no_grad():
        cc_mean = e.tenv.cc_policy(torch.tensor(cc_state))[0].numpy()
    traj = dict(
        obs=obs, actions=actions, rewards=rng.uniform(0.2, 0.9, (T, N)),
        masks=masks, log_probs=np.asarray(log_probs), gt_qpos=pick(1),
        curr_qpos=noisy(pick(0), 0.01), res_qpos=noisy(pick(1), 0.02),
        cc_action=cc_mean + 0.1 * rng.normal(size=cc_mean.shape),
        cc_state=cc_state, fails=masks == 0, ends=np.zeros((T, N), bool),
        percents=rng.uniform(0, 1, (T, N)),
        clips=np.tile(np.arange(N), (T, 1)))
    return traj, rng.normal(0, 0.5, (N, d))


def _compare_params(ns):
    ja, ta = ns.ja, ns.ta
    _close_trees(ja.params, weights.policy_ar_params(ta.policy))
    _close_trees(ja.value_params, weights.value_params(ta.value.state_dict()))
    for name, H in (("context_gru.bias_hh_l0", SMALL["rnn_hdim"]),
                    ("action_gru.bias_hh", SMALL["rnn_hdim"]),
                    ("rnn.bias_hh", 512)):
        b = dict(ta.policy.named_parameters())[name]
        assert bool((b[:2 * H] == 0).all()), name


def _moved(tree, ref):
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)))


def _update(ns, w_ppo=1.0, w_bc=1.0):
    """The composite update on the fixed trajectory in both packages: the
    metrics (JAX's, the port's)."""
    raw, last_obs = ns.traj
    jtraj = jroa.ARTrajectory(**{k: jnp.asarray(v) for k, v in raw.items()})
    carry = types.SimpleNamespace(obs=jnp.asarray(last_obs))
    ja, ta = ns.ja, ns.ta
    ja._rollout = lambda c, p, ctx, mean_action=True, cc_params=None: (carry,
                                                                       jtraj)
    out = ja._rl_and_step_update(
        ja.params, ja.value_params, ja.pol_opt_state, ja.val_opt_state,
        ja.sup_opt_state, carry, None, jax.random.PRNGKey(0), ja.cc_params,
        ja.cc_opt_state, jnp.asarray(w_ppo), jnp.asarray(w_bc))
    (ja.params, ja.value_params, ja.pol_opt_state, ja.val_opt_state,
     ja.sup_opt_state, _, jm, _, _, _, ja.cc_params, ja.cc_opt_state) = out
    tm = ta.update(troa.ARTrajectory(**{k: torch.tensor(v)
                                        for k, v in raw.items()}),
                   torch.tensor(last_obs), w_ppo, w_bc)
    return jm, tm


def test_value_net_sees_the_ar_pose(ag):
    d = ag.ta.policy.delta_net.rnn.input_size
    assert ag.ta.value.mlp.layers[0].in_features == d
    assert ag.init["value"]["params"]["MLP_0"]["Dense_0"]["kernel"].shape[0] == d


def test_warm_start_then_composite_update(ag):
    """One init-state and one full-AR step (gt_rate 0) on the same windows
    with their flow features: losses, NaN fractions over both trees and
    the parameters (the delta unmoved). Then the composite update: every
    metric, the parameters (the arnet moved by the supervised chain's
    momentum alone, the delta by PPO and BC)."""
    reset(ag)
    yj = list(ag.ja.train_init(init_steps=1, full_steps=1, gt_rate=0.0,
                               log_every=1))
    yt = list(ag.ta.train_init(init_steps=1, full_steps=1, gt_rate=0.0,
                               log_every=1))
    assert [y[:2] for y in yj] == [y[:2] for y in yt]
    for a, b in zip(yj, yt):
        assert abs(a[2] - b[2]) <= TOL * max(1.0, abs(a[2])), (a, b)
        assert a[3] == b[3] == 0.0
    _compare_params(ag)
    assert _moved(ag.ja.params["arnet"], ag.init["params"]["arnet"]) > 0
    assert _moved(ag.ja.params["delta"], ag.init["params"]["delta"]) == 0
    warm = ag.ja.params
    jm, tm = _update(ag)
    assert sorted(jm) == sorted(tm)
    for k in jm:
        _close(jm[k], tm[k], TOL, k)
    assert float(tm["ppo_grad_norm"]) > 0 and float(tm["ratio_dev"]) > 0
    assert float(tm["bc_loss"]) > 0 and float(tm["bc_nan_frac"]) == 0
    _compare_params(ag)
    assert _moved(ag.ja.params["arnet"], warm["arnet"]) > 0
    assert _moved(ag.ja.params["delta"], warm["delta"]) > 0
    assert ag.ta.sup_opt.count == 2 + CFG["num_step_update"]
    assert ag.ta.pol_opt.count == CFG["num_optim_epoch"]


def test_grad_joint_update(ag):
    """grad_joint: PPO and 10 x the step loss in one step per epoch."""
    reset(ag, grad_joint=True)
    jm, tm = _update(ag)
    for k in jm:
        _close(jm[k], tm[k], TOL, k)
    _compare_params(ag)
    assert _moved(ag.ja.params["arnet"], ag.init["params"]["arnet"]) == 0


def test_checkpoints_both_ways(ag, tmp_path):
    """The port's checkpoint in JAX's AgentAR.load_checkpoint and JAX's in
    the port's: params as {"arnet", "delta"}, the same weights bit for bit
    and the same action means and values; a policy_v 1 checkpoint is
    refused."""
    reset(ag)
    _update(ag)
    ag.ta.epoch, ag.ta.freq = 5, {1: [1.0, 0.0]}
    path = ag.ta.save_checkpoint(str(tmp_path / "iter_0005.p"))
    blob = weights.read_checkpoint(path)
    assert sorted(blob["params"]) == ["arnet", "delta"]
    raw, _ = ag.traj
    prev = np.concatenate([np.ones((1, N)), raw["masks"][:-1]])

    def outputs_jax(a):
        m = a.policy.action_means_over_time(a.params, jnp.asarray(raw["obs"]),
                                            jnp.asarray(prev))
        v = a.value.apply(a.value_params, jnp.asarray(raw["obs"][0]))
        return [np.asarray(x) for x in (m, v)]

    def outputs_torch(a):
        with torch.no_grad():
            m = a.policy.action_means_over_time(torch.tensor(raw["obs"]),
                                                torch.tensor(prev))
            return [x.numpy() for x in (m, a.value(torch.tensor(raw["obs"][0])))]

    ag.ja.load_checkpoint(path)
    assert ag.ja.epoch == 5 and ag.ja.freq == ag.ta.freq
    _close_trees(ag.ja.params, weights.policy_ar_params(ag.ta.policy), 0.0)
    for x, y in zip(outputs_jax(ag.ja), outputs_torch(ag.ta)):
        _close(x, y, 1e-12)

    reset(ag)
    ag.ja.epoch, ag.ja.freq = 3, {0: [1.0]}
    ag.ja.params = jax.tree.map(lambda x: x * 1.01, ag.ja.params)
    jpath = ag.ja.save_checkpoint(str(tmp_path / "iter_0003.p"))
    ag.ta.load_checkpoint(jpath)
    assert ag.ta.epoch == 3 and ag.ta.freq == {0: [1.0]}
    for x, y in zip(outputs_jax(ag.ja), outputs_torch(ag.ta)):
        _close(x, y, 1e-12)

    v1 = weights.read_checkpoint(jpath)
    v1["params"] = v1["params"]["arnet"]
    v1_path = tmp_path / "iter_0004.p"
    with open(v1_path, "wb") as f:
        pickle.dump(v1, f)
    with pytest.raises(ValueError, match="policy_v 1"):
        ag.ta.load_checkpoint(str(v1_path))
