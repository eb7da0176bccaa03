"""Port parity: the AR trainer's updates, kinpoly_tpu_torch against
kinpoly_tpu, float64 on the CPU, on the train-mode envs of
``test_torch_env_ar.build_envs`` at small widths with the same initial
parameters in both packages: a few warm-start steps (``train_init``, the
init-state and the open-loop full-AR losses), and the composite update on
one fixed trajectory (the JAX agent's ``_rollout`` replaced on the
instance by a function that returns it; ``_rl_and_step_update`` called
without ``jax.jit``) in five modes: the default PPO + step BC,
``grad_joint`` + ``grad_alternate`` on a PPO and on a BC epoch,
``step_update_dyna`` and ``joint_controller``. Parameters, value parameters, controller parameters
and every metric are compared; the GRUs' r and z hidden biases stay
exactly 0. Checkpoints go both ways: the port's file into JAX's
``AgentAR.load_checkpoint`` and JAX's into the port's, with identical
action means."""

import dataclasses
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

from test_torch_env_ar import build_envs

torch.set_num_threads(1)

TOL = 1e-9           # parameters and metrics after a few float64 updates
SMALL = dict(rnn_hdim=16, mlp_hsize=(16,), add_noise=False)
T, N = 5, 4          # the fixed trajectory
CFG = dict(batch_size=3, fr_num=10, n_envs=N, rollout_steps=T,
           num_optim_epoch=2, num_step_update=2, seed=4)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.fixture(scope="module")
def ag():
    e = build_envs(mode="train", small=SMALL)
    jds = jsa.StateARDataset(e.takes, fr_num=CFG["fr_num"])
    jcfg = jaa.ARTrainConfig(**CFG)
    ja = jaa.AgentAR(e.jenv, jds, jcfg)
    ta = taa.AgentAR(e.tenv, e.ds, taa.ARTrainConfig(**CFG))
    init = dict(params=_f64(ja.params), value=_f64(ja.value_params),
                cc=_f64(e.jenv.cc_policy_params))
    ns = types.SimpleNamespace(e=e, ja=ja, ta=ta, init=init)
    ns.traj = _trajectory(ns)
    return ns


def reset(ns, **over):
    """Both agents at the initial parameters, fresh optimiser states and
    the window sampler at its seed (after the construction-time draw), in
    the config `over` changes."""
    ja, ta, init = ns.ja, ns.ta, ns.init
    ja.cfg = dataclasses.replace(jaa.ARTrainConfig(**CFG), **over)
    ta.cfg = dataclasses.replace(taa.ARTrainConfig(**CFG), **over)
    ja.params, ja.value_params, ja.cc_params = (init["params"], init["value"],
                                                init["cc"])
    ja.sup_opt_state = ja.sup_opt.init(ja.params)
    ja.pol_opt_state = ja.pol_opt.init(ja.params)
    ja.val_opt_state = ja.val_opt.init(ja.value_params)
    ja.cc_opt_state = ja.cc_opt.init(ja.cc_params)
    ta.policy.net.load_state_dict(weights.trajar_from_jax(init["params"]))
    ta.value.load_state_dict(weights.value_state_dict(init["value"]))
    ta.cc_policy.load_state_dict(weights.policy_state_dict(init["cc"]))
    for opt in (ta.sup_opt, ta.pol_opt, ta.val_opt, ta.cc_opt):
        opt.reset()
    for a in (ja, ta):
        a.np_rng = np.random.RandomState(CFG["seed"])
        a.dataset.get_batch(a.np_rng, 1)
        a.epoch, a.freq = 0, {}


def _trajectory(ns):
    """A (T, N) trajectory as a rollout records it: observations, sampled
    actions near the policy's means with their log-probs under the initial
    policy, rewards, episode ends, sim and ground-truth poses of the takes,
    and controller observations and actions."""
    reset(ns)
    e, ta = ns.e, ns.ta
    rng = np.random.RandomState(11)
    d = ta.policy.net.action_gru.weight_ih.shape[1]
    obs = rng.normal(0, 0.5, (T, N, d))
    masks = np.ones((T, N))
    masks[1, 0] = masks[3, 2] = 0.0
    prev = np.concatenate([np.ones((1, N)), masks[:-1]])
    with torch.no_grad():
        means = ta.policy.action_means_over_time(torch.tensor(obs),
                                                 torch.tensor(prev)).numpy()
    std = np.exp(ta.cfg.log_std)
    actions = means + std * rng.normal(0, 0.7, means.shape)
    log_probs = jnets.gaussian_log_prob(
        jnp.asarray(actions), jnp.asarray(means),
        jnp.full(means.shape, ta.cfg.log_std))
    q = e.clip.qpos                                         # (4 takes, 10, 76)
    pick = lambda off: np.stack([q[n % q.shape[0], t + off] for t in range(T)
                                 for n in range(N)]).reshape(T, N, 76)
    curr = pick(0) + rng.normal(0, 0.01, (T, N, 76))
    curr[..., 3:7] /= np.linalg.norm(curr[..., 3:7], axis=-1, keepdims=True)
    res = pick(1) + rng.normal(0, 0.02, (T, N, 76))
    res[..., 3:7] /= np.linalg.norm(res[..., 3:7], axis=-1, keepdims=True)
    cc_state = rng.normal(0, 1.0, (T, N, 784))
    with torch.no_grad():
        cc_mean = e.tenv.cc_policy(torch.tensor(cc_state))[0].numpy()
    traj = dict(
        obs=obs, actions=actions, rewards=rng.uniform(0.2, 0.9, (T, N)),
        masks=masks, log_probs=np.asarray(log_probs), gt_qpos=pick(1),
        curr_qpos=curr, res_qpos=res,
        cc_action=cc_mean + 0.1 * rng.normal(size=cc_mean.shape),
        cc_state=cc_state, fails=masks == 0, ends=np.zeros((T, N), bool),
        percents=rng.uniform(0, 1, (T, N)),
        clips=np.tile(np.arange(N), (T, 1)))
    return traj, rng.normal(0, 0.5, (N, d))


def _close(a, b, tol=TOL, what=""):
    """Within tol relative to max(1, |a|); float32 on the JAX side (its
    fail_frac and NaN-fraction metrics) within float32's rounding."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        tol = max(tol, 1e-7)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= tol * max(1.0, float(np.abs(a).max())), (what, err)


def _close_trees(jtree, ttree, tol=TOL):
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = dict(jax.tree_util.tree_leaves_with_path(ttree))
    assert len(jl) == len(tl)
    for path, x in jl:
        _close(x, tl[path], tol, jax.tree_util.keystr(path))


def _compare_params(ns, cc=False):
    ja, ta = ns.ja, ns.ta
    _close_trees(ja.params, weights.trajar_to_jax(ta.policy.net.state_dict()))
    _close_trees(ja.value_params, weights.value_params(ta.value.state_dict()))
    if cc:
        _close_trees(ja.cc_params,
                     weights.policy_params(ta.cc_policy.state_dict()))
    H = SMALL["rnn_hdim"]
    for name in ("context_gru.bias_hh_l0", "action_gru.bias_hh"):
        b = dict(ta.policy.net.named_parameters())[name]
        assert bool((b[:2 * H] == 0).all()), name


def test_train_init(ag):
    """Two init-state and two full-AR steps (gt_rate 0) on the same windows:
    the yielded losses and gradient NaN fractions, then the parameters."""
    reset(ag)
    yj = list(ag.ja.train_init(init_steps=2, full_steps=2, gt_rate=0.0,
                               log_every=1))
    yt = list(ag.ta.train_init(init_steps=2, full_steps=2, gt_rate=0.0,
                               log_every=1))
    assert [y[:2] for y in yj] == [y[:2] for y in yt]
    for a, b in zip(yj, yt):
        assert abs(a[2] - b[2]) <= TOL * max(1.0, abs(a[2])), (a, b)
        assert a[3] == b[3] == 0.0
    _compare_params(ag)


MODES = {
    "default": (dict(), 1.0, 1.0),
    "grad_joint_alternate_ppo": (dict(grad_joint=True, grad_alternate=True),
                                 1.0, 0.0),
    "grad_joint_alternate_bc": (dict(grad_joint=True, grad_alternate=True),
                                0.0, 1.0),
    "step_update_dyna": (dict(step_update_dyna=True), 1.0, 1.0),
    "joint_controller": (dict(joint_controller=True), 1.0, 1.0),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_composite_update(ag, mode):
    """The composite update on the fixed trajectory: every parameter of
    the policy, value net and controller, and every metric."""
    over, w_ppo, w_bc = MODES[mode]
    reset(ag, **over)
    raw, last_obs = ag.traj
    jtraj = jroa.ARTrajectory(**{k: jnp.asarray(v) for k, v in raw.items()})
    carry = types.SimpleNamespace(obs=jnp.asarray(last_obs))
    ja, ta = ag.ja, ag.ta
    ja._rollout = lambda c, p, ctx, mean_action=True, cc_params=None: (carry,
                                                                       jtraj)
    out = ja._rl_and_step_update(
        ja.params, ja.value_params, ja.pol_opt_state, ja.val_opt_state,
        ja.sup_opt_state, carry, None, jax.random.PRNGKey(0), ja.cc_params,
        ja.cc_opt_state, jnp.asarray(w_ppo), jnp.asarray(w_bc))
    (ja.params, ja.value_params, ja.pol_opt_state, ja.val_opt_state,
     ja.sup_opt_state, _, jm, _, _, _, ja.cc_params, ja.cc_opt_state) = out
    ttraj = troa.ARTrajectory(**{k: torch.tensor(v) for k, v in raw.items()})
    tm = ta.update(ttraj, torch.tensor(last_obs), w_ppo, w_bc)
    assert sorted(jm) == sorted(tm)
    for k in jm:
        _close(jm[k], tm[k], TOL, k)
    assert float(tm["ppo_grad_norm"]) > 0 or mode.endswith("_bc") is False
    _compare_params(ag, cc=True)
    with torch.no_grad():
        moved = float(max((p - q).abs().max() for p, q in zip(
            ta.cc_policy.parameters(), ag.e.tenv.cc_policy.parameters())))
    assert (moved > 0) == (mode == "joint_controller")


def test_checkpoints_both_ways(ag, tmp_path):
    """The port's checkpoint (after a joint-controller update) in JAX's
    AgentAR.load_checkpoint and JAX's in the port's: the same weights, and
    to rounding the same action means, value and controller means; the
    same epoch and success history; the controller's optimiser reset."""
    reset(ag, joint_controller=True)
    raw, last_obs = ag.traj
    ag.ta.update(troa.ARTrajectory(**{k: torch.tensor(v)
                                      for k, v in raw.items()}),
                 torch.tensor(last_obs))
    ag.ta.epoch, ag.ta.freq = 7, {2: [1.0, 0.0], 0: [0.0]}
    path = ag.ta.save_checkpoint(str(tmp_path / "iter_0007.p"))
    obs = raw["obs"][0]
    cc_obs = raw["cc_state"][0]

    def outputs_jax(a):
        m = a.policy.action_means_over_time(a.params, jnp.asarray(raw["obs"]),
                                            jnp.ones((T, N)))
        v = a.value.apply(a.value_params, jnp.asarray(obs))
        c = a.env.cc_policy_apply(a.cc_params, jnp.asarray(cc_obs))[0]
        return [np.asarray(x) for x in (m, v, c)]

    def outputs_torch(a):
        with torch.no_grad():
            m = a.policy.action_means_over_time(torch.tensor(raw["obs"]),
                                                torch.ones((T, N),
                                                           dtype=torch.float64))
            return [x.numpy() for x in (m, a.value(torch.tensor(obs)),
                                        a.cc_policy(torch.tensor(cc_obs))[0])]

    ag.ja.load_checkpoint(path)
    assert ag.ja.epoch == 7 and ag.ja.freq == ag.ta.freq
    # the same weights bit for bit; the outputs to rounding
    for jt, sd, write in ((ag.ja.params, ag.ta.policy.net, weights.trajar_to_jax),
                          (ag.ja.value_params, ag.ta.value, weights.value_params),
                          (ag.ja.cc_params, ag.ta.cc_policy,
                           weights.policy_params)):
        _close_trees(jt, write(sd.state_dict()), 0.0)
    for x, y in zip(outputs_jax(ag.ja), outputs_torch(ag.ta)):
        _close(x, y, 1e-12)

    reset(ag, joint_controller=True)
    ag.ja.epoch, ag.ja.freq = 3, {1: [1.0]}
    ag.ja.params = jax.tree.map(lambda x: x * 1.01, ag.ja.params)
    ag.ja.cc_params = jax.tree.map(lambda x: x * 0.99, ag.ja.cc_params)
    jpath = ag.ja.save_checkpoint(str(tmp_path / "iter_0003.p"))
    ag.ta.load_checkpoint(jpath)
    assert ag.ta.epoch == 3 and ag.ta.freq == {1: [1.0]}
    assert ag.ta.cc_opt.count == 0
    for x, y in zip(outputs_jax(ag.ja), outputs_torch(ag.ta)):
        _close(x, y, 1e-12)
