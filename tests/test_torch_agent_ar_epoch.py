"""Port parity: one whole composite epoch of the AR trainer
(``optimize_policy``: window sampling, context build, the sampled rollout
through the physics with the controller in the loop, the step-BC epochs
and the success history), kinpoly_tpu_torch against kinpoly_tpu, float64
on the CPU, with ``rl_update`` off and the policy's and the controller's
log-std at -30 (their samples differ from the means by about 1e-13, so
the two packages' different random streams do not matter)."""

import types

import jax
import numpy as np
import pytest
import torch

from kinpoly_tpu.data import statear as jsa
from kinpoly_tpu.rl import agent_ar as jaa
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.rl import agent_ar as taa

from test_torch_env_ar import build_envs

torch.set_num_threads(1)

TOL = 1e-6           # after a 3-step rollout through the physics and 2 BC epochs
SMALL = dict(rnn_hdim=16, mlp_hsize=(16,), add_noise=False)
CFG = dict(batch_size=3, fr_num=10, n_envs=4, rollout_steps=3,
           num_optim_epoch=2, num_step_update=2, seed=4, log_std=-30.0,
           rl_update=False)


class Float64Dataset(jsa.StateARDataset):
    """The JAX dataset with its float32 fields (the 14-d object pose) in
    float64: the JAX control step's scan carries the object state in the
    context's dtype."""

    def get_batch(self, *args, **kw):
        b = super().get_batch(*args, **kw)
        return type(b)(*(x.astype(np.float64) if x is not None
                         and x.dtype == np.float32 else x for x in b))


@pytest.fixture(scope="module")
def epoch():
    e = build_envs(mode="train", cc_log_std=-30.0, small=SMALL)
    ja = jaa.AgentAR(e.jenv, Float64Dataset(e.takes, fr_num=10),
                     jaa.ARTrainConfig(**CFG))
    ta = taa.AgentAR(e.tenv, e.ds, taa.ARTrainConfig(**CFG))
    f64 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float64), t)
    ja.params, ja.value_params = f64(ja.params), f64(ja.value_params)
    ja.sup_opt_state = ja.sup_opt.init(ja.params)
    ja.pol_opt_state = ja.pol_opt.init(ja.params)
    ja.val_opt_state = ja.val_opt.init(ja.value_params)
    ta.policy.net.load_state_dict(weights.trajar_from_jax(ja.params))
    ta.value.load_state_dict(weights.value_state_dict(ja.value_params))
    return types.SimpleNamespace(ja=ja, ta=ta, mj=ja.optimize_policy(),
                                 mt=ta.optimize_policy())


def test_metrics(epoch):
    mj, mt = epoch.mj, epoch.mt
    assert sorted(mj) == sorted(mt)
    for k in mj:
        if k != "T_iter":
            assert abs(mj[k] - mt[k]) <= TOL * max(1.0, abs(mj[k])), k
    assert mt["ppo_loss"] == mt["ppo_grad_norm"] == mt["ratio_dev"] == 0.0
    assert mt["bc_loss"] > 0 and np.isfinite(mt["reward_mean"])


def test_parameters_and_history(epoch):
    ja, ta = epoch.ja, epoch.ta
    jl = jax.tree_util.tree_leaves_with_path(ja.params)
    tl = dict(jax.tree_util.tree_leaves_with_path(
        weights.trajar_to_jax(ta.policy.net.state_dict())))
    for path, x in jl:
        err = float(np.abs(np.asarray(x) - tl[path]).max())
        assert err <= TOL, (jax.tree_util.keystr(path), err)
    assert ja.epoch == ta.epoch == 1
    assert ja.freq == ta.freq
    assert ta.sup_opt.count == 2 and ta.pol_opt.count == 0
