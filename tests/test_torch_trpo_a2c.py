"""Port parity of the TRPO and A2C updates (kinpoly_tpu_torch.rl.trpo,
rl.a2c) against kinpoly_tpu.rl.trpo and rl.a2c, float64 on the CPU, on a
PolicyGaussian (fixed and learnable log-std) and a Value at small widths
with flax-initialised weights carried across: the new parameters within
1e-8, ``accepted`` and ``lm`` equal (lm within 1e-8); a line search that
accepts no step leaves the parameters as they were in both. A2C runs Adam
on both sides (optax.adam and torch.optim.Adam, eps 1e-8), with and
without the L2 term on the value net, for three updates."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kinpoly_tpu.models import nets as jnets
from kinpoly_tpu.rl import a2c as ja2c
from kinpoly_tpu.rl import trpo as jtrpo
from kinpoly_tpu_torch.models import nets as tnets
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.rl import a2c as ta2c
from kinpoly_tpu_torch.rl import trpo as ttrpo

torch.set_num_threads(1)

TOL = 1e-8
OBS, ACT, HID, N = 12, 4, (24, 16), 64


def f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def _leaves_close(a, b, tol=TOL):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, (x.shape, y.shape)
        err = float(np.abs(x - y).max())
        assert err < tol, err


def setup(fix_std=True, seed=0):
    jpol = jnets.PolicyGaussian(ACT, hidden=HID, fix_std=fix_std, log_std_init=-1.0)
    jval = jnets.Value(hidden=HID)
    rng = np.random.RandomState(seed)
    obs = rng.randn(N, OBS)
    pp = f64(jpol.init(jax.random.PRNGKey(seed), jnp.asarray(obs)))
    vp = f64(jval.init(jax.random.PRNGKey(seed + 1), jnp.asarray(obs)))
    mean, log_std = jpol.apply(pp, jnp.asarray(obs))
    actions = np.asarray(mean) + 0.3 * rng.randn(N, ACT)
    adv = rng.randn(N)
    ret = rng.randn(N)
    flp = np.asarray(jnets.gaussian_log_prob(jnp.asarray(actions), mean, log_std))
    tpol = tnets.PolicyGaussian(OBS, ACT, HID, fix_std=fix_std, log_std_init=-1.0).double()
    tpol.load_state_dict(weights.policy_state_dict(pp))
    tval = tnets.Value(OBS, HID).double()
    tval.load_state_dict(weights.value_state_dict(vp))
    return jpol, jval, pp, vp, tpol, tval, (obs, actions, adv, ret, flp)


def _port_policy_params(tpol):
    return weights.policy_params({k: v.detach() for k, v in tpol.state_dict().items()})


@pytest.mark.parametrize("fix_std", [True, False])
def test_trpo_update_matches_jax(fix_std):
    jpol, _, pp, _, tpol, _, (obs, actions, adv, _, flp) = setup(fix_std)
    cfg = jtrpo.TRPOConfig()
    jnew, jinfo = jtrpo.trpo_update(jpol.apply, cfg, pp, jnp.asarray(obs),
                                    jnp.asarray(actions), jnp.asarray(adv),
                                    jnp.asarray(flp))
    tnew, tinfo = ttrpo.trpo_update(
        tpol, ttrpo.TRPOConfig(), dict(tpol.named_parameters()),
        *(torch.tensor(x) for x in (obs, actions, adv, flp)))
    assert bool(jinfo["accepted"]) and bool(tinfo["accepted"])
    np.testing.assert_allclose(float(tinfo["lm"]), float(jinfo["lm"]), rtol=TOL, atol=0)
    np.testing.assert_allclose(float(tinfo["loss0"]), float(jinfo["loss0"]),
                               rtol=0, atol=1e-12)
    with torch.no_grad():
        for k, v in tnew.items():
            tpol.get_parameter(k).copy_(v)
    _leaves_close(jnew, _port_policy_params(tpol))

    def surr(mean, log_std):
        lp = tnets.gaussian_log_prob(torch.tensor(actions), mean, log_std)
        return float(-torch.mean(torch.exp(lp - torch.tensor(flp)) * torch.tensor(adv)))
    with torch.no_grad():
        assert surr(*tpol(torch.tensor(obs))) < float(tinfo["loss0"])


def test_trpo_rejected_step_keeps_the_parameters():
    jpol, _, pp, _, tpol, _, (obs, actions, adv, _, flp) = setup(seed=3)
    cfg = jtrpo.TRPOConfig(accept_ratio=1e9)
    jnew, jinfo = jtrpo.trpo_update(jpol.apply, cfg, pp, jnp.asarray(obs),
                                    jnp.asarray(actions), jnp.asarray(adv),
                                    jnp.asarray(flp))
    params = dict(tpol.named_parameters())
    tnew, tinfo = ttrpo.trpo_update(
        tpol, ttrpo.TRPOConfig(accept_ratio=1e9), params,
        *(torch.tensor(x) for x in (obs, actions, adv, flp)))
    assert not bool(jinfo["accepted"]) and not bool(tinfo["accepted"])
    for x, y in zip(jax.tree_util.tree_leaves(jnew), jax.tree_util.tree_leaves(pp)):
        np.testing.assert_array_equal(np.asarray(x), y)
    for k, v in tnew.items():
        assert torch.equal(v, params[k].detach())
    np.testing.assert_allclose(float(tinfo["lm"]), float(jinfo["lm"]), rtol=TOL, atol=0)


def test_conjugate_gradient_matches_jax():
    rng = np.random.RandomState(4)
    M = rng.randn(6, 6)
    A = M @ M.T + 6 * np.eye(6)
    b = rng.randn(6)
    jx = jtrpo.conjugate_gradient(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), 4)
    tx = ttrpo.conjugate_gradient(lambda v: [torch.tensor(A) @ v[0]], [torch.tensor(b)], 4)
    np.testing.assert_allclose(tx[0].numpy(), np.asarray(jx), rtol=0, atol=1e-12)


@pytest.mark.parametrize("l2_reg", [0.0, 1e-3])
def test_a2c_update_matches_jax(l2_reg):
    jpol, jval, pp, vp, tpol, tval, (obs, actions, adv, ret, _) = setup(seed=5)
    p_opt, v_opt = optax.adam(1e-3), optax.adam(1e-3)
    pos, vos = p_opt.init(pp), v_opt.init(vp)
    tp_opt = torch.optim.Adam(tpol.parameters(), lr=1e-3, eps=1e-8)
    tv_opt = torch.optim.Adam(tval.parameters(), lr=1e-3, eps=1e-8)
    data = [jnp.asarray(x) for x in (obs, actions, adv, ret)]
    tdata = [torch.tensor(x) for x in (obs, actions, adv, ret)]
    for _ in range(3):
        pp, vp, pos, vos, jinfo = ja2c.a2c_update(
            jpol.apply, jval.apply, p_opt, v_opt, pp, vp, pos, vos, *data,
            l2_reg=l2_reg)
        tinfo = ta2c.a2c_update(tpol, tval, tp_opt, tv_opt, *tdata, l2_reg=l2_reg)
        for k in ("policy_loss", "value_loss"):
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), rtol=0, atol=TOL)
    _leaves_close(pp, _port_policy_params(tpol))
    _leaves_close(vp, weights.value_params({k: v.detach() for k, v in tval.state_dict().items()}))
