"""Port parity of the UHC training pieces against kinpoly_tpu, float64 on
the CPU: the running-norm update, GAE, the Gaussian log-density and one
PPO update. The training resets and the rollout are in
test_torch_rollout.py, the whole ``train_epoch`` in
test_torch_train_epoch.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.models import nets as jnets
from kinpoly_tpu.rl import gae as jgae
from kinpoly_tpu.rl import ppo as jppo
from kinpoly_tpu.rl import running_norm as jrn
from kinpoly_tpu_torch.models import nets as tnets
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.rl import gae as tgae
from kinpoly_tpu_torch.rl import ppo as tppo
from kinpoly_tpu_torch.rl import running_norm as trn

TIGHT = 1e-12       # closed-form float64 arithmetic
PPO_TOL = 1e-9      # parameters after Adam steps in float64


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
    assert err <= tol, err
    return err


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)


def test_update_batch_exact():
    """Chan's merge from empty stats and onto them again, on dyadic data
    whose sums are exact in any order: the port equals JAX bit for bit,
    float32 count included."""
    rng = np.random.RandomState(0)
    x1 = rng.randint(-64, 64, (4, 2, 9)).astype(np.float32) / 8
    x2 = rng.randint(-64, 64, (8, 4, 9)).astype(np.float64) / 16
    jn, tn = jrn.init(9), trn.init(9)
    for x in (x1, x2):
        jn = jrn.update_batch(jn, jnp.asarray(x))
        tn = trn.update_batch(tn, torch.tensor(x))
        for a, b in zip(tn, jn):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tn.count.dtype == torch.float32 and float(tn.count) == 40.0
    _close(trn.apply(tn, torch.tensor(x2)).numpy(),
           jrn.apply(jn, jnp.asarray(x2)), TIGHT)


def test_estimate_advantages():
    rng = np.random.RandomState(1)
    T, N = 7, 5
    rewards, values = rng.rand(T, N), rng.randn(T, N)
    masks = (rng.rand(T, N) > 0.3).astype(np.float64)
    boot = rng.randn(N)
    for b in (boot, None):
        adv_j, ret_j = jgae.estimate_advantages(
            jnp.asarray(rewards), jnp.asarray(masks), jnp.asarray(values),
            0.95, 0.95, None if b is None else jnp.asarray(b))
        adv_t, ret_t = tgae.estimate_advantages(
            torch.tensor(rewards), torch.tensor(masks), torch.tensor(values),
            0.95, 0.95, None if b is None else torch.tensor(b))
        _close(adv_t.numpy(), adv_j, TIGHT)
        _close(ret_t.numpy(), ret_j, TIGHT)
    assert abs(float(adv_t.std(correction=0)) - 1.0) < 1e-6


def test_gaussian_log_prob():
    rng = np.random.RandomState(2)
    x, mean = rng.randn(6, 75), rng.randn(6, 75)
    log_std = rng.uniform(-3, 0, (6, 75))
    _close(tnets.gaussian_log_prob(*map(torch.tensor, (x, mean, log_std))).numpy(),
           jnets.gaussian_log_prob(x, mean, log_std), TIGHT)


OBS, ACT = 12, 5


def _small_nets(seed: int, fix_std: bool = True):
    """Narrow JAX nets (float64 params) and the port's nets carrying the
    same weights."""
    jpol = jnets.PolicyMCP(action_dim=ACT, num_primitive=3, hidden=(16, 8),
                           composer_hidden=(10, 6), fix_std=fix_std)
    jval = jnets.Value(hidden=(16, 8))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    pp = _f64(jpol.init(k1, jnp.zeros((1, OBS))))
    vp = _f64(jval.init(k2, jnp.zeros((1, OBS))))
    tpol = tnets.PolicyMCP(OBS, ACT, num_primitive=3, hidden=(16, 8),
                           composer_hidden=(10, 6), fix_std=fix_std).double()
    tpol.load_state_dict(weights.policy_state_dict(jax.device_get(pp)))
    tval = tnets.Value(OBS, (16, 8)).double()
    tval.load_state_dict(weights.value_state_dict(jax.device_get(vp)))
    return jpol, jval, pp, vp, tpol, tval


@pytest.mark.parametrize("adv_scale,clipped", [(0.3, False), (3e3, True)])
def test_ppo_update(adv_scale, clipped):
    """One PPO update (3 epochs of one minibatch holding the whole batch,
    so the permutation cannot matter): the same weights, data and
    optimiser settings give the same parameters and losses. With the
    advantages scaled up the gradient's global norm exceeds 40 and the
    clip acts."""
    jpol, jval, pp, vp, tpol, tval = _small_nets(0, fix_std=False)
    rng = np.random.RandomState(3)
    B = 24
    obs, actions = rng.randn(B, OBS), rng.randn(B, ACT) * 0.3
    adv, ret = rng.randn(B) * adv_scale, rng.randn(B)
    mean0, log_std0 = jpol.apply(pp, obs)
    flp = np.asarray(jnets.gaussian_log_prob(actions, mean0, log_std0)) + \
        rng.randn(B) * 0.05
    cfg = jppo.PPOConfig(num_optim_epoch=3, mini_batch_size=64)

    def pl_fn(p):
        m, s = jpol.apply(p, obs)
        ratio = jnp.exp(jnets.gaussian_log_prob(actions, m, s) - flp)
        return -jnp.mean(jnp.minimum(
            ratio * adv, jnp.clip(ratio, 0.8, 1.2) * adv))
    gnorm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in
                               jax.tree.leaves(jax.grad(pl_fn)(pp)))))
    assert (gnorm > cfg.max_grad_norm) == clipped, gnorm

    popt, vopt = jppo.make_optimizers(cfg)
    ts = jppo.TrainState(pp, vp, popt.init(pp), vopt.init(vp))
    ts, jm = jppo.ppo_update(jpol.apply, jval.apply, cfg, ts,
                             jax.random.PRNGKey(0),
                             *map(jnp.asarray, (obs, actions, adv, ret, flp)),
                             popt, vopt)
    tcfg = tppo.PPOConfig(num_optim_epoch=3, mini_batch_size=64)
    topt, tvopt = tppo.make_optimizers(tpol, tval, tcfg)
    tm = tppo.ppo_update(tpol, tval, tcfg, topt, tvopt,
                         torch.Generator().manual_seed(0),
                         *map(torch.tensor, (obs, actions, adv, ret, flp)))
    for k in ("policy_loss", "value_loss"):
        _close(tm[k].numpy(), jm[k], PPO_TOL)
    got_p = weights.policy_params(tpol.state_dict())
    got_v = weights.value_params(tval.state_dict())
    moved = 0.0
    for got, want, start in ((got_p, ts.policy_params, pp),
                             (got_v, ts.value_params, vp)):
        for g, w, s in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                           jax.tree.leaves(start)):
            _close(g, w, PPO_TOL)
            moved = max(moved, float(np.abs(np.asarray(w) - np.asarray(s)).max()))
    assert moved > 1e-5


def test_ppo_lr_mult_scales_the_update():
    """lr_mult scales Adam's update, not the gradient: half the multiplier,
    half the step."""
    steps = []
    for mult in (1.0, 0.5):
        _, _, _, _, tpol, tval = _small_nets(1)
        before = [p.detach().clone() for p in tpol.parameters()]
        cfg = tppo.PPOConfig(num_optim_epoch=1, mini_batch_size=64)
        opt, vopt = tppo.make_optimizers(tpol, tval, cfg)
        rng = np.random.RandomState(4)
        obs = torch.tensor(rng.randn(8, OBS))
        with torch.no_grad():
            mean, log_std = tpol(obs)
            actions = mean + 0.1 * torch.tensor(rng.randn(8, ACT))
            flp = tnets.gaussian_log_prob(actions, mean, log_std)
        tppo.ppo_update(tpol, tval, cfg, opt, vopt,
                        torch.Generator().manual_seed(0), obs, actions,
                        torch.tensor(rng.randn(8)), torch.tensor(rng.randn(8)),
                        flp, lr_mult=mult)
        steps.append(torch.cat([(p.detach() - b).flatten() for p, b in
                                zip(tpol.parameters(), before)]))
    assert float(steps[0].abs().max()) > 1e-6
    torch.testing.assert_close(steps[1], 0.5 * steps[0], rtol=1e-9, atol=1e-15)
