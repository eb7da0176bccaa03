"""Port parity: the data-parallel UHC step (``parallel/dryrun.py``
``dp_update``, the counterpart of the step in
``__graft_entry__.dryrun_multichip``) against that JAX step, float64 on
the CPU. The port's side runs in W spawned ranks over gloo (one pool per
W for the whole file); the JAX side is the step of
``tests/test_multichip.py`` under ``shard_map`` on W of the conftest's
virtual devices, with ``ppo.make_optimizers``' chains, and each shard's
block of a fixed, seeded (T, N) trajectory in place of its rollout.

Two steps on two trajectories: the merged norm (count, mean, M2), the
policy and value parameters and their Adam moments at 1e-9. The JAX
step's norm merge leaves out Chan's between-group term; a test pins that
the merged norm equals ``update_batch`` over the union at the first step
and falls short of it by exactly that term at the second. Then the
port's ``dryrun_multichip`` on 2 ranks at tiny widths, with
test_multichip's checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kinpoly_tpu.models import nets as jnets
from kinpoly_tpu.parallel import mesh as jmesh
from kinpoly_tpu.rl import gae as jgae
from kinpoly_tpu.rl import ppo as jppo
from kinpoly_tpu.rl import running_norm as jrn
from kinpoly_tpu_torch.models import nets as tnets
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.parallel.dryrun import dryrun_multichip
from kinpoly_tpu_torch.parallel.ranks import RankPool
from kinpoly_tpu_torch.rl import ppo as tppo
from kinpoly_tpu_torch.rl import running_norm as trn

import torch_dp_jobs as jobs

torch.set_num_threads(1)

WORLDS = (2, 4)
TOL = 1e-9           # parameters, moments and norm after two Adam steps
OBS, ACT = 12, 5
T, N = 3, 8          # the fixed trajectories; N divides by every W


@pytest.fixture(scope="module")
def ranks():
    """pool(W): W ranks over gloo on the CPU, started once per W."""
    pools = {}

    def get(w):
        if w not in pools:
            pools[w] = RankPool(w, "gloo", "cpu")
        return pools[w]

    yield get
    for p in pools.values():
        p.close()


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _nets():
    """Narrow JAX nets (float64 params) and the port's, carrying the same
    weights."""
    jpol = jnets.PolicyMCP(action_dim=ACT, num_primitive=3, hidden=(16, 8),
                           composer_hidden=(10, 6))
    jval = jnets.Value(hidden=(16, 8))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pp = _f64(jpol.init(k1, jnp.zeros((1, OBS))))
    vp = _f64(jval.init(k2, jnp.zeros((1, OBS))))
    tpol = tnets.PolicyMCP(OBS, ACT, num_primitive=3, hidden=(16, 8),
                           composer_hidden=(10, 6)).double()
    tpol.load_state_dict(weights.policy_state_dict(jax.device_get(pp)))
    tval = tnets.Value(OBS, (16, 8)).double()
    tval.load_state_dict(weights.value_state_dict(jax.device_get(vp)))
    return jpol, jval, pp, vp, tpol, tval


def _trajectory(jpol, pp, seed):
    """A (T, N) rollout record: raw and normalised observations, actions
    sampled near the policy's means with their log-probs, rewards and two
    episode ends; and the raw observation after the last step."""
    rng = np.random.RandomState(seed)
    raw = rng.normal(0.3, 1.5, (T, N, OBS))
    obs = rng.normal(0, 1, (T, N, OBS))
    mean, log_std = jpol.apply(pp, jnp.asarray(obs))
    actions = np.asarray(mean) + 0.1 * rng.normal(size=(T, N, ACT))
    log_probs = np.asarray(jnets.gaussian_log_prob(
        jnp.asarray(actions), mean, log_std)) + 0.05 * rng.normal(size=(T, N))
    masks = np.ones((T, N))
    masks[0, 1] = masks[1, 6] = 0.0
    return (dict(obs=obs, raw_obs=raw, actions=actions, log_probs=log_probs,
                 rewards=rng.uniform(0, 1, (T, N)), masks=masks),
            rng.normal(0.3, 1.5, (N, OBS)))


def _jax_steps(w, jpol, jval, pp, vp, trajs, cfg):
    """The JAX data-parallel step of tests/test_multichip.py, each shard's
    rollout replaced by its block of the trajectory: the norm after each
    step, the final parameters and optimiser states."""
    pol_opt, val_opt = jppo.make_optimizers(cfg)

    def per_shard(tr, last_obs, pp, vp, po, vo, norm):
        local = jrn.update_batch(jrn.init(OBS, tr["raw_obs"].dtype),
                                 tr["raw_obs"])
        tot = jax.lax.psum(local.count, "dp")
        mean = jax.lax.psum(local.mean * local.count, "dp") / tot
        m2 = jax.lax.psum(
            local.m2 + local.count * (local.mean - mean) ** 2, "dp")
        merged = jrn.RunningNorm(norm.count + tot,
                                 (norm.mean * norm.count + mean * tot)
                                 / (norm.count + tot), norm.m2 + m2)
        values = jval.apply(vp, tr["obs"])
        boot = jval.apply(vp, jrn.apply(norm, last_obs))
        adv, ret = jgae.estimate_advantages(tr["rewards"], tr["masks"], values,
                                            cfg.gamma, cfg.tau, boot)
        flat = lambda x: x.reshape((T * (N // w),) + x.shape[2:])

        def v_loss(v_):
            return jnp.mean((jval.apply(v_, flat(tr["obs"])) - flat(ret)) ** 2)

        def p_loss(p_):
            m, ls = jpol.apply(p_, flat(tr["obs"]))
            lp = jnets.gaussian_log_prob(flat(tr["actions"]), m, ls)
            ratio = jnp.exp(lp - flat(tr["log_probs"]))
            a = flat(adv)
            return -jnp.mean(jnp.minimum(
                ratio * a, jnp.clip(ratio, 1 - cfg.clip_epsilon,
                                    1 + cfg.clip_epsilon) * a))

        vg = jax.lax.pmean(jax.grad(v_loss)(vp), "dp")
        pg = jax.lax.pmean(jax.grad(p_loss)(pp), "dp")
        vu, vo2 = val_opt.update(vg, vo, vp)
        pu, po2 = pol_opt.update(pg, po, pp)
        return (optax.apply_updates(pp, pu), optax.apply_updates(vp, vu),
                po2, vo2, merged)

    step = jax.jit(jax.shard_map(
        per_shard, mesh=jmesh.make_mesh(w),
        in_specs=(P(None, "dp"), P("dp"), P(), P(), P(), P(), P()),
        out_specs=P(), check_vma=False))
    po, vo, norm = pol_opt.init(pp), val_opt.init(vp), jrn.init(OBS)
    norms = []
    for raw, last_obs in trajs:
        pp, vp, po, vo, norm = step(
            {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(last_obs),
            pp, vp, po, vo, norm)
        norms.append(norm)
    return norms, pp, vp, po, vo


def _adam(state):
    """(mu, nu) of an optax chain's Adam state."""
    for s in jax.tree.leaves(state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise ValueError("no Adam state")


def _close(a, b, tol=TOL, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(a).max())), (what, err)


def _close_trees(jtree, ttree, tol=TOL):
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = dict(jax.tree_util.tree_leaves_with_path(ttree))
    assert len(jl) == len(tl)
    for path, x in jl:
        _close(x, tl[path], tol, jax.tree_util.keystr(path))


_RUNS = {}


def _run(ranks, w):
    """Both packages' two steps at W ranks (computed once per W)."""
    if w not in _RUNS:
        jpol, jval, pp, vp, tpol, tval = _nets()
        trajs = [_trajectory(jpol, pp, s) for s in (5, 6)]
        cfg = jppo.PPOConfig()
        tcfg = tppo.PPOConfig()
        got = ranks(w).run(jobs.dp_update_job, tpol, tval, OBS, trajs, tcfg)
        want = _jax_steps(w, jpol, jval, pp, vp, trajs, cfg)
        _RUNS[w] = (got, want, trajs, pp, vp)
    return _RUNS[w]


@pytest.mark.parametrize("w", WORLDS)
def test_dp_update_matches_jax(ranks, w):
    got, (jnorms, pp, vp, po, vo), _, pp0, _ = _run(ranks, w)
    for r in range(w):
        for step in range(2):
            for name, a, b in zip(("count", "mean", "m2"), jnorms[step],
                                  got[r]["norms"][step]):
                _close(a, b, TOL, f"step {step} {name}")
        _close_trees(pp, weights.policy_params(
            {k: torch.tensor(v) for k, v in got[r]["policy"].items()}))
        _close_trees(vp, weights.value_params(
            {k: torch.tensor(v) for k, v in got[r]["value"].items()}))
        for (mu, nu), moments, conv in (
                (_adam(po), got[r]["pol_moments"], weights.policy_params),
                (_adam(vo), got[r]["val_moments"], weights.value_params)):
            for i, want in enumerate((mu, nu)):
                _close_trees(want, conv({k: torch.tensor(v[i])
                                         for k, v in moments.items()}))
        # the replicas stay bitwise equal
        for k in ("policy", "value"):
            for name, v in got[r][k].items():
                np.testing.assert_array_equal(v, got[0][k][name])
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in
                zip(jax.tree.leaves(pp), jax.tree.leaves(pp0)))
    assert moved > 1e-6
    assert float(jnorms[1][0]) == 2 * T * N


@pytest.mark.parametrize("w", WORLDS)
def test_norm_merge_drops_cross_term(ranks, w):
    """The merge equals update_batch over all ranks' samples at the first
    step (the norm was empty) and falls short of it at the second by
    Chan's between-group term (mean_b - mean)^2 n n_b / (n + n_b)."""
    got, _, trajs, _, _ = _run(ranks, w)
    n1, n2 = [trn.RunningNorm(*map(torch.tensor, x)) for x in got[0]["norms"]]
    x1, x2 = (torch.tensor(t[0]["raw_obs"]) for t in trajs)
    full1 = trn.update_batch(trn.init(OBS), x1)
    for a, b in zip(n1, full1):
        _close(b.numpy(), a.numpy(), 1e-12)
    full2 = trn.update_batch(n1, x2)
    _close(full2.count.numpy(), n2.count.numpy(), 0.0)
    _close(full2.mean.numpy(), n2.mean.numpy(), 1e-12)
    flat = x2.reshape(-1, OBS)
    n_b, mean_b = flat.shape[0], flat.mean(dim=0)
    term = (mean_b - n1.mean) ** 2 * float(n1.count) * n_b / (
        float(n1.count) + n_b)
    assert float(term.min()) > 1e-3
    _close((full2.m2 - n2.m2).numpy(), term.numpy(), 1e-9)


def test_dryrun_multichip():
    """dryrun_multichip on 2 ranks at tiny widths, two steps: the norm
    counts every rank's samples (2 ranks x 4 envs x 2 control steps per
    step), the nets are bitwise equal across ranks, finite, and moved."""
    res = dryrun_multichip(2, device="cpu", steps=2)
    assert [r["counts"] for r in res] == [[16.0, 32.0]] * 2
    for r in res:
        assert r["gaps"] == [0.0, 0.0] and r["finite"] and r["moved"] > 0
        for k, v in r["policy"].items():
            assert torch.equal(v, res[0]["policy"][k])
