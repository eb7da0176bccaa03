"""Port parity: the AR update's data-parallel branch (``AgentAR.update``
with a process group, the counterpart of the JAX config's ``axis_name``),
kinpoly_tpu_torch against kinpoly_tpu, float64 on the CPU.

The JAX side is ``_rl_and_step_update`` with ``axis_name="dp"`` under
``shard_map`` over W of the conftest's virtual devices, on the agent
copy of ``tests/test_multichip.py``, each shard's ``_rollout`` returning
its block of ``test_torch_agent_ar``'s fixed (T, N) trajectory and every
shard's metrics returned (``out_specs=P("dp")``). The port's side is W
spawned ranks over gloo (one pool per W for the whole file), each calling
``AgentAR.update`` on its block. Three modes reach all six gradient means
of the JAX update: the default PPO + step BC (the value, policy and BC
gradients), ``grad_joint`` (the joint epochs' value and policy
gradients) and ``step_update_dyna`` with ``joint_controller`` (the BC
gradients toward both targets and the controller's). Policy, value and
controller parameters, and rank r's metrics against shard r's, at
``TOL``; the ranks' parameters bitwise equal.

Then the whole data-parallel AR step (``parallel/dryrun.py``
``dp_ar_step``: context, rollout and update) on 2 ranks, rank 1 drawing
other windows: the contexts the rollouts start from are rank 0's on
every rank, each rank's clips are the block JAX's ``shard_batch`` gives
its device, and the ranks' nets are bitwise equal after the update.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kinpoly_tpu.parallel import mesh as jmesh
from kinpoly_tpu.rl import rollout_ar as jroa
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.parallel.ranks import RankPool

import torch_dp_jobs as jobs
from test_torch_agent_ar import TOL, _close, _close_trees, ag, reset  # noqa: F401

torch.set_num_threads(1)

WORLDS = (2, 4)
MODES = {
    "default": dict(),
    "grad_joint": dict(grad_joint=True),
    "dyna_joint_controller": dict(step_update_dyna=True,
                                  joint_controller=True),
}
# what AgentAR.update reads of the agent (no env or dataset)
AGENT_STATE = ("cfg", "device", "dtype", "policy", "value", "cc_policy",
               "sup_opt", "pol_opt", "val_opt", "cc_opt", "phase_s")


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


def _jax_dp(ns, w):
    """The JAX update under shard_map over W devices, from the agent's
    current state: (params, value params, controller params, metrics with
    one entry per shard)."""
    ja = ns.ja
    agent_dp = type(ja).__new__(type(ja))
    agent_dp.__dict__.update(ja.__dict__)
    agent_dp.cfg = dataclasses.replace(ja.cfg, axis_name="dp")
    raw, last_obs = ns.traj

    def per_shard(params, vp, pol_s, val_s, sup_s, cc_params, cc_s, traj,
                  last):
        carry = types.SimpleNamespace(obs=last)
        agent_dp._rollout = (lambda c, p, ctx, mean_action=True,
                             cc_params=None: (carry, traj))
        out = agent_dp._rl_and_step_update(
            params, vp, pol_s, val_s, sup_s, carry, None,
            jax.random.PRNGKey(0), cc_params, cc_s, jnp.asarray(1.0),
            jnp.asarray(1.0))
        params, vp, _, _, _, _, metrics, _, _, _, cc_params, _ = out
        return params, vp, cc_params, {k: v[None] for k, v in metrics.items()}

    step = jax.jit(jax.shard_map(
        per_shard, mesh=jmesh.make_mesh(w),
        in_specs=(P(),) * 7 + (P(None, "dp"), P("dp")),
        out_specs=(P(), P(), P(), P("dp")), check_vma=False))
    return step(ja.params, ja.value_params, ja.pol_opt_state,
                ja.val_opt_state, ja.sup_opt_state, ja.cc_params,
                ja.cc_opt_state,
                jroa.ARTrajectory(**{k: jnp.asarray(v) for k, v in raw.items()}),
                jnp.asarray(last_obs))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_dp_update(ag, ranks, mode, w):
    reset(ag, **MODES[mode])
    params, vp, cc, jm = _jax_dp(ag, w)
    state = {k: getattr(ag.ta, k) for k in AGENT_STATE}
    raw, last_obs = ag.traj
    got = ranks(w).run(jobs.ar_update_job, state, raw, last_obs)
    t = lambda sd: {k: torch.tensor(v) for k, v in sd.items()}
    for r, g in enumerate(got):
        _close_trees(params, weights.trajar_to_jax(t(g["policy"])))
        _close_trees(vp, weights.value_params(t(g["value"])))
        _close_trees(cc, weights.policy_params(t(g["cc"])))
        assert sorted(g["metrics"]) == sorted(jm)
        for k, v in g["metrics"].items():
            _close(np.asarray(jm[k])[r], v, TOL, f"rank {r} {k}")
        for net in ("policy", "value", "cc"):
            for k, v in g[net].items():
                np.testing.assert_array_equal(v, got[0][net][k])
    # the ranks' own metrics differ (their blocks do)
    assert len({float(g["metrics"]["reward_mean"]) for g in got}) == w
    assert float(got[0]["metrics"]["ppo_grad_norm"]) > 0
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in
                zip(jax.tree.leaves(cc), jax.tree.leaves(ag.init["cc"])))
    assert (moved > 0) == MODES[mode].get("joint_controller", False)


@pytest.mark.parametrize("other_windows", [False, True])
def test_dp_ar_step(ag, ranks, other_windows):
    w = 2
    reset(ag, joint_controller=True)
    state = {k: v for k, v in ag.ta.__dict__.items()
             if k not in ("_rollout", "generator")}
    got = ranks(w).run(jobs.ar_step_job, state, other_windows)
    n = ag.ta.cfg.n_envs
    want = jmesh.shard_batch(jmesh.make_mesh(w),
                             jnp.arange(n) % got[0]["ctx"]["qpos"].shape[0])
    shards = {s.device: np.asarray(s.data) for s in want.addressable_shards}
    for r, (g, dev) in enumerate(zip(got, jmesh.make_mesh(w).devices.flat)):
        np.testing.assert_array_equal(g["clips"], shards[dev])
        assert sorted(g["ctx"]) == sorted(got[0]["ctx"])
        for k, v in g["ctx"].items():
            np.testing.assert_array_equal(v, got[0]["ctx"][k], err_msg=k)
        assert g["gaps"][1] == 0.0
        assert (g["gaps"][0] > 0) == other_windows
        for net in ("policy", "value", "cc"):
            for k, v in g[net].items():
                np.testing.assert_array_equal(v, got[0][net][k])
        assert np.isfinite(list(g["metrics"].values())).all()
    # the ranks rolled out different envs, and the update moved the nets
    assert got[0]["metrics"]["reward_mean"] != got[1]["metrics"]["reward_mean"]
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in
                zip(jax.tree.leaves(weights.policy_params(
                    {k: torch.tensor(v) for k, v in got[0]["cc"].items()})),
                    jax.tree.leaves(ag.init["cc"])))
    assert moved > 0
