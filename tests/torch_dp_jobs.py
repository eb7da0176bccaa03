"""Jobs that the data-parallel tests (``test_torch_mesh.py``,
``test_torch_dp_uhc.py``, ``test_torch_dp_ar.py``) run inside the ranks of
a ``kinpoly_tpu_torch.parallel.ranks.RankPool``. The ranks import this
module by name, so it imports torch and the port only, never JAX."""

import numpy as np
import torch
import torch.distributed as dist

from kinpoly_tpu_torch.parallel import mesh


def shard_job(rk, tree):
    return mesh.shard_batch(tree, rk.rank, rk.world_size)


def collectives_job(rk, rows):
    """psum_ and pmean_ of the rank's row of `rows` (W, ...), and a tree
    of two tensors through pmean_."""
    x = torch.tensor(rows[rk.rank])
    # a strided view (every other element) goes through a contiguous copy
    s = mesh.psum_(torch.repeat_interleave(x, 2)[::2], rk.group)
    m = mesh.pmean_(x.clone(), rk.group)
    tree = mesh.pmean_({"a": x.clone(), "b": (x[:1].clone() * 2,)}, rk.group)
    return s.numpy(), m.numpy(), tree["a"].numpy(), tree["b"][0].numpy()


def pmean_grads_job(rk, grads):
    """Three parameters, the middle one's gradient None and the others'
    the rank's rows of `grads` [(W, ...), (W, ...)], through
    pmean_grads_, with its all_reduce calls counted."""
    shapes = (grads[0].shape[1:], (3,), grads[1].shape[1:])
    params = [torch.nn.Parameter(torch.zeros(s, dtype=torch.float64))
              for s in shapes]
    params[0].grad = torch.tensor(grads[0][rk.rank])
    params[2].grad = torch.tensor(grads[1][rk.rank])
    calls = []
    real = dist.all_reduce

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    dist.all_reduce = counting
    try:
        mesh.pmean_grads_(params, rk.group)
    finally:
        dist.all_reduce = real
    return ([None if p.grad is None else p.grad.numpy() for p in params],
            len(calls))


def replicate_job(rk, seed):
    """A linear layer and a tensor drawn from the rank's own seed, then
    replicate_: returns them and the replicas' gap before and after."""
    gen = torch.Generator().manual_seed(seed + rk.rank)
    lin = torch.nn.Linear(4, 3).double()
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float64))
    t = torch.randn(5, generator=gen, dtype=torch.float64)
    view = torch.randn(6, 4, generator=gen, dtype=torch.float64)[:, 1:3]
    before = mesh.replica_gap([lin, t, view], rk.group)
    mesh.replicate_([lin, t, view], rk.group)
    after = mesh.replica_gap([lin, t, view], rk.group)
    return ({k: v.numpy() for k, v in lin.state_dict().items()},
            (t.numpy(), view.numpy()), before, after)


def _adam_moments(opt, module):
    """{name: (exp_avg, exp_avg_sq)} of a torch Adam over `module`."""
    out = {}
    for name, p in module.named_parameters():
        st = opt.state[p]
        out[name] = (st["exp_avg"].numpy(), st["exp_avg_sq"].numpy())
    return out


def _block(x: np.ndarray, rk) -> torch.Tensor:
    """The rank's block of a (T, N, ...) array, split over N."""
    return mesh.shard_batch(torch.tensor(np.swapaxes(x, 0, 1)), rk.rank,
                            rk.world_size).transpose(0, 1)


def dp_update_job(rk, policy, value, obs_dim, trajs, cfg):
    """dp_update on the rank's block of each trajectory in turn ((dict of
    (T, N, ...) arrays, last_obs (N, d)) pairs): the norm after each step,
    the final nets and Adam moments."""
    from kinpoly_tpu_torch.parallel.dryrun import dp_update
    from kinpoly_tpu_torch.rl import ppo
    from kinpoly_tpu_torch.rl import rollout as ro
    from kinpoly_tpu_torch.rl import running_norm as rn

    pol_opt, val_opt = ppo.make_optimizers(policy, value, cfg)
    norm = rn.init(obs_dim)
    norms = []
    for raw, last_obs in trajs:
        traj = ro.Trajectory(**{k: _block(raw[k], rk) if k in raw else None
                                for k in ro.Trajectory._fields})
        last = mesh.shard_batch(torch.tensor(last_obs), rk.rank,
                                rk.world_size)
        norm, _ = dp_update(policy, value, pol_opt, val_opt, norm, traj,
                            last, cfg, rk.group)
        norms.append(tuple(x.numpy() for x in norm))
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    return dict(norms=norms, policy=sd(policy), value=sd(value),
                pol_moments=_adam_moments(pol_opt, policy),
                val_moments=_adam_moments(val_opt, value))


def ar_update_job(rk, state, traj, last_obs):
    """The port's AgentAR.update on the rank's block of the trajectory
    with the group: `state` is the agent's nets, chains and config (no env
    or dataset, which update does not read). Returns the nets' state dicts
    (flax layout is made by the caller) and the metrics."""
    from kinpoly_tpu_torch.rl import rollout_ar as roa
    from kinpoly_tpu_torch.rl.agent_ar import AgentAR

    agent = object.__new__(AgentAR)
    agent.__dict__.update(state)
    agent.group = rk.group
    last = mesh.shard_batch(torch.tensor(last_obs), rk.rank, rk.world_size)
    metrics = agent.update(
        roa.ARTrajectory(**{k: _block(v, rk) for k, v in traj.items()}), last)
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    return dict(policy=sd(agent.policy.net), value=sd(agent.value),
                cc=sd(agent.cc_policy),
                metrics={k: v.numpy() for k, v in metrics.items()})


def ar_step_job(rk, state, other_windows):
    """The port's dp_ar_step on an agent rebuilt from `state` (every
    attribute but the rollout, remade here, and the generator, the
    rank's own). With `other_windows` every rank but 0 samples its
    windows from another seed, so that only the broadcast makes the
    contexts equal. Returns the clip indices and context the rollout
    started from, the context gaps dp_ar_step measured, the nets' state
    dicts and the metrics."""
    from kinpoly_tpu_torch.parallel.dryrun import dp_ar_step, rank_generator
    from kinpoly_tpu_torch.rl import rollout_ar as roa
    from kinpoly_tpu_torch.rl.agent_ar import AgentAR

    agent = object.__new__(AgentAR)
    agent.__dict__.update(state)
    agent._rollout = roa.make_ar_rollout(agent.env, agent.policy,
                                         agent.cfg.rollout_steps)
    agent.generator = rank_generator(agent.cfg.seed, rk.rank, agent.device)
    if other_windows and rk.rank:
        agent.np_rng = np.random.RandomState(1000 + rk.rank)
    seen = {}
    real = roa.init_ar_rollout_state

    def recording(env, policy, clips, ctx=None):
        seen["clips"] = clips.numpy()
        seen["ctx"] = {k: v.numpy() for k, v in ctx._asdict().items()
                       if v is not None}
        return real(env, policy, clips, ctx)

    roa.init_ar_rollout_state = recording
    try:
        metrics, gaps = dp_ar_step(agent, rk.group)
    finally:
        roa.init_ar_rollout_state = real
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    return dict(seen, gaps=gaps, policy=sd(agent.policy.net),
                value=sd(agent.value), cc=sd(agent.cc_policy),
                metrics={k: float(v) for k, v in metrics.items()})
