"""Faults planted under the timed path, to show that the check catches
them. ``plant(name, agent)`` breaks the program's objects (never its
files) right after set-up has built the agent, before its first, checked
iteration; the returned ``Patch`` mends them.

- ``frozen_step``: every optimizer step returns its state unchanged.
- ``half_batch``: the update sees half of its batch and takes its means
  over that half.
- ``altered_answer``: the env step's reward is altered where it is
  produced (+0.01 for every env).
- ``eighth_unstepped``: the env step leaves every eighth env's physics
  state as it was (the rest step as they should).
- ``half_unstepped``: the env step leaves the first half of the envs'
  physics state as it was.

The exchange between chips is not a fault a one-chip cell can have.
"""

from __future__ import annotations

from harness import probe

FAULTS = ("frozen_step", "half_batch", "altered_answer", "eighth_unstepped",
          "half_unstepped")

# which envs an unstepped fault leaves as they were, of n
UNSTEPPED = {"eighth_unstepped": lambda n: slice(0, n, 8),
             "half_unstepped": lambda n: slice(0, n // 2)}


def plant(name: str, agent) -> probe.Patch:
    """Plant fault `name` on the training agent `agent` and its env."""
    if name not in FAULTS:
        raise ValueError(f"fault {name!r} (have {FAULTS})")
    p = probe.Patch()
    step = agent.env.step
    if name == "frozen_step":
        for opt in (agent.policy_opt, agent.value_opt):
            p.set(opt, "step", lambda *a, **kw: None)
    elif name == "half_batch":
        from kinpoly_tpu_torch.rl import ppo
        fn = ppo.ppo_update

        def half(policy, value, cfg, popt, vopt, gen, *batch, **kw):
            return fn(policy, value, cfg, popt, vopt, gen,
                      *(x[: x.shape[0] // 2] for x in batch), **kw)
        p.set(ppo, "ppo_update", half)
    elif name == "altered_answer":
        def altered(*a, **kw):
            out = step(*a, **kw)
            return out[:2] + (out[2] + 0.01,) + tuple(out[3:])
        p.set(agent.env, "step", altered)
    else:
        def unstepped(state, *a, **kw):
            out = step(state, *a, **kw)
            envs = UNSTEPPED[name](state.sim.qpos.shape[0])
            new = {}
            for k in ("qpos", "qvel"):
                new[k] = getattr(out[0].sim, k).clone()
                new[k][envs] = getattr(state.sim, k)[envs]
            sim = out[0].sim._replace(**new)
            return (out[0]._replace(sim=sim),) + tuple(out[1:])
        p.set(agent.env, "step", unstepped)
    return p
