"""The faults of ``harness/faults.py`` planted on the kinematic-policy
trainer (``AgentAR``), under the same names, so that ``control.py`` reads
them in an AR cell too:

- ``frozen_step``: every optimiser chain's step returns its state
  unchanged.
- ``half_batch``: the update sees the first half of its envs.
- ``altered_answer``, ``eighth_unstepped``, ``half_unstepped``: the env
  step's faults, planted by ``faults.plant`` (the AR env step returns the
  UHC one's (state, obs, reward, done, info) with the physics state in
  ``state.sim``).
"""

from __future__ import annotations

from harness import faults, probe

FAULTS = faults.FAULTS


def plant(name: str, agent) -> probe.Patch:
    """Plant fault `name` on the AR agent `agent` and its env."""
    if name not in FAULTS:
        raise ValueError(f"fault {name!r} (have {FAULTS})")
    if name not in ("frozen_step", "half_batch"):
        return faults.plant(name, agent)
    p = probe.Patch()
    if name == "frozen_step":
        for opt in (agent.val_opt, agent.pol_opt, agent.sup_opt,
                    agent.cc_opt):
            p.set(opt, "step", lambda *a, **kw: None)
    else:
        update = agent.update

        def half(traj, last_obs, *a, **kw):
            n = last_obs.shape[0] // 2
            cut = type(traj)(*(None if x is None else x[:, :n] for x in traj))
            return update(cut, last_obs[:n], *a, **kw)
        p.set(agent, "update", half)
    return p
