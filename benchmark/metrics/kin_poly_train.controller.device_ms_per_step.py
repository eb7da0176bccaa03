"""Device milliseconds per control step, in the profiled rollout stretch, of the activities launched while the innermost of the harness's spans open was that of the frozen UHC controller (span ar.controller: its observation, norm and MCP forward, the action's draw)."""

from harness import readers_ar


def read(run):
    return readers_ar.group_ms_per_step(run, "controller")
