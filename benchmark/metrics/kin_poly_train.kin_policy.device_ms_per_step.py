"""Device milliseconds per control step, in the profiled rollout stretch, of the activities launched while the innermost of the harness's spans open was that of the kinematic policy's step (span ar.kin_policy: the step GRU, the MLP head, the action's draw and log-probability)."""

from harness import readers_ar


def read(run):
    return readers_ar.group_ms_per_step(run, "kin_policy")
