"""Device milliseconds per control step of the AR epoch's profiled rollout stretch (steps 4-6): the busy union of its activities, user annotations left out."""

from harness import readers_ar


def read(run):
    return readers_ar.rollout_ms_per_step(run)
