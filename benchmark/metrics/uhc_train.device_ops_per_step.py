"""Device activities (kernels, copies, sets) per control step in the profiled stretch of the rollout."""

from harness import readers


def read(run):
    return readers.ops_per_step(run)
