"""FK calls per control step of the profiled rollout stretch: the port's host counter COUNTS["fk"] (one K5 launch each on the card)."""

from harness import readers_ar


def read(run):
    return readers_ar.count_per_step(run, "fk")
