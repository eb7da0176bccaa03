"""K3's bound at 24 contact blocks (16 humanoid + 8 object-floor, after compaction) over its profiled device time in the AR rollout stretch, in percent."""

from harness import readers


def read(run):
    return readers.roofline(run, "pgs_solve")
