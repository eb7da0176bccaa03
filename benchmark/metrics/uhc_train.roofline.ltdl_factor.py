"""K1's bound (bytes or FLOPs of its launches' shapes) over its profiled device time in the rollout stretch, in percent."""

from harness import readers


def read(run):
    return readers.roofline(run, "ltdl_factor")
