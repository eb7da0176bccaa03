"""Milliseconds per control step of a synchronised span around the rollout call, over the iterations no profiler ran in."""

from harness import readers


def read(run):
    return readers.span_ms_per_step(run, "rollout")
