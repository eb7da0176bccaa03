"""Percent of the iterations' time outside the rollout span: the running-norm update, GAE, the PPO update and the host fetch."""

from harness import readers


def read(run):
    return readers.share_outside(run, "rollout")
