"""Generalised advantage estimation (as ``kinpoly_tpu/rl/gae.py``;
reference ``uhc/khrylib/rl/core/common.py:5-25``) over fixed-shape (T, N)
rollouts with masks and a truncation bootstrap."""

from __future__ import annotations

import torch


def estimate_advantages(rewards, masks, values, gamma: float, tau: float,
                        bootstrap_value=None, normalize: bool = True):
    """rewards/masks/values (T, ...); masks[t] = 0 where the episode ended at
    step t. `bootstrap_value` (...) is the value of the state after the last
    step, for tails cut by the rollout's length (0 if None).

    Returns (advantages, returns), each (T, ...); the advantages are
    normalised to zero mean and unit population std over the whole batch."""
    prev_value = (torch.zeros_like(values[-1]) if bootstrap_value is None
                  else bootstrap_value)
    prev_adv = torch.zeros_like(values[-1])
    advantages = torch.empty_like(values)
    for t in reversed(range(values.shape[0])):
        delta = rewards[t] + gamma * prev_value * masks[t] - values[t]
        prev_adv = delta + gamma * tau * prev_adv * masks[t]
        advantages[t] = prev_adv
        prev_value = values[t]
    returns = values + advantages
    if normalize:
        advantages = (advantages - advantages.mean()) / (
            advantages.std(correction=0) + 1e-8)
    return advantages, returns
