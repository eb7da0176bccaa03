"""A2C / vanilla policy-gradient update (port of ``kinpoly_tpu/rl/a2c.py``;
reference ``uhc/khrylib/rl/agents/agent_pg.py``): an L2 value regression
step, then one policy-gradient step on the advantage-weighted
log-likelihood; the base update PPO and TRPO specialise.
"""

from __future__ import annotations

import torch
from torch import nn

from kinpoly_tpu_torch.models import nets


def a2c_update(policy: nn.Module, value: nn.Module,
               policy_opt: torch.optim.Optimizer, value_opt: torch.optim.Optimizer,
               obs, actions, advantages, returns, l2_reg: float = 0.0) -> dict:
    """Step `value_opt` on the value loss (plus ``l2_reg`` times the sum of
    squares of every value parameter), then `policy_opt` on the policy
    loss, in place. Returns the two losses, taken before the steps."""
    vl = torch.mean((value(obs) - returns) ** 2)
    if l2_reg:
        vl = vl + l2_reg * sum(torch.sum(p * p) for p in value.parameters())
    value_opt.zero_grad()
    vl.backward()
    value_opt.step()

    mean, log_std = policy(obs)
    pl = -torch.mean(nets.gaussian_log_prob(actions, mean, log_std) * advantages)
    policy_opt.zero_grad()
    pl.backward()
    policy_opt.step()
    return dict(policy_loss=pl.detach(), value_loss=vl.detach())
