"""Clipped-surrogate PPO (port of ``kinpoly_tpu/rl/ppo.py``; reference
``uhc/khrylib/rl/agents/agent_ppo.py:6-65``): one Adam per net behind a
global-norm gradient clip, ``num_optim_epoch`` epochs of shuffled
minibatches over a flat batch. Autograd runs through the two MLPs only;
the policy gradient does not reach the physics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from kinpoly_tpu_torch.models import nets
from kinpoly_tpu_torch.parallel.mesh import pmean_grads_
from kinpoly_tpu_torch.utils.profiling import span, spanned


class PPOConfig(NamedTuple):
    clip_epsilon: float = 0.2
    num_optim_epoch: int = 10
    mini_batch_size: int = 32768
    policy_lr: float = 5e-5
    value_lr: float = 3e-4
    gamma: float = 0.95
    tau: float = 0.95
    max_grad_norm: float = 40.0


def make_optimizers(policy: nn.Module, value: nn.Module, cfg: PPOConfig):
    """(policy Adam, value Adam). torch's Adam divides by sqrt(v_hat) + eps
    as optax's does, so eps = 1e-8 matches ``optax.adam``."""
    return (torch.optim.Adam(policy.parameters(), lr=cfg.policy_lr, eps=1e-8),
            torch.optim.Adam(value.parameters(), lr=cfg.value_lr, eps=1e-8))


def set_policy_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """The adaptive schedules set the policy learning rate between
    iterations."""
    for group in opt.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the gradients, in place:
    g where ||g|| < max_norm, else (g / ||g||) * max_norm (torch's
    ``clip_grad_norm_`` divides by ||g|| + 1e-6 instead). Returns ||g||."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def _step(opt: torch.optim.Optimizer, loss: torch.Tensor, max_norm: float,
          lr_mult: float = 1.0, group=None) -> None:
    """One step of `opt` on `loss`: the gradient (averaged across the
    ranks of `group`, if one is given, as JAX's ``pmean`` before the
    chain), its global-norm clip, Adam."""
    opt.zero_grad()
    loss.backward()
    params = [p for g in opt.param_groups for p in g["params"]]
    if group is not None:
        pmean_grads_(params, group)
    with span("optim.step"):
        clip_by_global_norm_(params, max_norm)
        if lr_mult == 1.0:
            opt.step()
            return
        # lr_mult scales Adam's update, not the gradient (which Adam would
        # normalise away)
        lrs = [g["lr"] for g in opt.param_groups]
        for g in opt.param_groups:
            g["lr"] = g["lr"] * lr_mult
        opt.step()
        for g, lr in zip(opt.param_groups, lrs):
            g["lr"] = lr


@spanned("ppo.update")
def ppo_update(policy: nn.Module, value: nn.Module, cfg: PPOConfig,
               policy_opt: torch.optim.Optimizer,
               value_opt: torch.optim.Optimizer, generator: torch.Generator,
               obs, actions, advantages, returns, fixed_log_probs,
               lr_mult: float = 1.0) -> dict:
    """One full PPO update over a flat batch: obs (B, O), actions (B, A),
    advantages/returns/fixed_log_probs (B,). Each epoch takes the first
    ``n_mb * mb`` entries of a fresh permutation, as JAX does (the rest of
    the batch sits the epoch out). Returns the mean losses as tensors."""
    B = obs.shape[0]
    mb = min(cfg.mini_batch_size, B)
    n_mb = max(B // mb, 1)
    pls, vls = [], []
    for _ in range(cfg.num_optim_epoch):
        perm = torch.randperm(B, generator=generator, device=obs.device)
        for idx in perm[: n_mb * mb].reshape(n_mb, mb):
            o, a = obs[idx], actions[idx]
            adv, ret, flp = advantages[idx], returns[idx], fixed_log_probs[idx]

            vl = torch.mean((value(o) - ret) ** 2)
            _step(value_opt, vl, cfg.max_grad_norm)

            mean, log_std = policy(o)
            ratio = torch.exp(nets.gaussian_log_prob(a, mean, log_std) - flp)
            surr1 = ratio * adv
            surr2 = torch.clamp(ratio, 1.0 - cfg.clip_epsilon,
                                1.0 + cfg.clip_epsilon) * adv
            pl = -torch.mean(torch.minimum(surr1, surr2))
            _step(policy_opt, pl, cfg.max_grad_norm, lr_mult)
            pls.append(pl.detach())
            vls.append(vl.detach())
    return {"policy_loss": torch.stack(pls).mean(),
            "value_loss": torch.stack(vls).mean()}
