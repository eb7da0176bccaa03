"""The kinematic-policy trainer's update (as ``kinpoly_tpu/rl/agent_ar.py``
with kin_poly.yml's modes: ``rl_update`` and ``step_update``, no joint
controller): GAE over the value net, the PPO epochs (a value step, then a
policy step through the step GRU's re-run over the trajectory) and the
step-BC epochs, each chain an ``AdamChain``; and the frozen UHC controller
of a UHC checkpoint."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from refimpl.models import nets, weights
from refimpl.rl import gae
from refimpl.rl import running_norm as rn
from refimpl.rl.agent_uhc import UHCTrainConfig, make_policy
from refimpl.rl.optim import AdamChain


def load_uhc(path: str, device, dtype=torch.float64, obs_dim: int = 784,
             action_dim: int = 75):
    """(policy in `dtype` on `device`, its observation norm as saved) of
    a UHC checkpoint, the policy built from the checkpoint's config."""
    ck = weights.load_uhc_checkpoint(path)
    saved = ck["cfg"] or {}
    cfg = UHCTrainConfig(**{f.name: saved[f.name] for f in
                            dataclasses.fields(UHCTrainConfig) if f.name in saved})
    cfg.policy_hsize = tuple(cfg.policy_hsize)
    policy = make_policy(cfg, obs_dim, action_dim)
    policy.load_state_dict(ck["policy"])
    norm = rn.RunningNorm(*(x.to(device) for x in ck["norm"]))
    return policy.to(device=device, dtype=dtype), norm


@dataclass(frozen=True)
class ARUpdateConfig:
    """kin_poly.yml's update: the supervised ``lr`` of the step-BC chain
    and ``policy_specs``'s PPO settings."""
    lr: float = 5e-4
    policy_lr: float = 1e-5
    value_lr: float = 3e-4
    clip_epsilon: float = 0.2
    gamma: float = 0.95
    tau: float = 0.95
    max_grad_norm: float = 40.0


def ppo_chains(policy, value, cfg: ARUpdateConfig):
    """Fresh (value, policy) chains, as the trainer makes them."""
    return (AdamChain(value.parameters(), cfg.value_lr),
            AdamChain(policy.parameters(), cfg.policy_lr, cfg.max_grad_norm))


def bc_chain(policy, cfg: ARUpdateConfig) -> AdamChain:
    """A fresh step-BC chain, as the trainer makes it."""
    return AdamChain(policy.parameters(), cfg.lr, cfg.max_grad_norm,
                     zero_nans=True)


def prev_masks(masks: torch.Tensor) -> torch.Tensor:
    """1 where the previous step did not end an episode (and at t = 0)."""
    return torch.cat([torch.ones_like(masks[:1]), masks[:-1]])


def _step(loss: torch.Tensor, opt: AdamChain) -> None:
    opt.zero_grad()
    loss.backward()
    opt.step()


def ppo_epochs(policy, value, cfg: ARUpdateConfig, val_opt: AdamChain,
               pol_opt: AdamChain, traj: dict, last_obs: torch.Tensor,
               n_epochs: int) -> list:
    """`n_epochs` PPO epochs on a (T, N) trajectory (obs, actions,
    rewards, masks, log_probs): GAE once from the value net as it stands,
    then per epoch a value step on the returns and a policy step on the
    clipped surrogate. Returns each epoch's (value loss, policy loss)."""
    obs, masks = traj["obs"], traj["masks"]
    T, N = masks.shape
    with torch.no_grad():
        values = value(obs)
        bootstrap = value(last_obs)
    adv, ret = gae.estimate_advantages(traj["rewards"], masks, values,
                                       cfg.gamma, cfg.tau, bootstrap)
    flat = lambda x: x.reshape((T * N,) + x.shape[2:])
    ret, adv, actions = flat(ret), flat(adv), flat(traj["actions"])
    fixed = flat(traj["log_probs"])
    prev = prev_masks(masks)
    eps = cfg.clip_epsilon
    out = []
    for _ in range(n_epochs):
        vl = torch.mean((value(flat(obs)) - ret) ** 2)
        _step(vl, val_opt)
        means = flat(policy.action_means_over_time(obs, prev))
        lp = nets.gaussian_log_prob(actions, means,
                                    torch.full_like(means, policy.log_std))
        ratio = torch.exp(lp - fixed)
        loss = -torch.mean(torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps) * adv))
        _step(loss, pol_opt)
        out.append((float(vl.detach()), float(loss.detach())))
    return out


def bc_epochs(policy, sup_opt: AdamChain, traj: dict, n_epochs: int) -> list:
    """`n_epochs` step-BC epochs toward the ground truth's next pose;
    returns each epoch's loss."""
    prev = prev_masks(traj["masks"])
    out = []
    for _ in range(n_epochs):
        loss = policy.step_update_loss(traj["obs"], prev, traj["curr_qpos"],
                                       traj["gt_qpos"])
        _step(loss, sup_opt)
        out.append(float(loss.detach()))
    return out
