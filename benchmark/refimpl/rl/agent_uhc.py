"""The UHC trainer's config and its policy (MCP or Gaussian)."""

from __future__ import annotations

from dataclasses import dataclass

from refimpl.models import nets


@dataclass
class UHCTrainConfig:
    n_envs: int = 256
    rollout_steps: int = 196          # n_envs * rollout_steps = batch
    gamma: float = 0.95
    tau: float = 0.95
    clip_epsilon: float = 0.2
    num_optim_epoch: int = 10
    mini_batch_size: int = 32768
    policy_lr: float = 5e-5
    value_lr: float = 3e-4
    log_std: float = -2.3
    fix_std: bool = True
    actor_type: str = "mcp"
    num_primitive: int = 8
    policy_hsize: tuple = (512, 256)
    value_hsize: tuple = (512, 256)
    policy_htype: str = "relu"
    noise_rate: float = 1.0
    sampling_temp: float = 2.0
    sampling_freq: float = 0.75       # EWMA weight of the old success
    max_grad_norm: float = 40.0
    seed: int = 1
    save_model_interval: int = 100


def make_policy(cfg: UHCTrainConfig, obs_dim: int, action_dim: int):
    """The policy of ``cfg.actor_type``: "mcp" or "gauss"."""
    if cfg.actor_type == "mcp":
        return nets.PolicyMCP(
            obs_dim, action_dim, num_primitive=cfg.num_primitive,
            hidden=cfg.policy_hsize, activation=cfg.policy_htype,
            log_std_init=cfg.log_std, fix_std=cfg.fix_std)
    if cfg.actor_type == "gauss":
        return nets.PolicyGaussian(
            obs_dim, action_dim, hidden=cfg.policy_hsize,
            activation=cfg.policy_htype, log_std_init=cfg.log_std,
            fix_std=cfg.fix_std)
    raise ValueError(f"actor_type {cfg.actor_type!r}")
