"""UHC agent, evaluation side (port of ``kinpoly_tpu/rl/agent_uhc.py``):
the MCP policy, the value net and the observation norm of a trained
checkpoint, and deterministic coverage evaluation. Training (GAE, PPO,
Adam) is not ported yet.
"""

from __future__ import annotations

import torch

from kinpoly_tpu_torch.config.defaults import UHCConfig
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, select
from kinpoly_tpu_torch.models import nets, weights
from kinpoly_tpu_torch.rl import running_norm as rn

OBS_DIM = 784


class UHCAgent:
    def __init__(self, env: HumanoidImEnv, cfg: UHCConfig):
        if cfg.actor_type != "mcp":
            raise ValueError(f"actor_type {cfg.actor_type!r} is not ported")
        self.env = env
        self.cfg = cfg
        dtype, device = env.model.dtype, env.model.device
        self.policy = nets.PolicyMCP(
            OBS_DIM, env.action_dim, num_primitive=cfg.num_primitive,
            hidden=cfg.policy_hsize, activation=cfg.policy_htype,
            log_std_init=cfg.log_std).to(dtype=dtype, device=device)
        self.value = nets.Value(OBS_DIM, cfg.value_hsize,
                                cfg.value_htype).to(dtype=dtype, device=device)
        zeros = torch.zeros(OBS_DIM, dtype=torch.float32, device=device)
        self.norm = rn.RunningNorm(zeros.new_zeros(()), zeros, zeros)
        self.epoch = 0

    def load_checkpoint(self, path: str) -> None:
        """Weights and observation norm from a UHC checkpoint. The weights
        (float32) are cast to the env's dtype; the norm keeps float32."""
        ck = weights.load_uhc_checkpoint(path)
        device = self.env.model.device
        self.policy.load_state_dict(ck["policy"])
        self.value.load_state_dict(ck["value"])
        self.norm = rn.RunningNorm(*(x.to(device) for x in ck["norm"]))
        self.epoch = ck["epoch"]

    @torch.no_grad()
    def eval_coverage(self, max_steps: int = 512):
        """Fraction of clips tracked to their end without termination, one
        env per clip, deterministic (mean) actions, `max_steps` control
        steps; a finished env is frozen. Returns (coverage, info) with
        per-clip ``succ``, max tracked ``percent`` and the final ``state``."""
        env = self.env
        n = env.n_clips
        device = env.model.device
        state, obs = env.reset(torch.arange(n, device=device))
        running = torch.ones(n, dtype=torch.bool, device=device)
        succ = torch.zeros_like(running)
        pct = torch.zeros(n, dtype=obs.dtype, device=device)
        for _ in range(max_steps):
            mean, _ = self.policy(rn.apply(self.norm, obs))
            state2, obs2, _, done, info = env.step(state, mean)
            state = select(running, state2, state)
            obs = torch.where(running[:, None], obs2, obs)
            succ |= running & info.end & ~info.fail
            pct = torch.maximum(pct, torch.where(running, info.percent,
                                                 torch.zeros_like(pct)))
            running = running & ~done
        succ = succ.cpu().numpy()
        return float(succ.mean()), dict(succ=succ, percent=pct.cpu().numpy(),
                                        state=state)
