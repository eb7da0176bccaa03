"""UHC agent (port of ``kinpoly_tpu/rl/agent_uhc.py``): the MCP or Gaussian
policy, the value net and the observation norm; PPO training, one iteration
per ``train_epoch`` (rollout, running-norm update, GAE, PPO update); adaptive
hard-clip mining; checkpoints in the JAX package's layout; coverage
evaluation, deterministic and over sampled runs.

Nothing is read back to the host inside an iteration; ``train_epoch`` makes
one fetch of the metrics and the per-step episode ends at its end, for the
success EWMA that drives the clip sampling probabilities (reference
``dataset_amass_single.py:162-181``).
"""

from __future__ import annotations

import pickle
import time
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch

from kinpoly_tpu_torch.config.defaults import UHCConfig
from kinpoly_tpu_torch.envs.humanoid_im import HumanoidImEnv, select
from kinpoly_tpu_torch.models import nets, weights
from kinpoly_tpu_torch.rl import gae, ppo
from kinpoly_tpu_torch.rl import rollout as ro
from kinpoly_tpu_torch.rl import running_norm as rn
from kinpoly_tpu_torch.utils.profiling import span


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


class UHCAgent:
    """`cfg` is a ``UHCTrainConfig`` or a ``UHCConfig`` (whose
    ``train_config()`` is taken). Fresh nets are drawn from one generator on
    the env's device, seeded with ``cfg.seed``, which then feeds every draw
    of the rollouts and the PPO permutations."""

    def __init__(self, env: HumanoidImEnv, cfg, out_dir: str | None = None):
        if isinstance(cfg, UHCConfig):
            cfg = cfg.train_config()
        self.env = env
        self.cfg = cfg
        self.out_dir = Path(out_dir) if out_dir else None
        self.n_clips = env.n_clips
        dtype, device = env.model.dtype, env.model.device
        self.generator = torch.Generator(device=device).manual_seed(cfg.seed)
        self.obs_dim = env.obs_dim
        self.policy = make_policy(cfg, self.obs_dim, env.action_dim).to(
            dtype=dtype, device=device)
        self.value = nets.Value(self.obs_dim, cfg.value_hsize).to(
            dtype=dtype, device=device)
        nets.init_flax_(self.policy, self.generator)
        nets.init_flax_(self.value, self.generator)
        self.ppo_cfg = ppo.PPOConfig(
            clip_epsilon=cfg.clip_epsilon, num_optim_epoch=cfg.num_optim_epoch,
            mini_batch_size=cfg.mini_batch_size, policy_lr=cfg.policy_lr,
            value_lr=cfg.value_lr, gamma=cfg.gamma, tau=cfg.tau,
            max_grad_norm=cfg.max_grad_norm)
        self.policy_opt, self.value_opt = ppo.make_optimizers(
            self.policy, self.value, self.ppo_cfg)
        self.norm = rn.init(self.obs_dim, device)
        self.success_ewma = np.zeros(self.n_clips)
        self.seen = np.zeros(self.n_clips, bool)
        self.epoch = 0
        self._rollout = ro.make_rollout(env, self.policy, cfg.rollout_steps,
                                        cfg.noise_rate)
        self._carry = None

    # -- training ------------------------------------------------------

    def _train_iter(self, clip_probs: torch.Tensor, noise_rate: float):
        """Rollout, running-norm update, GAE and the PPO update, all on the
        device. Returns (metrics, percents, clips, dones) as tensors."""
        cfg, norm = self.cfg, self.norm
        self._carry, traj = self._rollout(self._carry, norm, clip_probs,
                                          self.generator, noise_rate_t=noise_rate)
        with span("uhc.update"):
            self.norm = rn.update_batch(norm, traj.raw_obs)
            T, N = traj.rewards.shape
            with torch.no_grad():
                values = self.value(traj.obs)
                # bootstrap the cut tails with V of the carried obs (old stats)
                bootstrap = self.value(rn.apply(norm, self._carry.obs))
            adv, ret = gae.estimate_advantages(traj.rewards, traj.masks, values,
                                               cfg.gamma, cfg.tau, bootstrap)
            flat = lambda x: x.reshape((T * N,) + x.shape[2:])
            metrics = ppo.ppo_update(
                self.policy, self.value, self.ppo_cfg, self.policy_opt,
                self.value_opt, self.generator, flat(traj.obs),
                flat(traj.actions), flat(adv), flat(ret), flat(traj.log_probs))
            metrics.update(
                reward_mean=traj.rewards.mean(),
                episode_done=traj.masks.numel() - traj.masks.sum(),
                fail_frac=traj.fails.to(traj.rewards.dtype).mean(),
                # per-component decomposition of the reward (5 to 7 terms)
                reward_components=traj.reward_info.mean(dim=(0, 1)))
        return metrics, traj.percents, traj.clips, traj.masks == 0

    def clip_probs(self) -> np.ndarray:
        """Sampling probability per clip, proportional to
        exp(-success / temp) for clips seen, uniform weight for the rest."""
        logits = np.where(self.seen, -self.success_ewma / self.cfg.sampling_temp,
                          0.0)
        p = np.exp(logits - logits.max())
        return p / p.sum()

    def _set_log_std(self, v: float) -> None:
        with torch.no_grad():
            self.policy.log_std.fill_(v)

    def train_epoch(self, adaptive: dict | None = None) -> dict:
        """One PPO iteration. `adaptive` = ``UHCConfig.adaptive_params(i)``:
        {noise_rate, log_std, policy_lr}; log_std applies only with
        ``fix_std=False`` (a ``log_std`` parameter)."""
        with span("uhc.train_epoch", str(self.epoch)):
            t0 = time.time()
            cfg = self.cfg
            noise_rate = cfg.noise_rate
            if adaptive is not None:
                noise_rate = adaptive.get("noise_rate", noise_rate)
                if not cfg.fix_std and "log_std" in adaptive:
                    self._set_log_std(adaptive["log_std"])
                if "policy_lr" in adaptive:
                    ppo.set_policy_lr(self.policy_opt, adaptive["policy_lr"])
            probs = torch.as_tensor(self.clip_probs(), device=self.env.model.device)
            if self._carry is None:
                self._carry = ro.init_rollout_state(self.env, self.generator,
                                                    cfg.n_envs, probs)
            metrics, percents, clips, dones = self._train_iter(probs, noise_rate)

            # the one host fetch of the iteration
            with span("uhc.host_fetch"):
                metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
                percents, clips, dones = (x.cpu().numpy()
                                          for x in (percents, clips, dones))
                a = cfg.sampling_freq
                for c, p in zip(clips[dones], percents[dones]):
                    self.success_ewma[c] = (
                        p if not self.seen[c]
                        else a * self.success_ewma[c] + (1 - a) * p)
                    self.seen[c] = True

            self.epoch += 1
            out = {k: (v.tolist() if v.ndim else float(v)) for k, v in metrics.items()}
            out["T_iter"] = time.time() - t0
            if self.out_dir and self.epoch % cfg.save_model_interval == 0:
                self.save_checkpoint()
            return out

    # -- checkpoints ---------------------------------------------------

    def save_checkpoint(self, path: str | None = None) -> str:
        """A pickle in the JAX package's layout (flax parameter trees of
        numpy arrays, the norm as a (count, mean, m2) tuple), which the JAX
        loader and ``load_checkpoint`` both read."""
        path = Path(path or self.out_dir / f"iter_{self.epoch:04d}.p")
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = dict(
            policy_params=weights.policy_params(self.policy.state_dict()),
            value_params=weights.value_params(self.value.state_dict()),
            norm=tuple(x.cpu().numpy() for x in self.norm),
            success_ewma=self.success_ewma.copy(), seen=self.seen.copy(),
            epoch=self.epoch, cfg=asdict(self.cfg))
        with open(path, "wb") as f:
            pickle.dump(blob, f)
        return str(path)

    def load_checkpoint(self, path: str) -> None:
        """Weights, observation norm and epoch from a UHC checkpoint (the
        weights cast to the env's dtype; the norm as saved), and the clip
        mining history when it fits this clip bank."""
        ck = weights.load_uhc_checkpoint(path)
        device = self.env.model.device
        self.policy.load_state_dict(ck["policy"])
        self.value.load_state_dict(ck["value"])
        self.norm = rn.RunningNorm(*(x.to(device) for x in ck["norm"]))
        self.epoch = ck["epoch"]
        ewma = ck.get("success_ewma")
        if ewma is not None and len(ewma) == self.n_clips:
            self.success_ewma = np.asarray(ewma, np.float64)
            self.seen = np.asarray(ck["seen"], bool)
        else:
            self.success_ewma = np.zeros(self.n_clips)
            self.seen = np.zeros(self.n_clips, bool)

    # -- evaluation ----------------------------------------------------

    @torch.no_grad()
    def _track(self, max_steps: int, generator: torch.Generator | None):
        """One env per clip from a deterministic reset for `max_steps`
        control steps; a finished env is frozen. Actions are the policy's
        means, plus its Gaussian noise drawn from `generator` if given.
        Returns per-clip success, max tracked percent and the final state."""
        env = self.env
        n = env.n_clips
        device = env.model.device
        state, obs = env.reset(torch.arange(n, device=device), deterministic=True)
        running = torch.ones(n, dtype=torch.bool, device=device)
        succ = torch.zeros_like(running)
        pct = torch.zeros(n, dtype=obs.dtype, device=device)
        for _ in range(max_steps):
            action, log_std = self.policy(rn.apply(self.norm, obs))
            if generator is not None:
                action = action + torch.exp(log_std) * torch.randn(
                    action.shape, generator=generator, dtype=action.dtype,
                    device=device)
            state2, obs2, _, done, info = env.step(state, action)
            state = select(running, state2, state)
            obs = torch.where(running[:, None], obs2, obs)
            succ |= running & info.end & ~info.fail
            pct = torch.maximum(pct, torch.where(running, info.percent,
                                                 torch.zeros_like(pct)))
            running = running & ~done
        return succ.cpu().numpy(), pct.cpu().numpy(), state

    def eval_coverage(self, max_steps: int = 512, stochastic_seeds: int = 0):
        """Fraction of clips tracked to their end without termination, one
        env per clip, deterministic reset and mean actions, `max_steps`
        control steps. Returns (coverage, info) with per-clip ``succ``, max
        tracked ``percent`` and the final ``state``; with
        ``stochastic_seeds=N`` also ``coverage_mean``, ``coverage_std`` and
        ``coverage_seeds`` over N runs with sampled actions, run s drawing
        from a generator seeded 1000 + s."""
        succ, pct, state = self._track(max_steps, None)
        info = dict(succ=succ, percent=pct, state=state)
        if stochastic_seeds > 0:
            device = self.env.model.device
            covs = [float(self._track(max_steps, torch.Generator(
                device=device).manual_seed(1000 + s))[0].mean())
                for s in range(stochastic_seeds)]
            info.update(coverage_mean=float(np.mean(covs)),
                        coverage_std=float(np.std(covs)), coverage_seeds=covs)
        return float(succ.mean()), info
