"""The kinematic-policy agent (port of ``kinpoly_tpu/rl/agent_ar.py``, the
evaluation subset): the policy and value nets, the context build and
checkpoint loading. The updates (PPO, the supervised step update, the
joint-controller update) are not here.
"""

from __future__ import annotations

import dataclasses

import torch

from kinpoly_tpu_torch.data.statear import StateARDataset
from kinpoly_tpu_torch.envs.humanoid_ar import ARContext, HumanoidAREnv
from kinpoly_tpu_torch.models import nets, weights
from kinpoly_tpu_torch.models.policy_ar import PolicyAR
from kinpoly_tpu_torch.models.traj_ar import ClipData, obs_dim
from kinpoly_tpu_torch.physics import fk as fklib
from kinpoly_tpu_torch.rl.agent_uhc import UHCTrainConfig, make_policy
from kinpoly_tpu_torch.rl import running_norm as rn


def load_uhc(path: str, device, dtype: torch.dtype = torch.float32,
             obs_dim: int = 784, action_dim: int = 75):
    """The frozen UHC controller of the AR env from a UHC checkpoint:
    (policy module in `dtype` on `device`, its observation norm as saved),
    the policy built by ``agent_uhc.make_policy`` from the checkpoint's
    config."""
    ck = weights.load_uhc_checkpoint(path)
    saved = ck["cfg"] or {}
    cfg = UHCTrainConfig(**{f.name: saved[f.name] for f in
                            dataclasses.fields(UHCTrainConfig) if f.name in saved})
    cfg.policy_hsize = tuple(cfg.policy_hsize)
    policy = make_policy(cfg, obs_dim, action_dim)
    policy.load_state_dict(ck["policy"])
    norm = rn.RunningNorm(*(x.to(device) for x in ck["norm"]))
    return policy.to(device=device, dtype=dtype), norm


class AgentAR:
    """The policy (TrajARNet as PolicyAR) and value net on the env's
    device and dtype, freshly initialised as flax does (seeded) until a
    checkpoint is loaded."""

    def __init__(self, env: HumanoidAREnv, dataset: StateARDataset,
                 seed: int = 4, log_std: float = -3.2):
        self.env, self.dataset = env, dataset
        self.epoch = 0
        model = env.model
        self.policy = PolicyAR(model.spec, model.st, env.kin_cfg, log_std,
                               policy_v=env.policy_v)
        self.value = nets.Value(obs_dim(env.kin_cfg, as_policy=True),
                                hidden=(512, 256))
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for m in (self.policy.net, self.value):
            nets.init_flax_(m, gen)
            m.to(device=model.device, dtype=model.dtype)

    @torch.no_grad()
    def build_context(self, batch: ClipData, fix_height: bool = False) -> ARContext:
        """The context bank of a batch of takes (tensors on the env's
        device): the AR rollout with smoothing (and the feet fix), the
        ground truth's FK and body quaternions, and the episode lengths
        (true frames - 1: padded frames never count as tracked)."""
        ar = self.policy.init_context(batch, smooth=True, fix_height=fix_height)
        B, T = batch.qpos.shape[:2]
        gt_fk = fklib.fk(self.env.model.st, batch.qpos)
        length = (batch.length - 1 if batch.length is not None
                  else torch.full((B,), T - 1, device=batch.qpos.device))
        return ARContext(
            qpos=batch.qpos, qvel=batch.qvel,
            bquat=fklib.body_quat_sim(batch.qpos),
            gt_wbpos=gt_fk.xpos.reshape(B, T, -1),
            head_pose=batch.head_pose, head_vels=batch.head_vels,
            obj_pose=batch.obj_pose,
            obj_head_relative_poses=batch.obj_head_relative_poses,
            action_one_hot=batch.action_one_hot,
            ar_qpos=ar["ar_qpos"], ar_qvel=ar["ar_qvel"],
            ar_wbpos=ar["ar_wbpos"], init_qpos=ar["init_qpos"],
            init_qvel=ar["init_qvel"], length=length,
            context_feat=ar["context_feat"], of=batch.of)

    def load_checkpoint(self, path: str) -> None:
        """The policy and value net of a kinematic-policy checkpoint
        (``iter_*.p``). Its jointly tuned UHC controller is not taken:
        evaluation runs the env's controller, as the JAX script does."""
        ck = weights.load_ar_checkpoint(path)
        self.policy.net.load_state_dict(ck["policy"])
        self.value.load_state_dict(ck["value"])
        self.epoch = ck["epoch"]
