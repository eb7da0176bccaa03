"""PolicyAR with policy_v 1 (as ``kinpoly_tpu/models/policy_ar.py``):
TrajARNet's step GRU as the recurrent kinematic policy, the context build
(the whole-window AR rollout and Gaussian smoothing of the body pose), the
re-run of the step GRU over a recorded (T, N) rollout and the per-step
supervised loss."""

from __future__ import annotations

import numpy as np
import torch

from refimpl.models.traj_ar import (ClipData, TrajARConfig, TrajARNet,
                                    compute_loss_lite, step_ar)
from refimpl.physics import fk as fklib


def gaussian_filter1d_time(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter1d`` along dim -2 (time), reflect
    mode, radius 4 sigma."""
    radius = int(4.0 * sigma + 0.5)
    t = np.arange(-radius, radius + 1)
    w = np.exp(-0.5 * (t / sigma) ** 2)
    w = torch.as_tensor(w / w.sum(), dtype=x.dtype, device=x.device)
    xp = torch.cat([x[..., :radius, :].flip(-2), x,
                    x[..., x.shape[-2] - radius:, :].flip(-2)], dim=-2)
    return xp.unfold(-2, 2 * radius + 1, 1) @ w


class PolicyAR:
    """TrajARNet as a policy and the Gaussian head's fixed log-std."""

    def __init__(self, spec, st, kin_cfg: TrajARConfig, log_std: float = -3.2):
        self.spec, self.st, self.cfg = spec, st, kin_cfg
        self.net = TrajARNet(spec, st, kin_cfg, as_policy=True)
        self.log_std = log_std

    def parameters(self) -> list[torch.Tensor]:
        return list(self.net.parameters())

    def to(self, *args, **kw) -> "PolicyAR":
        self.net.to(*args, **kw)
        return self

    def action_means_over_time(self, obs_tn: torch.Tensor,
                               prev_masks_tn: torch.Tensor) -> torch.Tensor:
        """Re-run the step GRU over a (T, N, obs) rollout, its carry zeroed
        where the previous step ended an episode: the action means."""
        net = self.net
        carry = obs_tn.new_zeros((obs_tn.shape[1], self.cfg.rnn_hdim))
        carries = []
        for t in range(obs_tn.shape[0]):
            carry = net.action_gru(obs_tn[t], carry * prev_masks_tn[t][:, None])
            carries.append(carry)
        x = torch.cat([obs_tn, torch.stack(carries)], dim=-1)
        return net.action_fc(net.action_mlp(x))

    def step_update_loss(self, obs_tn, prev_masks_tn, curr_qpos, gt_qpos):
        """Per-step BC: the re-run's means integrated kinematically from
        the recorded sim qpos, supervised toward `gt_qpos`; the mean over
        every step and env."""
        means = self.action_means_over_time(obs_tn, prev_masks_tn)
        next_qpos = step_ar(curr_qpos, means, self.cfg)
        return compute_loss_lite(self.st, self.cfg, next_qpos, gt_qpos).mean()

    @torch.no_grad()
    def init_context(self, data: ClipData) -> dict:
        """The whole-window AR rollout with smoothing (no feet fix, as the
        training epoch builds it): ar_qpos, ar_qvel, ar_wbpos (B, T, ...),
        init_qpos, init_qvel (B, ...)."""
        feats = self.net(data)
        qpos0, qvel0 = self.net.init_states(data)
        ar_qpos = torch.cat([feats["qpos"][..., :7],
                             gaussian_filter1d_time(feats["qpos"][..., 7:], 1.0)],
                            dim=-1)
        B, T = ar_qpos.shape[:2]
        return dict(ar_qpos=ar_qpos, ar_qvel=feats["qvel"],
                    ar_wbpos=fklib.fk(self.st, ar_qpos).xpos.reshape(B, T, -1),
                    init_qpos=qpos0, init_qvel=qvel0)
