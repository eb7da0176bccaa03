"""PolicyAR: the recurrent kinematic policy (port of
``kinpoly_tpu/models/policy_ar.py``): acting, the context build, the
re-run of the step GRU over a recorded (T, N) rollout and the supervised
step update's loss. With policy_v 1 TrajARNet's step GRU is the policy
(an 80-d kinematic update); with policy_v 2 the residual head
``ActionDeltaNet`` is (a 76-d qpos: the AR rollout's pose, the last 76
entries of its observation, plus a learned delta), and TrajARNet only
builds the context.

``init_context`` is the evaluation's preprocessing: the whole-window AR
rollout, Gaussian smoothing (sigma 1) of the body pose over time and the
feet-height fix of the initial state and of the rollout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from kinpoly_tpu_torch.anim.spec import HumanoidSpec, SpecTensors
from kinpoly_tpu_torch.models import nets
from kinpoly_tpu_torch.models.rnn import zero_rz_grad
from kinpoly_tpu_torch.models.traj_ar import (ClipData, TrajARConfig,
                                              TrajARNet, compute_loss_lite,
                                              obs_dim, step_ar)
from kinpoly_tpu_torch.physics import fk as fklib

QPOS_DIM = 76


def gaussian_filter1d_time(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter1d`` along dim -2 (time), reflect
    mode, radius 4 sigma."""
    radius = int(4.0 * sigma + 0.5)
    t = np.arange(-radius, radius + 1)
    w = np.exp(-0.5 * (t / sigma) ** 2)
    w = torch.as_tensor(w / w.sum(), dtype=x.dtype, device=x.device)
    xp = torch.cat([x[..., :radius, :].flip(-2), x,
                    x[..., x.shape[-2] - radius:, :].flip(-2)], dim=-2)
    windows = xp.unfold(-2, 2 * radius + 1, 1)        # (..., T, D, K)
    return windows @ w


class ActionDeltaNet(nn.Module):
    """The policy_v 2 head: a GRU over the whole observation, an MLP and a
    linear layer giving a residual on the AR rollout's pose, which is the
    observation's last 76 entries; the action (the next qpos) is their
    sum. Layer names follow the flax module (``rnn``, ``mlp``, ``fc``);
    the GRU's r and z hidden biases stay at 0 as in ``traj_ar``. The JAX
    package initialises ``fc``'s kernel at zero (``init_flax_``)."""

    RNN_HDIM, MLP_HSIZE = 512, (512, 256)

    def __init__(self, in_dim: int):
        super().__init__()
        self.rnn = nn.GRUCell(in_dim, self.RNN_HDIM)
        self.mlp = nets.MLP(self.RNN_HDIM, self.MLP_HSIZE, "relu")
        self.fc = nets._linear(self.MLP_HSIZE[-1], QPOS_DIM)
        self.rnn.bias_hh.register_hook(zero_rz_grad)

    def __setstate__(self, state):
        # a tensor's hooks are neither pickled nor deep-copied
        super().__setstate__(state)
        self.rnn.bias_hh.register_hook(zero_rz_grad)

    def head(self, h: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """The action of GRU output `h` on observation `obs`."""
        return self.fc(self.mlp(h)) + obs[..., -QPOS_DIM:]

    def forward(self, carry: torch.Tensor, obs: torch.Tensor):
        """(GRU carry, observation) -> (new carry, action)."""
        carry = self.rnn(obs, carry)
        return carry, self.head(carry, obs)

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> "ActionDeltaNet":
        nets.init_flax_(self, generator)
        self.fc.weight.zero_()
        return self


class PolicyAR:
    """The kinematic policy: TrajARNet (as a policy) and, with policy_v 2,
    the residual head; the Gaussian head's fixed log-std."""

    def __init__(self, spec: HumanoidSpec, st: SpecTensors,
                 kin_cfg: TrajARConfig, log_std: float = -3.2,
                 policy_v: int = 1):
        if policy_v not in (1, 2):
            raise ValueError(f"policy_v {policy_v}: 1 or 2")
        self.spec, self.st, self.cfg = spec, st, kin_cfg
        self.policy_v = policy_v
        self.net = TrajARNet(spec, st, kin_cfg, as_policy=True)
        self.log_std = log_std
        self.delta_net = None
        if policy_v == 2:
            self.delta_net = ActionDeltaNet(obs_dim(kin_cfg, True) + QPOS_DIM)
            self.action_dim = QPOS_DIM
            self.carry_dim = ActionDeltaNet.RNN_HDIM
        else:
            self.action_dim = kin_cfg.action_dim
            self.carry_dim = kin_cfg.rnn_hdim

    def modules(self) -> list[nn.Module]:
        """TrajARNet, then the residual head if there is one (the order of
        the JAX parameter tree {"arnet", "delta"})."""
        return [self.net] + ([] if self.delta_net is None else [self.delta_net])

    def parameters(self) -> list[torch.Tensor]:
        return [p for m in self.modules() for p in m.parameters()]

    def named_parameters(self) -> list[tuple[str, torch.Tensor]]:
        return [(n, p) for m in self.modules() for n, p in m.named_parameters()]

    def to(self, *args, **kw) -> "PolicyAR":
        for m in self.modules():
            m.to(*args, **kw)
        return self

    def init_flax_(self, generator: torch.Generator) -> "PolicyAR":
        """Fresh parameters as flax initialises them (``nets.init_flax_``;
        the residual head's output kernel at zero)."""
        nets.init_flax_(self.net, generator)
        if self.delta_net is not None:
            self.delta_net.init_flax_(generator)
        return self

    def init_carry(self, n: int, like: torch.Tensor) -> torch.Tensor:
        return like.new_zeros((n, self.carry_dim))

    def action_mean(self, gru_carry: torch.Tensor, obs: torch.Tensor):
        """One recurrent policy step: (new carry, action mean)."""
        if self.delta_net is not None:
            return self.delta_net(gru_carry, obs)
        return self.net.action(gru_carry, obs)

    def action_means_over_time(self, obs_tn: torch.Tensor,
                               prev_masks_tn: torch.Tensor) -> torch.Tensor:
        """Re-run the step GRU over a (T, N, obs) rollout, its carry zeroed
        where the previous step ended an episode (prev_mask 0): the action
        means (T, N, A). The GRU steps one at a time; the MLP head runs
        once over all (T, N)."""
        if self.delta_net is not None:
            d = self.delta_net
            carry = self.init_carry(obs_tn.shape[1], obs_tn)
            carries = []
            for t in range(obs_tn.shape[0]):
                carry = d.rnn(obs_tn[t], carry * prev_masks_tn[t][:, None])
                carries.append(carry)
            return d.head(torch.stack(carries), obs_tn)
        net = self.net
        if self.cfg.model_v not in (0, 1):      # no step GRU
            return net.action_fc(net.action_mlp(obs_tn))
        carry = self.init_carry(obs_tn.shape[1], obs_tn)
        carries = []
        for t in range(obs_tn.shape[0]):
            carry = net.action_gru(obs_tn[t], carry * prev_masks_tn[t][:, None])
            carries.append(carry)
        x = torch.cat([obs_tn, torch.stack(carries)], dim=-1)
        return net.action_fc(net.action_mlp(x))

    def step_update_loss(self, obs_tn, prev_masks_tn, curr_qpos, gt_qpos,
                         masks_valid=None, means=None):
        """Per-step BC: the re-run's means (given, or computed here)
        integrated kinematically from the recorded sim qpos (with policy_v
        2 the means are the next qpos), supervised toward `gt_qpos` by
        ``compute_loss_lite``; the mean over steps (over the valid ones
        with `masks_valid`). Returns (loss, info)."""
        if means is None:
            means = self.action_means_over_time(obs_tn, prev_masks_tn)
        next_qpos = (means if self.delta_net is not None
                     else step_ar(curr_qpos, means, self.cfg))
        loss, info = compute_loss_lite(self.st, self.cfg, next_qpos, gt_qpos,
                                       reduce_mean=False)
        if masks_valid is not None:
            loss = (loss * masks_valid).sum() / torch.clamp(
                masks_valid.sum(), min=1.0)
        else:
            loss = loss.mean()
        return loss, info

    @torch.no_grad()
    def init_context(self, data: ClipData, smooth: bool = True,
                     fix_height: bool = True) -> dict:
        """Whole-window AR rollout, smoothing and the feet fix: ar_qpos,
        ar_qvel, ar_wbpos, ar_wbquat, ar_bquat (B, T, ...), init_qpos,
        init_qvel (B, ...), context_feat (use_context/use_of, else None)."""
        feats = self.net(data)
        qpos0, qvel0, ctx_feat = self.net.init_states(data)
        ar_qpos, ar_qvel = feats["qpos"], feats["qvel"]
        toe_l = self.spec.body_index("L_Toe")
        toe_r = self.spec.body_index("R_Toe")
        offset = 0.01

        def feet(q):
            x = fklib.fk(self.st, q).xpos
            return torch.minimum(x[..., toe_l, 2], x[..., toe_r, 2]) - offset

        init_qpos = qpos0
        if smooth:
            if fix_height:
                init_qpos = init_qpos.clone()
                init_qpos[..., 2] -= feet(init_qpos)
            ar_qpos = torch.cat([ar_qpos[..., :7],
                                 gaussian_filter1d_time(ar_qpos[..., 7:], 1.0)],
                                dim=-1)
            if fix_height:
                ar_qpos[..., 2] -= feet(ar_qpos[:, 0])[:, None]
        fk_res = fklib.fk(self.st, ar_qpos)
        B, T = ar_qpos.shape[:2]
        use_ctx = self.cfg.use_context or self.cfg.use_of
        return dict(
            ar_qpos=ar_qpos, ar_qvel=ar_qvel,
            ar_wbpos=fk_res.xpos.reshape(B, T, -1),
            ar_wbquat=fk_res.xquat.reshape(B, T, -1),
            ar_bquat=fklib.body_quat_sim(ar_qpos),
            init_qpos=init_qpos, init_qvel=qvel0,
            context_feat=ctx_feat if use_ctx else None)
