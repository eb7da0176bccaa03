"""PolicyAR: TrajARNet as the recurrent kinematic policy (port of
``kinpoly_tpu/models/policy_ar.py``, policy_v 1, acting and the context
build; the supervised step update is not here).

``init_context`` is the evaluation's preprocessing: the whole-window AR
rollout, Gaussian smoothing (sigma 1) of the body pose over time and the
feet-height fix of the initial state and of the rollout.
"""

from __future__ import annotations

import numpy as np
import torch

from kinpoly_tpu_torch.anim.spec import HumanoidSpec, SpecTensors
from kinpoly_tpu_torch.models.traj_ar import ClipData, TrajARConfig, TrajARNet
from kinpoly_tpu_torch.physics import fk as fklib


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


class PolicyAR:
    """TrajARNet (as a policy) and the Gaussian head's fixed log-std."""

    def __init__(self, spec: HumanoidSpec, st: SpecTensors,
                 kin_cfg: TrajARConfig, log_std: float = -3.2,
                 policy_v: int = 1):
        if policy_v != 1:
            raise ValueError(f"policy_v {policy_v} is not ported "
                             f"(ActionDeltaNet, policy_v 2)")
        self.spec, self.st, self.cfg = spec, st, kin_cfg
        self.policy_v = policy_v
        self.net = TrajARNet(spec, st, kin_cfg, as_policy=True)
        self.log_std = log_std
        self.action_dim = kin_cfg.action_dim
        self.carry_dim = kin_cfg.rnn_hdim

    def init_carry(self, n: int, like: torch.Tensor) -> torch.Tensor:
        return like.new_zeros((n, self.carry_dim))

    def action_mean(self, gru_carry: torch.Tensor, obs: torch.Tensor):
        """One recurrent policy step: (new carry, action mean)."""
        return self.net.action(gru_carry, obs)

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
