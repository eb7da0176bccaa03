"""TrajARNet, the autoregressive kinematic policy network (as
``kinpoly_tpu/models/traj_ar.py``, kin_poly.yml's layout: use_head,
use_action, has_z; no use_vel, use_context or use_of): the kinematic
integrator, the observation builder, the open-loop AR rollout over a
window, and the per-frame supervised loss of the step update.

Feature layout:

- context input  (B, T, 17): [obj_head_relative_poses 7, head_vels 6,
                              action_one_hot 4]
- AR state       (B, 105): [deheaded qpos[2:] 74, diff head pos 3, diff
  head rot 4, pred obj-rel-head 7, target head angvel 3, target head
  linvel 3, target obj-rel-head 7, action one-hot 4]
- action         (B, 80): [z 1, root quat 4, body pose 69, root vel 6]

The GRUs follow flax's ``GRUCell``: torch's GRU with its r and z hidden
biases at zero, and a gradient hook that keeps their gradient at zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from refimpl.core import tmath
from refimpl.models.nets import MLP, _linear
from refimpl.physics import fk as fklib


@dataclass(frozen=True)
class TrajARConfig:
    use_head: bool = True
    use_action: bool = True
    has_z: bool = True
    model_v: int = 1
    rnn_hdim: int = 1024
    mlp_hsize: tuple = (1024, 512, 256)
    mlp_htype: str = "relu"
    # the step loss's weights (kin_poly.yml model_specs)
    w_rp: float = 50.0
    w_rr: float = 50.0
    w_p: float = 1.0
    w_ee: float = 10.0

    @property
    def context_dim(self) -> int:
        return (13 if self.use_head else 0) + (4 if self.use_action else 0)

    @property
    def action_dim(self) -> int:
        return 80 if self.has_z else 79

    @property
    def init_dim(self) -> int:
        return self.action_dim + 75


QPOS_LM = 74
QVEL_LM = 75
POSE_START = 7
DT = 1.0 / 30


def zero_rz_grad(g: torch.Tensor) -> torch.Tensor:
    """A GRU hidden bias's gradient with its r and z thirds zeroed."""
    g = g.clone()
    g[: 2 * (g.shape[0] // 3)] = 0.0
    return g


def step_ar(qpos: torch.Tensor, action: torch.Tensor, cfg: TrajARConfig,
            dt: float = DT) -> torch.Tensor:
    """Integrate one kinematic action into the next-frame qpos: xy from the
    heading-turned root velocity (z from the action with has_z), the root
    rotation from the predicted angular velocity, the body pose as given."""
    curr_pos, curr_rot = qpos[..., :3], qpos[..., 3:7]
    curr_heading = tmath.heading_q(curr_rot)
    body_pose = action[..., POSE_START - 2:QPOS_LM]
    if cfg.has_z:
        root_qvel = action[..., QPOS_LM:]
        linv = tmath.quat_rot_vec(curr_heading, root_qvel[..., :3])
        pos_part = torch.cat([curr_pos[..., :2] + linv[..., :2] * dt,
                              action[..., 0:1]], dim=-1)
    else:
        root_qvel = action[..., QVEL_LM:]
        linv = tmath.quat_rot_vec(curr_heading, root_qvel[..., :3])
        pos_part = curr_pos + linv * dt
    angv = tmath.quat_rot_vec(curr_rot, root_qvel[..., 3:6])
    new_rot = tmath.quat_norm(tmath.quat_mul(
        tmath.quat_from_expmap(angv * dt), curr_rot))
    return torch.cat([pos_part, new_rot, body_pose], dim=-1)


def clamp_qpos(jnt_lo: torch.Tensor, jnt_hi: torch.Tensor,
               prev_qpos: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Bound an integrated kinematic pose near the physical ranges: root
    translation within 1 m of the previous pose per step, hinges within the
    joint range +- 0.5 rad, non-finite entries back to the previous pose."""
    pos = torch.minimum(torch.maximum(q[..., :3], prev_qpos[..., :3] - 1.0),
                        prev_qpos[..., :3] + 1.0)
    quat = tmath.quat_norm(torch.where(torch.isfinite(q[..., 3:7]),
                                       q[..., 3:7], prev_qpos[..., 3:7]))
    hinge = torch.minimum(torch.maximum(q[..., 7:], jnt_lo - 0.5), jnt_hi + 0.5)
    out = torch.cat([pos, quat, hinge], dim=-1)
    return torch.where(torch.isfinite(out), out, prev_qpos)


class ClipData(NamedTuple):
    """What the net reads of per-window data (B, T, ...)."""
    qpos: torch.Tensor
    head_pose: torch.Tensor
    head_vels: torch.Tensor
    obj_pose: torch.Tensor                  # (B, T, 14) active + secondary
    obj_head_relative_poses: torch.Tensor
    action_one_hot: torch.Tensor
    length: torch.Tensor                    # (B,) true window length


def ar_obs(spec, st, cfg: TrajARConfig, qpos, qvel, head_pose_t,
           head_vels_t, obj_pose_t, obj_rel_head_t, action_one_hot_t,
           as_policy: bool = False, fk_res=None):
    """The AR state of qpos against the frame-t context, and its FK
    features (no observation noise: the context build and the env run
    without it)."""
    if fk_res is None:
        fk_res = fklib.fk(st, qpos)
    head_idx = spec.body_index("Head")
    pred_hpos = fk_res.xpos[..., head_idx, :]
    pred_hrot = fk_res.xquat[..., head_idx, :]
    qpos_local = torch.cat([qpos[..., :3], tmath.de_heading(qpos[..., 3:7]),
                            qpos[..., 7:]], dim=-1)
    t_hpos, t_hrot = head_pose_t[..., :3], head_pose_t[..., 3:]
    t_hlvel, t_havel = head_vels_t[..., :3], head_vels_t[..., 3:]
    diff_hpos = tmath.transform_vec(t_hpos - pred_hpos, pred_hrot, "heading")
    diff_hrot = tmath.quat_mul(tmath.quat_inv(t_hrot), pred_hrot)
    q_heading = tmath.heading_q(pred_hrot)
    diff_obj_loc = tmath.transform_vec(obj_pose_t[..., :3] - pred_hpos,
                                       pred_hrot, "heading")
    obj_rot_local = tmath.quat_mul(tmath.quat_inv(q_heading),
                                   obj_pose_t[..., 3:7])
    pred_obj_rel_head = torch.cat([diff_obj_loc, obj_rot_local], dim=-1)

    obs = [qpos_local[..., 2:]]
    if cfg.use_head:
        obs += [diff_hpos, diff_hrot]
    obs.append(pred_obj_rel_head)
    if cfg.use_head:
        obs += [t_havel, t_hlvel, obj_rel_head_t]
    if cfg.use_action and cfg.model_v > 0 and as_policy:
        obs.append(action_one_hot_t)
    lead = qpos.shape[:-1]
    features = dict(pred_wbpos=fk_res.xpos.reshape(lead + (-1,)),
                    pred_wbquat=fk_res.xquat.reshape(lead + (-1,)),
                    obj_2_head=pred_obj_rel_head, qpos=qpos, qvel=qvel)
    return torch.cat(obs, dim=-1), features


def obs_dim(cfg: TrajARConfig, as_policy: bool = False) -> int:
    d = QPOS_LM + 7
    if cfg.use_head:
        d += 3 + 4 + 3 + 3 + 7
    if cfg.use_action and cfg.model_v > 0 and as_policy:
        d += 4
    return d


class TrajARNet(nn.Module):
    """Context GRU -> MLP -> initial state; step GRU + MLP -> per-step
    action. Layer names follow the program's (its state dict loads as
    is)."""

    def __init__(self, spec, st, cfg: TrajARConfig, as_policy: bool = False):
        super().__init__()
        self.spec, self.st, self.cfg, self.as_policy = spec, st, cfg, as_policy
        H = cfg.rnn_hdim
        self.context_gru = nn.GRU(cfg.context_dim, H, batch_first=True)
        self.context_mlp = MLP(H, cfg.mlp_hsize, cfg.mlp_htype)
        self.context_fc = _linear(cfg.mlp_hsize[-1], cfg.init_dim)
        d = obs_dim(cfg, as_policy)
        self.action_gru = nn.GRUCell(d, H)
        self.action_mlp = MLP(d + H, cfg.mlp_hsize, cfg.mlp_htype)
        self.action_fc = _linear(cfg.mlp_hsize[-1], cfg.action_dim)
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("bias_hh"):
                p.register_hook(zero_rz_grad)

    def context_input(self, data: ClipData) -> torch.Tensor:
        c = self.cfg
        feats = []
        if c.use_head:
            feats += [data.obj_head_relative_poses, data.head_vels]
        if c.use_action:
            feats.append(data.action_one_hot)
        return torch.cat(feats, dim=-1)

    def init_states(self, data: ClipData):
        """The initial (qpos, qvel) predicted from the mean context feature,
        with xy and heading from the data's first frame."""
        ctx = self.context_gru(self.context_input(data))[0]
        init_state = self.context_fc(self.context_mlp(ctx.mean(dim=1)))
        a = self.cfg.action_dim
        pred, init_pred_vel = init_state[..., :a], init_state[..., a:]
        init_pos = data.qpos[:, 0, :3]
        init_heading = tmath.heading_q(data.qpos[:, 0, 3:7])
        root_q = tmath.quat_norm(tmath.quat_mul(init_heading, pred[..., 1:5]))
        qpos0 = torch.cat([init_pos[..., :2], pred[..., 0:1], root_q,
                           pred[..., 5:QPOS_LM]], dim=-1)
        return qpos0, init_pred_vel

    def action(self, carry: torch.Tensor, state: torch.Tensor):
        """(GRU carry, AR state) -> (new carry, action)."""
        carry = self.action_gru(state, carry)
        x = torch.cat([state, carry], dim=-1)
        return carry, self.action_fc(self.action_mlp(x))

    def obs_at(self, qpos, qvel, data: ClipData, t: int):
        return ar_obs(self.spec, self.st, self.cfg, qpos, qvel,
                      data.head_pose[:, t], data.head_vels[:, t],
                      data.obj_pose[:, t], data.obj_head_relative_poses[:, t],
                      data.action_one_hot[:, t], as_policy=self.as_policy)

    def forward(self, data: ClipData) -> dict:
        """The open-loop AR rollout over the whole window from the
        predicted initial state: per-frame features (B, T, ...), qvel
        shifted one frame forward."""
        B, T = data.qpos.shape[:2]
        dev, dtype = data.qpos.device, data.qpos.dtype
        lo = torch.as_tensor(self.spec.jnt_range[:, 0], dtype=dtype, device=dev)
        hi = torch.as_tensor(self.spec.jnt_range[:, 1], dtype=dtype, device=dev)
        qpos, qvel = self.init_states(data)
        state, feat = self.obs_at(qpos, qvel, data, 0)
        gru = qpos.new_zeros((B, self.cfg.rnn_hdim))
        feats = {k: [v] for k, v in feat.items()}
        for t in range(1, T):
            gru, act = self.action(gru, state)
            next_qpos = clamp_qpos(lo, hi, qpos, step_ar(qpos, act, self.cfg))
            qvel = tmath.qvel_fd(qpos, next_qpos, DT)
            qpos = next_qpos
            state, feat = self.obs_at(qpos, qvel, data, t)
            for k, v in feat.items():
                feats[k].append(v)
        out = {k: torch.stack(v, dim=1) for k, v in feats.items()}
        q = out["qvel"]
        out["qvel"] = torch.cat([q[:, 1:], q[:, -2:-1]], dim=1)
        return out


def _quat_iden_loss(q_pred: torch.Tensor, q_gt: torch.Tensor) -> torch.Tensor:
    d = tmath.quat_mul(q_gt, tmath.quat_inv(q_pred))
    iden = torch.zeros_like(d)
    iden[..., 0] = 1.0
    return torch.sum((torch.abs(d) - iden) ** 2, dim=-1)


def _sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum((a - b) ** 2, dim=-1)


def compute_loss_lite(st, cfg: TrajARConfig, pred_qpos, gt_qpos):
    """Per-frame qpos supervision (not reduced): root position and
    rotation, body pose and body positions."""
    lead = pred_qpos.shape[:-1]
    pred_w = fklib.fk(st, pred_qpos).xpos.reshape(lead + (-1,))
    gt_w = fklib.fk(st, gt_qpos).xpos.reshape(gt_qpos.shape[:-1] + (-1,))
    r_pos = _sq(gt_qpos[..., :3], pred_qpos[..., :3])
    r_rot = _quat_iden_loss(pred_qpos[..., 3:7], gt_qpos[..., 3:7])
    p_rot = _sq(gt_qpos[..., 7:], pred_qpos[..., 7:])
    ee = _sq(gt_w, pred_w)
    return cfg.w_rp * r_pos + cfg.w_rr * r_rot + cfg.w_p * p_rot + cfg.w_ee * ee
