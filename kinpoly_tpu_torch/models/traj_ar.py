"""TrajARNet, the autoregressive kinematic policy network (port of
``kinpoly_tpu/models/traj_ar.py``): the kinematic integrator, the
observation builder, the AR rollout over a window (open loop, or in
training with scheduled sampling and observation noise) and the
supervised losses.

Feature layout (kin_poly.yml: use_head, use_action, has_z; no use_vel,
use_context or use_of):

- context input  (B, T, 17): [obj_head_relative_poses 7, head_vels 6,
                              action_one_hot 4]
- AR state       (B, 101/105): [deheaded qpos[2:] 74, diff head pos 3,
  diff head rot 4, pred obj-rel-head 7, target head angvel 3, target head
  linvel 3, target obj-rel-head 7, (+ action one-hot 4 as a policy)]
- action         (B, 80): [z 1, root quat 4, body pose 69, root vel 6]

With use_of and use_context (use_of.yml) the context input leads with the
frame's flow features (512 + 17 = 529), the AR state with the context
GRU's feature at that frame (rnn_hdim), and as a policy the state ends
with the flow features (873 at use_of.yml's widths).

The GRUs follow flax's ``GRUCell``: r, z = sigmoid(W_i x + b_i + W_h h)
with no hidden bias on r and z, n = tanh(W_in x + b_in + r (W_hn h +
b_hn)), h' = (1 - z) n + z h. Torch's GRU computes the same with its r and
z hidden biases at zero, which is how ``models/weights.trajar_from_jax``
loads them; a gradient hook keeps their gradient at zero, so that no
optimiser moves them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from kinpoly_tpu_torch.anim.spec import HumanoidSpec, SpecTensors
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.models.nets import MLP, _linear
from kinpoly_tpu_torch.models.rnn import zero_rz_grad
from kinpoly_tpu_torch.physics import fk as fklib


@dataclass(frozen=True)
class TrajARConfig:
    use_of: bool = False
    use_head: bool = True
    use_action: bool = True
    use_vel: bool = False
    use_context: bool = False
    has_z: bool = True
    pose_delta: bool = False
    add_noise: bool = True
    noise_std: float = 0.01
    model_v: int = 1
    rnn_hdim: int = 1024
    mlp_hsize: tuple = (1024, 512, 256)
    mlp_htype: str = "relu"
    of_dim: int = 512
    # loss weights (kin_poly.yml model_specs), read by the training losses
    w_rp: float = 50.0
    w_rr: float = 50.0
    w_p: float = 1.0
    w_v: float = 1.0
    w_ee: float = 10.0
    w_op: float = 1.0
    w_or: float = 10.0

    @property
    def context_dim(self) -> int:
        return ((self.of_dim if self.use_of else 0)
                + (13 if self.use_head else 0) + (4 if self.use_action else 0))

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


def step_ar(qpos: torch.Tensor, action: torch.Tensor, cfg: TrajARConfig,
            dt: float = DT) -> torch.Tensor:
    """Integrate one kinematic action into the next-frame qpos: xy from the
    heading-turned root velocity (z from the action with has_z), the root
    rotation from the predicted angular velocity, the body pose as given."""
    curr_pos, curr_rot = qpos[..., :3], qpos[..., 3:7]
    curr_heading = tmath.heading_q(curr_rot)
    body_pose = action[..., POSE_START - 2:QPOS_LM]
    if cfg.pose_delta:
        body_pose = tmath.wrap_to_pi(body_pose + qpos[..., POSE_START:])
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


def step_ar_with_vel(qpos, qvel, action, cfg: TrajARConfig, dt: float = DT):
    next_qpos = step_ar(qpos, action, cfg, dt)
    return next_qpos, tmath.qvel_fd(qpos, next_qpos, dt)


def clamp_qpos(jnt_lo: torch.Tensor, jnt_hi: torch.Tensor,
               prev_qpos: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Bound an integrated kinematic pose near the physical ranges: root
    translation within 1 m of the previous pose per step, hinges within the
    joint range +- 0.5 rad, non-finite entries back to the previous pose
    (an untrained step-GRU diverges over an open-loop rollout)."""
    pos = torch.minimum(torch.maximum(q[..., :3], prev_qpos[..., :3] - 1.0),
                        prev_qpos[..., :3] + 1.0)
    quat = tmath.quat_norm(torch.where(torch.isfinite(q[..., 3:7]),
                                       q[..., 3:7], prev_qpos[..., 3:7]))
    hinge = torch.minimum(torch.maximum(q[..., 7:], jnt_lo - 0.5), jnt_hi + 0.5)
    out = torch.cat([pos, quat, hinge], dim=-1)
    return torch.where(torch.isfinite(out), out, prev_qpos)


class ClipData(NamedTuple):
    """Per-window data (B, T, ...): one StateAR take or window each."""
    qpos: torch.Tensor                      # (B, T, 76)
    qvel: torch.Tensor                      # (B, T, 75)
    wbpos: torch.Tensor                     # (B, T, 72)
    head_pose: torch.Tensor                 # (B, T, 7)
    head_vels: torch.Tensor                 # (B, T, 6)
    obj_pose: torch.Tensor                  # (B, T, 14) active + secondary
    obj_head_relative_poses: torch.Tensor   # (B, T, 7)
    action_one_hot: torch.Tensor            # (B, T, 4)
    target: torch.Tensor                    # (B, T, action_dim)
    of: torch.Tensor | None = None          # (B, T, of_dim)
    length: torch.Tensor | None = None      # (B,) true window length
    take_idx: torch.Tensor | None = None    # (B,) source take


def ar_obs(spec: HumanoidSpec, st: SpecTensors, cfg: TrajARConfig, qpos,
           qvel, head_pose_t, head_vels_t, obj_pose_t, obj_rel_head_t,
           action_one_hot_t, of_t=None, context_feat_t=None,
           as_policy: bool = False, fk_res=None,
           noise: torch.Generator | None = None):
    """The AR state of the sim qpos against the frame-t context, and its FK
    features. `fk_res`: FK of qpos if the caller has it. With `noise` (a
    generator on the inputs' device) the target head rotation, position,
    angular and linear velocity and object-to-head pose get N(0,
    noise_std²) noise, in that order."""
    if fk_res is None:
        fk_res = fklib.fk(st, qpos)
    head_idx = spec.body_index("Head")
    pred_hpos = fk_res.xpos[..., head_idx, :]
    pred_hrot = fk_res.xquat[..., head_idx, :]
    qpos_local = torch.cat([qpos[..., :3], tmath.de_heading(qpos[..., 3:7]),
                            qpos[..., 7:]], dim=-1)

    obs = []
    if (cfg.use_context or cfg.use_of) and context_feat_t is not None:
        obs.append(context_feat_t)
    t_hpos, t_hrot = head_pose_t[..., :3], head_pose_t[..., 3:]
    t_hlvel, t_havel = head_vels_t[..., :3], head_vels_t[..., 3:]
    if noise is not None:
        def noisy(x):
            return x + cfg.noise_std * torch.randn(
                x.shape, generator=noise, dtype=x.dtype, device=x.device)
        t_hrot, t_hpos, t_havel, t_hlvel, obj_rel_head_t = (
            noisy(x) for x in (t_hrot, t_hpos, t_havel, t_hlvel,
                               obj_rel_head_t))
    diff_hpos = tmath.transform_vec(t_hpos - pred_hpos, pred_hrot, "heading")
    diff_hrot = tmath.quat_mul(tmath.quat_inv(t_hrot), pred_hrot)
    q_heading = tmath.heading_q(pred_hrot)
    diff_obj_loc = tmath.transform_vec(obj_pose_t[..., :3] - pred_hpos,
                                       pred_hrot, "heading")
    obj_rot_local = tmath.quat_mul(tmath.quat_inv(q_heading), obj_pose_t[..., 3:7])
    pred_obj_rel_head = torch.cat([diff_obj_loc, obj_rot_local], dim=-1)

    obs.append(qpos_local[..., 2:])
    if cfg.use_vel:
        obs.append(qvel)
    if cfg.use_head:
        obs += [diff_hpos, diff_hrot]
    obs.append(pred_obj_rel_head)
    if cfg.use_head:
        obs += [t_havel, t_hlvel, obj_rel_head_t]
    if cfg.use_action and cfg.model_v > 0 and as_policy:
        obs.append(action_one_hot_t)
    if cfg.use_of and as_policy and of_t is not None:
        obs.append(of_t)
    lead = qpos.shape[:-1]
    features = dict(pred_wbpos=fk_res.xpos.reshape(lead + (-1,)),
                    pred_wbquat=fk_res.xquat.reshape(lead + (-1,)),
                    obj_2_head=pred_obj_rel_head, qpos=qpos, qvel=qvel)
    return torch.cat(obs, dim=-1), features


def obs_dim(cfg: TrajARConfig, as_policy: bool = False) -> int:
    d = QPOS_LM + 7
    if cfg.use_context or cfg.use_of:
        d += cfg.rnn_hdim
    if cfg.use_vel:
        d += QVEL_LM
    if cfg.use_head:
        d += 3 + 4 + 3 + 3 + 7
    if cfg.use_action and cfg.model_v > 0 and as_policy:
        d += 4
    if cfg.use_of and as_policy:
        d += cfg.of_dim
    return d


class TrajARNet(nn.Module):
    """Context GRU -> MLP -> initial state; step GRU + MLP -> per-step
    action. Layer names follow the flax module; `st` are the spec's
    tensors on the device and in the dtype the net runs in."""

    def __init__(self, spec: HumanoidSpec, st: SpecTensors, cfg: TrajARConfig,
                 as_policy: bool = False):
        super().__init__()
        self.spec, self.st, self.cfg, self.as_policy = spec, st, cfg, as_policy
        H = cfg.rnn_hdim
        self.context_gru = nn.GRU(cfg.context_dim, H, batch_first=True)
        self.context_mlp = MLP(H, cfg.mlp_hsize, cfg.mlp_htype)
        self.context_fc = _linear(cfg.mlp_hsize[-1], cfg.init_dim)
        d = obs_dim(cfg, as_policy)
        if cfg.model_v in (0, 1):
            self.action_gru = nn.GRUCell(d, H)
            d += H
        self.action_mlp = MLP(d, cfg.mlp_hsize, cfg.mlp_htype)
        self.action_fc = _linear(cfg.mlp_hsize[-1], cfg.action_dim)
        self._hook_rz()

    def _hook_rz(self) -> None:
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("bias_hh"):
                p.register_hook(zero_rz_grad)

    def __setstate__(self, state):
        # a tensor's hooks are neither pickled nor deep-copied
        super().__setstate__(state)
        self._hook_rz()

    def context_input(self, data: ClipData) -> torch.Tensor:
        c = self.cfg
        feats = []
        if c.use_of:
            feats.append(data.of)
        if c.use_head:
            feats += [data.obj_head_relative_poses, data.head_vels]
        if c.use_action:
            feats.append(data.action_one_hot)
        return torch.cat(feats, dim=-1)

    def context_features(self, data: ClipData) -> torch.Tensor:
        """(B, T, rnn_hdim): the context GRU over every frame from h = 0."""
        return self.context_gru(self.context_input(data))[0]

    def init_states(self, data: ClipData):
        """The initial (qpos, qvel) predicted from the mean context feature,
        with xy and heading from the data's first frame; and the context
        features."""
        ctx = self.context_features(data)
        init_state = self.context_fc(self.context_mlp(ctx.mean(dim=1)))
        a = self.cfg.action_dim
        pred, init_pred_vel = init_state[..., :a], init_state[..., a:]
        init_pos = data.qpos[:, 0, :3]
        init_heading = tmath.heading_q(data.qpos[:, 0, 3:7])
        root_q = tmath.quat_norm(tmath.quat_mul(init_heading, pred[..., 1:5]))
        qpos0 = torch.cat([init_pos[..., :2], pred[..., 0:1], root_q,
                           pred[..., 5:QPOS_LM]], dim=-1)
        return qpos0, init_pred_vel, ctx

    def action(self, carry: torch.Tensor, state: torch.Tensor):
        """(GRU carry, AR state) -> (new carry, action)."""
        if self.cfg.model_v in (0, 1):
            carry = self.action_gru(state, carry)
            x = torch.cat([state, carry], dim=-1)
        else:
            x = state
        return carry, self.action_fc(self.action_mlp(x))

    def init_action_carry(self, batch: int, like: torch.Tensor) -> torch.Tensor:
        return like.new_zeros((batch, self.cfg.rnn_hdim))

    def obs_at(self, qpos, qvel, data: ClipData, t: int, ctx, noise=None):
        use_ctx = self.cfg.use_context or self.cfg.use_of
        return ar_obs(
            self.spec, self.st, self.cfg, qpos, qvel, data.head_pose[:, t],
            data.head_vels[:, t], data.obj_pose[:, t],
            data.obj_head_relative_poses[:, t], data.action_one_hot[:, t],
            None if data.of is None else data.of[:, t],
            ctx[:, t] if use_ctx else None, as_policy=self.as_policy,
            noise=noise)

    def forward(self, data: ClipData, gt_rate: float = 0.0,
                generator: torch.Generator | None = None,
                train: bool = False) -> dict:
        """The AR rollout over the whole window from the predicted initial
        state: per-frame features (B, T, ...) and actions, qvel shifted one
        frame forward. Scheduled sampling: with probability `gt_rate` the
        initial state, and at each later step the next state, is the
        data's, one Bernoulli draw for the whole batch each. With
        `train` and the config's ``add_noise`` the observations get noise
        (``ar_obs``). Draws come from `generator` (on the data's device;
        one seeded 0 if None)."""
        B, T = data.qpos.shape[:2]
        dev, dtype = data.qpos.device, data.qpos.dtype
        lo = torch.as_tensor(self.spec.jnt_range[:, 0], dtype=dtype, device=dev)
        hi = torch.as_tensor(self.spec.jnt_range[:, 1], dtype=dtype, device=dev)
        sampled = gt_rate > 0
        noisy = self.cfg.add_noise and train
        if generator is None and (sampled or noisy):
            generator = torch.Generator(device=dev).manual_seed(0)
        noise = generator if noisy else None

        def use_gt():
            return torch.rand((), generator=generator, dtype=dtype,
                              device=dev) < gt_rate

        qpos, qvel, ctx = self.init_states(data)
        if sampled:
            u = use_gt()
            qpos = torch.where(u, data.qpos[:, 0], qpos)
            qvel = torch.where(u, data.qvel[:, 0], qvel)
        state, feat = self.obs_at(qpos, qvel, data, 0, ctx, noise)
        gru = self.init_action_carry(B, qpos)
        feats = {k: [v] for k, v in feat.items()}
        acts = []
        for t in range(1, T):
            gru, act = self.action(gru, state)
            next_qpos = clamp_qpos(lo, hi, qpos, step_ar(qpos, act, self.cfg))
            qvel = tmath.qvel_fd(qpos, next_qpos, DT)
            qpos = next_qpos
            if sampled:
                u = use_gt()
                qpos = torch.where(u, data.qpos[:, t], qpos)
                qvel = torch.where(u, data.qvel[:, t], qvel)
            state, feat = self.obs_at(qpos, qvel, data, t, ctx, noise)
            acts.append(act)
            for k, v in feat.items():
                feats[k].append(v)
        acts.append(self.action(gru, state)[1])
        out = {k: torch.stack(v, dim=1) for k, v in feats.items()}
        out["action"] = torch.stack(acts, dim=1)
        q = out["qvel"]
        out["qvel"] = torch.cat([q[:, 1:], q[:, -2:-1]], dim=1)
        return out


# ---------------------------------------------------------------------------
# losses (reference compute_loss*, traj_ar_smpl_net.py:390-527)
# ---------------------------------------------------------------------------


def _quat_iden_loss(q_pred: torch.Tensor, q_gt: torch.Tensor) -> torch.Tensor:
    d = tmath.quat_mul(q_gt, tmath.quat_inv(q_pred))
    iden = torch.zeros_like(d)
    iden[..., 0] = 1.0
    return torch.sum((torch.abs(d) - iden) ** 2, dim=-1)


def _sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum((a - b) ** 2, dim=-1)


def compute_loss(cfg: TrajARConfig, feats: dict, data: ClipData):
    """The full-rollout supervised loss: root position and rotation, body
    pose, root linear and angular velocity, body positions, object-to-head
    position and rotation, weighted by the config."""
    pred_qpos, gt_qpos = feats["qpos"], data.qpos
    r_pos = _sq(gt_qpos[..., :3], pred_qpos[..., :3]).mean()
    r_rot = _quat_iden_loss(pred_qpos[..., 3:7], gt_qpos[..., 3:7]).mean()
    p_rot = _sq(gt_qpos[..., 7:], pred_qpos[..., 7:]).mean()
    pred_qvel, gt_qvel = feats["qvel"][:, :-1], data.qvel[:, 1:]
    vl = _sq(gt_qvel[..., :3], pred_qvel[..., :3]).mean()
    va = _sq(gt_qvel[..., 3:6], pred_qvel[..., 3:6]).mean()
    ee = _sq(data.wbpos, feats["pred_wbpos"]).mean()
    o2h, gt_o2h = feats["obj_2_head"], data.obj_head_relative_poses
    o_pos = _sq(gt_o2h[..., :3], o2h[..., :3]).mean()
    o_rot = _quat_iden_loss(o2h[..., 3:], gt_o2h[..., 3:]).mean()
    loss = (cfg.w_rp * r_pos + cfg.w_rr * r_rot + cfg.w_p * p_rot
            + cfg.w_v * vl + cfg.w_v * va + cfg.w_ee * ee
            + cfg.w_op * o_pos + cfg.w_or * o_rot)
    return loss, dict(r_pos=r_pos, r_rot=r_rot, p_rot=p_rot, vl=vl, va=va,
                      ee=ee, o_pos=o_pos, o_rot=o_rot)


def compute_loss_lite(st: SpecTensors, cfg: TrajARConfig, pred_qpos, gt_qpos,
                      reduce_mean: bool = True):
    """Per-frame qpos supervision: root position and rotation, body pose
    and body positions (FK with `st`)."""
    lead = pred_qpos.shape[:-1]
    pred_w = fklib.fk(st, pred_qpos).xpos.reshape(lead + (-1,))
    gt_w = fklib.fk(st, gt_qpos).xpos.reshape(gt_qpos.shape[:-1] + (-1,))
    r_pos = _sq(gt_qpos[..., :3], pred_qpos[..., :3])
    r_rot = _quat_iden_loss(pred_qpos[..., 3:7], gt_qpos[..., 3:7])
    p_rot = _sq(gt_qpos[..., 7:], pred_qpos[..., 7:])
    ee = _sq(gt_w, pred_w)
    loss = cfg.w_rp * r_pos + cfg.w_rr * r_rot + cfg.w_p * p_rot + cfg.w_ee * ee
    if reduce_mean:
        loss = loss.mean()
    return loss, dict(r_pos=r_pos.mean(), r_rot=r_rot.mean(),
                      p_rot=p_rot.mean(), ee=ee.mean())


def compute_loss_init(st: SpecTensors, cfg: TrajARConfig, pred_qpos, gt_qpos,
                      pred_qvel, gt_qvel):
    """The initial-state loss: ``compute_loss_lite`` on the qpos. The
    velocities are taken and not used, as in the reference."""
    del pred_qvel, gt_qvel
    return compute_loss_lite(st, cfg, pred_qpos, gt_qpos)
