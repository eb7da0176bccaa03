"""The pose metric suite of the evaluation (port of
``kinpoly_tpu/metrics/pose_metrics.py``), for a predicted and a
ground-truth qpos trajectory (T, 76) on one physics model:

- mpjpe (mm): root-relative mean joint position error
- root_dist / head_dist: mean ||I - T_p T_g^-1||_F of 4x4 poses
- vel_dist: mean finite-difference qvel error (heading frame)
- accel_dist (mm): joint acceleration error x 1000
- slide (mm): foot displacement weighted 2 - 2^(h/H) while the pelvis is
  up and the foot is low
- penetration (mm): per frame, the deepest floor penetration beyond the
  margin of each body's contact candidates, summed over bodies, x 1000

and the per-action success rules (``action_success``): push moves the box
over 0.1 m; sit touches the chair with the hips or the lower spine; avoid
keeps bodies 0-11 off the Can and ends within 0.5 m of the ground-truth
head; step touches the step with a foot and raises the pelvis over 0.1 m;
a take that needed a fail-safe teleport fails. Contacts are tested at the
caller's vertices, or at ``select_contact_vertices(spec, default_k=4)``
(no extra foot candidates), as in the JAX package. ``success_push``,
``success_avoid``, ``success_sit`` and ``success_step`` are the rules'
building blocks on precomputed per-frame signals.
"""

from __future__ import annotations

import numpy as np
import torch

from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.physics import contact as ct
from kinpoly_tpu_torch.physics import fk as fklib

DT = 1.0 / 30


def root_matrices(qpos: torch.Tensor) -> torch.Tensor:
    """Rows [pos3, quat4, ...] -> (..., 4, 4) rigid transforms."""
    T_ = torch.zeros(qpos.shape[:-1] + (4, 4), dtype=qpos.dtype,
                     device=qpos.device)
    T_[..., :3, :3] = tmath.quat_to_mat(qpos[..., 3:7])
    T_[..., :3, 3] = qpos[..., :3]
    T_[..., 3, 3] = 1.0
    return T_


def frobenius_norm_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean ||I - x y^-1||_F over the leading dims, with the closed-form
    inverse of the rigid transform y."""
    R, t = y[..., :3, :3], y[..., :3, 3]
    y_inv = torch.zeros_like(y)
    y_inv[..., :3, :3] = R.transpose(-1, -2)
    y_inv[..., :3, 3] = -torch.einsum("...ji,...j->...i", R, t)
    y_inv[..., 3, 3] = 1.0
    err = torch.eye(4, dtype=x.dtype, device=x.device) - x @ y_inv
    return torch.sqrt(torch.sum(err * err, dim=(-2, -1))).mean()


def joint_vels(qpos: torch.Tensor, dt: float = DT) -> torch.Tensor:
    """Finite-difference qvel (T - 1, 75) with the linear part in the
    heading frame."""
    v = tmath.qvel_fd(qpos[:-1], qpos[1:], dt)
    lin = tmath.transform_vec((qpos[1:, :3] - qpos[:-1, :3]) / dt,
                              qpos[:-1, 3:7], "heading")
    return torch.cat([lin, v[:, 3:]], dim=-1)


def mpjpe(jpos_pred: torch.Tensor, jpos_gt: torch.Tensor) -> torch.Tensor:
    """(T, 24, 3) world joint positions -> mm."""
    p = jpos_pred - jpos_pred[:, 0:1]
    g = jpos_gt - jpos_gt[:, 0:1]
    return torch.linalg.norm(p - g, dim=2).mean() * 1000.0


def accel_dist(jpos_pred: torch.Tensor, jpos_gt: torch.Tensor) -> torch.Tensor:
    """Joint acceleration error x 1000; 0 for sequences too short to
    difference twice."""
    if jpos_pred.shape[0] < 3:
        return jpos_pred.new_zeros(())
    a_g = jpos_gt[:-2] - 2 * jpos_gt[1:-1] + jpos_gt[2:]
    a_p = jpos_pred[:-2] - 2 * jpos_pred[1:-1] + jpos_pred[2:]
    return torch.linalg.norm(a_p - a_g, dim=2).mean() * 1000.0


def foot_sliding(foot_pos: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
    """(T, 3) foot positions and (T, 76) qpos -> mm per frame."""
    H, z_thresh = 0.033, 0.65
    T = qpos.shape[0]
    foot = torch.cat([foot_pos[:, :2],
                      foot_pos[:, 2:] - foot_pos[:3, 2].mean()], dim=-1)
    disp = torch.linalg.norm(foot[1:, :2] - foot[:-1, :2], dim=1)
    h_avg = (foot[:-1, 2] + foot[1:, 2]) / 2
    subset = (h_avg < H) & (qpos[1:, 2] > z_thresh)
    stats = torch.abs(disp * (2.0 - 2.0 ** (h_avg / H))) * subset
    return stats.sum() / T * 1000.0


def penetration(model, qpos: torch.Tensor, margin: float = 0.005) -> torch.Tensor:
    """Floor penetration in mm: the model's contact candidates replayed
    through ``contact.floor_contacts`` (all of them, with the margin as a
    negative contact margin, so depth = -z - margin); per frame the deepest
    positive depth of each body, summed over bodies; mean over frames."""
    res = fklib.fk(model.st, qpos)
    cs = ct.floor_contacts(model.cand_verts, model.cand_body, res.xpos,
                           res.xquat, k_top=model.cand_verts.shape[0],
                           margin=-margin)
    per_body = torch.zeros(qpos.shape[:-1] + (model.spec.n_bodies,),
                           dtype=qpos.dtype, device=qpos.device)
    per_body = per_body.scatter_reduce(-1, cs.body, torch.relu(cs.depth), "amax")
    return per_body.sum(dim=-1).mean() * 1000.0


def evaluate_pair(model, qpos_pred: torch.Tensor, qpos_gt: torch.Tensor,
                  head_pose_gt: torch.Tensor | None = None,
                  dt: float = DT) -> dict:
    """The metric row of one take: {name: 0-dim tensor}."""
    spec = model.spec
    fk_p = fklib.fk(model.st, qpos_pred)
    fk_g = fklib.fk(model.st, qpos_gt)
    head = spec.body_index("Head")
    toe_l, toe_r = spec.body_index("L_Toe"), spec.body_index("R_Toe")

    head_pose_pred = torch.cat([fk_p.xpos[:, head], fk_p.xquat[:, head]], dim=-1)
    if head_pose_gt is None:
        head_pose_gt = torch.cat([fk_g.xpos[:, head], fk_g.xquat[:, head]], dim=-1)

    def slide(res, qpos):
        return (foot_sliding(res.xpos[:, toe_l], qpos)
                + foot_sliding(res.xpos[:, toe_r], qpos)) / 2

    return dict(
        root_dist=frobenius_norm_dist(root_matrices(qpos_pred),
                                      root_matrices(qpos_gt)),
        head_dist=frobenius_norm_dist(root_matrices(head_pose_pred),
                                      root_matrices(head_pose_gt)),
        mpjpe=mpjpe(fk_p.xpos, fk_g.xpos),
        accel_dist=accel_dist(fk_p.xpos, fk_g.xpos),
        vel_dist=torch.linalg.norm(joint_vels(qpos_pred, dt)
                                   - joint_vels(qpos_gt, dt), dim=1).mean(),
        slide_pred=slide(fk_p, qpos_pred),
        slide_gt=slide(fk_g, qpos_gt),
        pen_pred=penetration(model, qpos_pred),
        pen_gt=penetration(model, qpos_gt),
    )


def success_push(obj_pose_seq: torch.Tensor, thresh: float = 0.1) -> torch.Tensor:
    """The box moved over `thresh` m between the first and the last pose
    of (T, 7)."""
    return torch.linalg.norm(obj_pose_seq[-1, :3] - obj_pose_seq[0, :3],
                             dim=-1) > thresh


def success_avoid(head_pose_pred: torch.Tensor, head_pose_gt: torch.Tensor,
                  min_step_dist, thresh: float = 0.5) -> torch.Tensor:
    """No contact with the obstacle (its minimum distance over the take
    above 0) and the last head position within `thresh` m of the ground
    truth's."""
    drift = torch.linalg.norm(head_pose_pred[-1, :3] - head_pose_gt[-1, :3],
                              dim=-1)
    return (torch.as_tensor(min_step_dist) > 0.0) & (drift < thresh)


def success_sit(hip_chair_contact_frames: torch.Tensor,
                min_contig: int = 5) -> torch.Tensor:
    """At least `min_contig` consecutive frames of hip-chair contact: the
    longest run of True, from the cumulative count less its value at the
    last False frame."""
    x = hip_chair_contact_frames.to(torch.int64)
    c = torch.cumsum(x, dim=0)
    runs = c - torch.cummax(torch.where(x == 0, c, torch.zeros_like(c)),
                            dim=0).values
    return runs.max() >= min_contig


def success_step(foot_on_step_frames: torch.Tensor, pelvis_z: torch.Tensor,
                 base_z, raise_thresh: float = 0.1) -> torch.Tensor:
    """A foot on the step in some frame and the pelvis raised over
    `raise_thresh` m above `base_z` in some frame."""
    return foot_on_step_frames.any() & ((pelvis_z.max() - base_z) > raise_thresh)


# the success rules' bodies (spec body order): sit uses Pelvis, the hips,
# Torso and Spine against the chair; avoid bodies 0-11 against the Can;
# step the ankles and toes against the step
ACTIONS = ("sit", "push", "avoid", "step")
_SIT_BODIES = (0, 1, 5, 9, 10)
_AVOID_BODIES = tuple(range(12))
_STEP_BODIES = (3, 4, 7, 8)
# the object each action is about, by name
ACTION_OBJECT_NAMES = {"sit": "chair", "push": "box", "avoid": "Can",
                       "step": "step"}


def action_object_indices(spec) -> np.ndarray:
    """(4,) object index per action in ACTIONS order, by the spec's object
    names (all four must be there)."""
    names = [o.name for o in spec.objects]
    missing = [n for n in ACTION_OBJECT_NAMES.values() if n not in names]
    if missing:
        raise ValueError(f"scene lacks interactable objects {missing}: {names}")
    return np.asarray([names.index(ACTION_OBJECT_NAMES[a]) for a in ACTIONS],
                      np.int64)


def _contact_frames(model, qpos_seq, obj_seq, bodies, obj_idx, verts,
                    vert_body, margin: float = 0.005) -> torch.Tensor:
    """(T,) bool: a candidate vert of `bodies` within `margin` of a geom of
    object `obj_idx` (signed distance)."""
    res = fklib.fk(model.st, qpos_seq)
    world = res.xpos[..., vert_body, :] + tmath.quat_rot_vec(
        res.xquat[..., vert_body, :], verts)
    dist = ct.object_point_distances(model.scene, obj_seq, world)[0]
    sel_g = model.scene.obj == obj_idx
    sel_p = torch.isin(vert_body, torch.as_tensor(bodies, device=vert_body.device))
    d = dist[:, sel_g][:, :, sel_p]
    return (d <= margin).flatten(1).any(dim=-1)


def action_success(model, qpos_pred: torch.Tensor, obj_seq: torch.Tensor,
                   action: str, head_pose_pred=None, head_pose_gt=None,
                   fail_safe_used: bool = False, verts=None,
                   vert_body=None) -> bool:
    """The per-action success of one take. qpos_pred (T, 76); obj_seq
    (T, n_obj, 7) simulated object poses, or (n_obj, 7) held for the take;
    contacts are tested at `verts` (V, 3) on bodies `vert_body` (V,), by
    default ``select_contact_vertices(spec, default_k=4)``."""
    if verts is None:
        verts, vert_body = ct.select_contact_vertices(model.spec, default_k=4)
    verts = torch.as_tensor(verts, dtype=qpos_pred.dtype, device=qpos_pred.device)
    vert_body = torch.as_tensor(vert_body, device=qpos_pred.device)
    if obj_seq.dim() == 2:
        obj_seq = obj_seq.expand((qpos_pred.shape[0],) + obj_seq.shape)
    obj_of = dict(zip(ACTIONS, (int(i) for i in
                                action_object_indices(model.spec))))
    if action == "push":
        box = obj_seq[:, obj_of["push"], :3]
        succ = bool(torch.linalg.norm(box - box[0], dim=-1).max() > 0.1)
    elif action == "sit":
        succ = bool(_contact_frames(model, qpos_pred, obj_seq, _SIT_BODIES,
                                    obj_of["sit"], verts, vert_body).any())
    elif action == "avoid":
        hit = _contact_frames(model, qpos_pred, obj_seq, _AVOID_BODIES,
                              obj_of["avoid"], verts, vert_body)
        drift = float(torch.linalg.norm(head_pose_pred[-1, :3]
                                        - head_pose_gt[-1, :3]))
        succ = (not bool(hit.any())) and drift <= 0.5
    elif action == "step":
        hit = _contact_frames(model, qpos_pred, obj_seq, _STEP_BODIES,
                              obj_of["step"], verts, vert_body)
        raise_ = qpos_pred[:, 2] - qpos_pred[0, 2]
        succ = bool(hit.any()) and bool((raise_ > 0.1).any())
    else:   # no action
        succ = True
    return succ and not fail_safe_used
