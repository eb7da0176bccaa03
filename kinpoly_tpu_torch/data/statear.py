"""StateAR takes: the egocentric-context data of the kinematic policy (port
of ``kinpoly_tpu/data/statear.py``).

``derive_features`` computes every feature of a take from its raw qpos
sequence and object pose with the port's FK; ``load_annotations`` reads a
bank through ``data/banks.read_bank`` (a list of derived takes, a dict of
annotated takes, or a raw qpos bank whose features it derives).
``StateARDataset`` samples fixed windows (host numpy) and gives whole takes
edge-padded to a common length. Features are computed on the CPU in the
input's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kinpoly_tpu_torch.anim.spec import HumanoidSpec, spec_tensors
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.data.banks import read_bank
from kinpoly_tpu_torch.models.traj_ar import ClipData
from kinpoly_tpu_torch.physics import fk as fklib

ACTIONS = ("sit", "push", "avoid", "step")
DT = 1.0 / 30


def _fd_vel(pose: torch.Tensor, dt: float) -> torch.Tensor:
    """Finite-difference velocity of a (..., T, 7+) pose track: linear in
    the heading frame, angular (wrapped) in the rotation's own frame; the
    last frame repeats."""
    cur, nxt = pose[..., :-1, :], pose[..., 1:, :]
    v = tmath.transform_vec((nxt[..., :3] - cur[..., :3]) / dt,
                            cur[..., 3:7], "heading")
    aa = tmath.rotation_from_quat(tmath.quat_mul(nxt[..., 3:7],
                                                 tmath.quat_inv(cur[..., 3:7])))
    ang = torch.linalg.norm(aa, dim=-1, keepdim=True)
    rv = torch.where(ang > 1e-12,
                     aa * tmath.wrap_to_pi(ang) / torch.clamp(ang, min=1e-12),
                     aa) / dt
    out = torch.cat([v, tmath.transform_vec(rv, cur[..., 3:7], "root")], dim=-1)
    return torch.cat([out, out[..., -1:, :]], dim=-2)


def get_head_vel(head_pose: torch.Tensor, dt: float = DT) -> torch.Tensor:
    """Head velocity (..., T, 6): linear in the head's heading frame,
    angular in the head frame."""
    return _fd_vel(head_pose, dt)


def get_root_vel(qpos: torch.Tensor, dt: float = DT) -> torch.Tensor:
    """Root velocity target (..., T, 6): linear in the heading frame,
    angular in the root frame."""
    return _fd_vel(qpos, dt)


def get_obj_relative_pose(obj_pose: torch.Tensor,
                          head_pose: torch.Tensor) -> torch.Tensor:
    """Object pose relative to the head: [heading-frame position offset 3,
    heading-relative quaternion 4]."""
    head_pos, head_rot = head_pose[..., :3], head_pose[..., 3:7]
    q_heading = tmath.heading_q(head_rot)
    diff = tmath.transform_vec(obj_pose[..., :3] - head_pos, head_rot, "heading")
    quat_local = tmath.quat_mul(tmath.quat_inv(q_heading), obj_pose[..., 3:7])
    return torch.cat([diff, quat_local], dim=-1)


def get_traj_de_heading(qpos: torch.Tensor, has_z: bool = True) -> torch.Tensor:
    """The AR target's pose part: qpos without xy, the root quaternion
    de-headed (with has_z, z kept: 74-d)."""
    dq = tmath.de_heading(qpos[..., 3:7])
    if has_z:
        return torch.cat([qpos[..., 2:3], dq, qpos[..., 7:]], dim=-1)
    body = qpos[..., 7:]
    body_fwd = torch.cat([body[..., 1:, :], body[..., -2:-1, :]], dim=-2)
    return torch.cat([dq, body_fwd], dim=-1)


# the parking spot of the secondary object slot (the table, object 2:
# convert_obj_qpos parks object i at ((i + 1) 100, 100, 0))
_PARK2 = np.asarray([300.0, 100.0, 0.0, 1.0, 0.0, 0.0, 0.0], np.float32)


def obj_pose14(obj_pose: np.ndarray, obj2_pose: np.ndarray | None = None):
    """(T, 7) active-object pose [+ (T, 7) secondary] -> (T, 14) float32;
    the secondary slot (push: the table) defaults to its parking spot."""
    obj_pose = np.asarray(obj_pose, np.float32)
    if obj_pose.shape[-1] >= 14:
        return obj_pose[..., :14]
    second = (np.asarray(obj2_pose, np.float32)[..., :7]
              if obj2_pose is not None
              else np.broadcast_to(_PARK2, obj_pose[..., :7].shape))
    return np.concatenate([obj_pose[..., :7], second], axis=-1)


def derive_features(spec: HumanoidSpec, qpos_seq: np.ndarray,
                    obj_pose: np.ndarray, action: str = "sit",
                    dt: float = DT, has_z: bool = True,
                    obj2_pose: np.ndarray | None = None) -> dict:
    """Raw qpos (T, 76) and object pose (T, 7) [+ the push table's] -> the
    StateAR take dict (numpy, in qpos_seq's dtype where computed)."""
    qpos = torch.as_tensor(np.asarray(qpos_seq))
    st = spec_tensors(spec, qpos.dtype, "cpu")
    T = qpos.shape[0]
    res = fklib.fk(st, qpos)
    head = spec.body_index("Head")
    head_pose = torch.cat([res.xpos[:, head], res.xquat[:, head]], dim=-1)
    qvel = tmath.qvel_fd(qpos[:-1], qpos[1:], dt)
    qvel = torch.cat([qvel[:1], qvel], dim=0)
    one_hot = np.zeros((T, len(ACTIONS)), dtype=np.asarray(qpos_seq).dtype)
    one_hot[:, ACTIONS.index(action)] = 1.0
    target = torch.cat([get_traj_de_heading(qpos, has_z),
                        get_root_vel(qpos, dt)], dim=-1)
    obj14 = obj_pose14(obj_pose, obj2_pose)
    rel = get_obj_relative_pose(
        torch.as_tensor(obj14[..., :7]).to(head_pose.dtype), head_pose)
    return dict(
        qpos=qpos.numpy(), qvel=qvel.numpy(),
        wbpos=res.xpos.reshape(T, -1).numpy(),
        wbquat=res.xquat.reshape(T, -1).numpy(),
        bquat=fklib.body_quat_sim(qpos).numpy(),
        head_pose=head_pose.numpy(), head_vels=get_head_vel(head_pose, dt).numpy(),
        obj_pose=obj14, obj_head_relative_poses=rel.numpy(),
        action_one_hot=one_hot, target=target.numpy(), action=action)


def _ewma(x: np.ndarray, alpha: float = 0.3) -> float:
    """Exponentially weighted success average (recent episodes weigh more);
    0 for a take with no history."""
    if x.size == 0:
        return 0.0
    w = (1.0 - alpha) ** np.arange(x.size)[::-1]
    return float((x * w).sum() / w.sum())


@dataclass
class StateARDataset:
    """Fixed-window sampler over a set of takes (host numpy)."""
    takes: list
    fr_num: int = 100
    fr_margin: int = 5

    def __post_init__(self):
        # longer takes are sampled proportionally more
        freq = []
        for i, t in enumerate(self.takes):
            freq += [i] * int(np.ceil(t["qpos"].shape[0] / self.fr_num))
        self.freq_indices = np.asarray(freq)

    @property
    def n_takes(self) -> int:
        return len(self.takes)

    def sample_window(self, rng: np.random.RandomState, take_idx=None,
                      freq_dict=None, sampling_temp: float = 0.3,
                      sampling_freq: float = 0.5):
        """(take, start, frames): with probability `sampling_freq` a take
        drawn with probability exp(-ewma(success) / temp) of its history in
        `freq_dict`, otherwise (and with no history) in proportion to its
        length."""
        if take_idx is not None:
            i = take_idx
        elif freq_dict:
            probs = np.exp(-np.array([
                _ewma(np.asarray(freq_dict.get(k, []), np.float64))
                for k in range(self.n_takes)]) / sampling_temp)
            probs = probs / probs.sum()
            if rng.binomial(1, sampling_freq):
                i = rng.choice(self.n_takes, p=probs)
            else:
                i = rng.choice(self.freq_indices)
        else:
            i = rng.choice(self.freq_indices)
        T = self.takes[i]["qpos"].shape[0]
        fr = min(self.fr_num, T - 1)
        return i, rng.randint(0, max(T - fr, 1)), fr

    def get_batch(self, rng: np.random.RandomState, batch_size: int,
                  use_of: bool = False, freq_dict=None,
                  sampling_temp: float = 0.3,
                  sampling_freq: float = 0.5) -> ClipData:
        """`batch_size` windows of fr_num frames (edge-padded), numpy."""
        fr = self.fr_num
        rows, lengths, take_ids = [], [], []
        for _ in range(batch_size):
            i, start, _ = self.sample_window(
                rng, freq_dict=freq_dict, sampling_temp=sampling_temp,
                sampling_freq=sampling_freq)
            take = self.takes[i]
            lengths.append(min(fr, take["qpos"].shape[0] - start))
            take_ids.append(i)
            sl = slice(start, start + fr)

            def win(x):
                w = x[sl]
                if w.shape[0] < fr:
                    w = np.concatenate([w, np.repeat(w[-1:], fr - w.shape[0], 0)])
                return w

            rows.append(dict(
                qpos=win(take["qpos"]), qvel=win(take["qvel"]),
                wbpos=win(take["wbpos"]), head_pose=win(take["head_pose"]),
                head_vels=win(take["head_vels"]),
                obj_pose=win(obj_pose14(take["obj_pose"])),
                obj_head_relative_poses=win(take["obj_head_relative_poses"][:, :7]),
                action_one_hot=win(take["action_one_hot"]),
                target=win(take["target"]),
                of=win(take["of"]) if use_of and "of" in take else None))
        batch = {k: (np.stack([r[k] for r in rows])
                     if rows[0][k] is not None else None) for k in rows[0]}
        return ClipData(**batch, length=np.asarray(lengths, np.int32),
                        take_idx=np.asarray(take_ids, np.int32))

    def whole_take(self, i: int, use_of: bool = False,
                   pad_to: int | None = None) -> ClipData:
        """Take i as a batch of one (numpy), every time axis edge-padded to
        `pad_to` frames; `length` keeps the true duration."""
        t = self.takes[i]

        def p(x):
            T = x.shape[0]
            if pad_to is None or T >= pad_to:
                return x[None]
            return np.concatenate([x, np.repeat(x[-1:], pad_to - T, axis=0)])[None]

        return ClipData(
            qpos=p(t["qpos"]), qvel=p(t["qvel"]), wbpos=p(t["wbpos"]),
            head_pose=p(t["head_pose"]), head_vels=p(t["head_vels"]),
            obj_pose=p(obj_pose14(t["obj_pose"])),
            obj_head_relative_poses=p(t["obj_head_relative_poses"][:, :7]),
            action_one_hot=p(t["action_one_hot"]), target=p(t["target"]),
            of=p(t["of"]) if use_of and "of" in t else None,
            length=np.asarray([t["qpos"].shape[0]], np.int32),
            take_idx=np.asarray([i], np.int32))


def stack_clips(clips: list[ClipData]) -> ClipData:
    """Concatenate numpy ClipData batches along the batch axis."""
    return ClipData(*(None if x[0] is None else np.concatenate(x, axis=0)
                      for x in zip(*clips)))


def clip_tensors(clip: ClipData, dtype: torch.dtype, device) -> ClipData:
    """A numpy ClipData as tensors: float fields in `dtype`, the integer
    fields int64, on `device`."""
    def t(x):
        if x is None:
            return None
        x = torch.as_tensor(np.asarray(x), device=device)
        return x.to(dtype) if x.is_floating_point() else x.to(torch.int64)
    return ClipData(*(t(x) for x in clip))


def load_annotations(path: str, spec: HumanoidSpec | None = None) -> list[dict]:
    """The takes of a bank: a list of derived takes as is, or a dict of
    takes by name; a raw take (no ``target``) gets its features derived
    from its qpos (float32) and object pose when `spec` is given."""
    data = read_bank(path)
    if isinstance(data, list):
        return data
    takes = []
    for name, take in data.items():
        take = dict(take)
        take["name"] = name
        if "target" not in take and spec is not None:
            q = np.asarray(take["qpos"], np.float32)
            obj = take.get("obj_pose")
            if obj is None:
                obj = np.zeros((q.shape[0], 7), np.float32)
                obj[:, :3] = [100.0, 100.0, 0.5]
                obj[:, 3] = 1.0
            raw = take
            take = derive_features(spec, q, np.asarray(obj, np.float32),
                                   action=take.get("action", "sit"),
                                   obj2_pose=take.get("table_pose"))
            take["name"] = name
            for k in ("of", "person_feat"):
                if k in raw:
                    take[k] = np.asarray(raw[k], np.float32)
        takes.append(take)
    return takes
