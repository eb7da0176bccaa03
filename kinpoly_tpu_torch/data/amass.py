"""AMASS preprocessing (port of ``kinpoly_tpu/data/amass.py``).

Raw AMASS npz sequences (axis-angle SMPL poses and root translations at the
mocap frame rate) become 30 Hz qpos takes, grounded at the feet, with an
optional left/right mirrored copy of each. The SMPL conversion and the FK of
the grounding run on the device (float32 on the card); the frame skip and
the accept/reject decisions are Python on the host, as in the JAX package.
``process_amass_dir`` writes its bank as a plain pickle (protocol 4), which
``data.banks.read_bank`` and ``joblib.load`` both read.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim import smpl as smpllib
from kinpoly_tpu_torch.anim.spec import spec_tensors
from kinpoly_tpu_torch.physics import fk as fklib

# SMPL joint mirror map
LEFT_RIGHT_IDX = [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17,
                  16, 19, 18, 21, 20, 23, 22]


def load_amass_npz(path: str) -> dict | None:
    """One AMASS npz -> {poses (T, 72), trans (T, 3), framerate, betas}, or
    None for a file without poses. The fields read are numeric, so no
    pickled object in the file is ever loaded."""
    with np.load(path, allow_pickle=False) as z:
        if "poses" not in z:
            return None
        poses = z["poses"][:, :72].astype(np.float64)  # body joints only
        return dict(
            poses=poses,
            trans=z["trans"].astype(np.float64),
            framerate=float(z.get("mocap_framerate", z.get("mocap_frame_rate", 30.0))),
            betas=np.asarray(z.get("betas", np.zeros(10)))[:10],
        )


def flip_smpl(pose_aa: np.ndarray) -> np.ndarray:
    """Left/right mirror of an axis-angle SMPL pose sequence: swap the
    joints' sides and negate each axis-angle's y and z components."""
    p = pose_aa.reshape(-1, 24, 3)[:, LEFT_RIGHT_IDX].copy()
    p[..., 1] *= -1
    p[..., 2] *= -1
    return p.reshape(pose_aa.shape[0], 72)


def fix_height(spec, qpos: np.ndarray, gnd_thresh: float = -0.15,
               feet_offset: float = -0.015, begin_feet_thresh: float = 50.0,
               device=None, dtype: torch.dtype = torch.float32) -> np.ndarray | None:
    """Ground a take: shift its root z so that the first frame's lower toe
    rests on the floor. None for a take whose first toe height exceeds
    begin_feet_thresh or whose lowest body then sinks under gnd_thresh."""
    dev = resolve_device(device)
    st = spec_tensors(spec, dtype, dev)
    q = torch.as_tensor(np.asarray(qpos), dtype=dtype, device=dev)
    res = fklib.fk(st, q[:1])
    toe_l, toe_r = spec.body_index("L_Toe"), spec.body_index("R_Toe")
    begin_feet = float(torch.minimum(res.xpos[0, toe_l, 2], res.xpos[0, toe_r, 2]))
    if begin_feet > begin_feet_thresh:
        return None
    begin_feet += feet_offset
    out = qpos.copy()
    out[:, 2] -= begin_feet
    res_all = fklib.fk(st, torch.as_tensor(out, dtype=dtype, device=dev))
    if float(res_all.xpos[..., 2].min()) < gnd_thresh:
        return None
    return out


@torch.no_grad()
def amass_to_takes(spec, amass_db: dict, target_fps: float = 30.0,
                   min_len: int = 10, fix_feet: bool = True,
                   flip_augment: bool = False, device=None,
                   dtype: torch.dtype = torch.float32) -> dict:
    """{name: {poses, trans, framerate}} -> {name: {qpos, pose_aa, trans,
    seq_name}}: every int(round(framerate / target_fps))-th frame; sequences
    shorter than min_len frames and rejected groundings are dropped; a
    mirrored copy of each is named ``<name>_flip``. qpos has ``dtype``."""
    dev = resolve_device(device)
    takes = {}
    for name, v in amass_db.items():
        poses, trans, fr = v["poses"], v["trans"], v.get("framerate", 30.0)
        if poses.shape[0] < min_len:
            continue
        skip = max(int(round(fr / target_fps)), 1)
        variants = [(name, poses[::skip], trans[::skip])]
        if flip_augment:
            flipped = flip_smpl(poses[::skip])
            ftrans = trans[::skip].copy()
            ftrans[:, 0] *= -1
            variants.append((name + "_flip", flipped, ftrans))
        for vn, p, t in variants:
            qpos = smpllib.smpl_to_qpose(
                spec, torch.as_tensor(p, dtype=dtype, device=dev),
                torch.as_tensor(t, dtype=dtype, device=dev)).cpu().numpy()
            if fix_feet:
                qpos = fix_height(spec, qpos, device=dev, dtype=dtype)
                if qpos is None:
                    continue
            takes[vn] = dict(qpos=qpos, pose_aa=np.asarray(p),
                             trans=np.asarray(t), seq_name=vn)
    return takes


def process_amass_dir(spec, amass_root: str, out_path: str | None = None,
                      **kw) -> dict:
    """Every npz under amass_root (recursively, in sorted order), keyed by
    its relative path with '/' as '_', through ``amass_to_takes`` (``kw``);
    written to out_path when given."""
    db = {}
    for path in sorted(glob.glob(os.path.join(amass_root, "**", "*.npz"),
                                 recursive=True)):
        entry = load_amass_npz(path)
        if entry is not None:
            key = os.path.splitext(os.path.relpath(path, amass_root))[0].replace("/", "_")
            db[key] = entry
    takes = amass_to_takes(spec, db, **kw)
    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(takes, f, protocol=4)
    return takes


def gen_standing_take(spec, standing_qpos: np.ndarray, n_frames: int = 120) -> dict:
    """A standing take: standing_qpos repeated n_frames times."""
    return dict(qpos=np.repeat(standing_qpos[None], n_frames, 0),
                seq_name="standing")
