"""Feasibility grounding of keyframe-authored clips (port of
``kinpoly_tpu/data/ground_fix.py``).

Keyframed getup, situp and prone clips can interpolate a leg chain through
the floor; lifting the whole root to compensate makes a body that hovers
with no support, which no controller can track. ``ground_legs`` applies the
smallest per-frame hip-flexion change (one scalar added to both hips'
flexion slot) that keeps every leg contact vertex at or above the floor,
found by a grid search over deltas that holds whichever way a lying pose
faces; ``ground_arms`` does the same for the shoulders (mirrored slots).
The deltas are smoothed over time (Hann window) so that the correction
adds no velocity spikes. ``max_root_lift`` is the root lift that a floor fix
would still need: large means a levitating reference.

The grid search is one batched FK of grid x T frames on the device (7,350
for the legs of a 150-frame take); the choice of delta, the smoothing and
the clip to the joint ranges are numpy on the host, as in the JAX package.
Contact vertices are ``select_contact_vertices(spec, default_k=4)``.
"""

from __future__ import annotations

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.anim.spec import spec_tensors
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.physics import contact as ct
from kinpoly_tpu_torch.physics import fk as fklib

LEG_BODIES = ("L_Knee", "R_Knee", "L_Ankle", "R_Ankle", "L_Toe", "R_Toe")
ARM_BODIES = ("L_Elbow", "R_Elbow", "L_Wrist", "R_Wrist", "L_Hand", "R_Hand")


@torch.no_grad()
def _min_z(spec, q: np.ndarray, body_sel: np.ndarray, device,
           dtype: torch.dtype) -> np.ndarray:
    """Lowest world z over the contact vertices of the bodies in body_sel,
    per frame of q (..., 76)."""
    dev = resolve_device(device)
    verts, vbody = ct.select_contact_vertices(spec, default_k=4)
    sel = np.isin(vbody, body_sel)
    st = spec_tensors(spec, dtype, dev)
    res = fklib.fk(st, torch.as_tensor(q, dtype=dtype, device=dev))
    vb = torch.as_tensor(vbody[sel], device=dev)
    world = res.xpos[..., vb, :] + tmath.quat_rot_vec(
        res.xquat[..., vb, :], torch.as_tensor(verts[sel], dtype=dtype, device=dev))
    return world[..., 2].amin(dim=-1).cpu().numpy()


def leg_slots(spec) -> list[tuple[int, float]]:
    """Both hips' flexion (x-hinge) slot in qpos, each with sign +1."""
    names = list(spec.body_names)
    return [(7 + 3 * (names.index(f"{side}_Hip") - 1) + 2, 1.0)
            for side in ("L", "R")]


def arm_slots(spec) -> list[tuple[int, float]]:
    """Both shoulders' y-hinge slot in qpos, mirrored (-1 left, +1 right)."""
    names = list(spec.body_names)
    return [(7 + 3 * (names.index(f"{side}_Shoulder") - 1) + 1, sign)
            for side, sign in (("L", -1.0), ("R", 1.0))]


def _clip_hinges(spec, q: np.ndarray) -> None:
    """Clip q's hinges, in place, to 0.02 inside their ranges."""
    lo, hi = spec.jnt_range[:, 0] + 0.02, spec.jnt_range[:, 1] - 0.02
    q[..., 7:] = np.clip(q[..., 7:], lo, hi)


def _apply(spec, q: np.ndarray, slots, d: np.ndarray) -> np.ndarray:
    """q with the track d (T,), cast to q's dtype, added to every slot times
    its sign; hinges clipped."""
    out = q.copy()
    for slot, sign in slots:
        out[:, slot] += (sign * d).astype(q.dtype)
    _clip_hinges(spec, out)
    return out


def grid_min_z(spec, q: np.ndarray, slots, body_names_sel, max_delta: float,
               grid: int, device=None, dtype: torch.dtype = torch.float32):
    """The grid search's evaluation: deltas (G,) evenly over
    [-max_delta, max_delta] and the selected bodies' lowest contact vertex
    z (G, T) with each delta applied to every frame, from one FK of G x T
    frames."""
    names = list(spec.body_names)
    body_sel = np.asarray([names.index(n) for n in body_names_sel])
    T = q.shape[0]
    deltas = np.linspace(-max_delta, max_delta, grid)
    Q = np.repeat(q[None], grid, axis=0)                 # (G, T, 76)
    for slot, sign in slots:
        Q[..., slot] += sign * deltas[:, None]
    _clip_hinges(spec, Q)
    minz = _min_z(spec, Q.reshape(-1, q.shape[-1]), body_sel, device,
                  dtype).reshape(grid, T)
    return deltas, minz


def pick_deltas(deltas: np.ndarray, minz: np.ndarray,
                clearance: float) -> np.ndarray:
    """Per frame, the grid index of the smallest |delta| that lifts the
    vertices to clearance (ties to the lower index, the negative delta);
    where none does, the one that lifts them highest."""
    ok = minz >= clearance
    cost = np.abs(deltas)[:, None] + 1e3 * (~ok)
    return np.where(ok.any(axis=0), cost.argmin(axis=0), minz.argmax(axis=0))


def _grounding_delta(spec, q, slots, body_names_sel, clearance, max_delta,
                     grid, device, dtype, smooth=9):
    """The smoothed per-frame delta track (T,)."""
    deltas, minz = grid_min_z(spec, q, slots, body_names_sel, max_delta, grid,
                              device, dtype)
    d = deltas[pick_deltas(deltas, minz, clearance)]
    if smooth and smooth > 1:
        k = np.hanning(smooth)
        k /= k.sum()
        d = np.convolve(np.pad(d, smooth // 2, mode="edge"), k, mode="valid")
    return d


def ground_legs(spec, q: np.ndarray, clearance=0.005, max_delta=1.2, grid=49,
                device=None, dtype: torch.dtype = torch.float32):
    """Hip-flexion grounding: lift the leg contact vertices to the floor
    with the smallest symmetric hip-flexion change. Returns (q_fixed,
    delta_track)."""
    slots = leg_slots(spec)
    d = _grounding_delta(spec, q, slots, LEG_BODIES, clearance, max_delta,
                         grid, device, dtype)
    return _apply(spec, q, slots, d), d


def ground_arms(spec, q: np.ndarray, clearance=0.005, max_delta=0.9, grid=25,
                device=None, dtype: torch.dtype = torch.float32):
    """Shoulder grounding (mirrored slots): keep the elbow, wrist and hand
    vertices out of the floor in lying poses. Returns (q_fixed,
    delta_track)."""
    slots = arm_slots(spec)
    d = _grounding_delta(spec, q, slots, ARM_BODIES, clearance, max_delta,
                         grid, device, dtype)
    return _apply(spec, q, slots, d), d


def max_root_lift(spec, q: np.ndarray, clearance=0.01, device=None,
                  dtype: torch.dtype = torch.float32) -> float:
    """The largest root-z lift over the frames that would bring every
    contact vertex to clearance."""
    low = _min_z(spec, q, np.arange(len(spec.body_names)), device, dtype)
    return float(np.maximum(0.0, clearance - low).max())
