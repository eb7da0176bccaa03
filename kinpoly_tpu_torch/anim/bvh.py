"""BVH motion capture: parse a file into a joint tree and per-frame channel
data, turn the channels into root positions and joint quaternions, and
write an MJCF humanoid for the skeleton (port of ``kinpoly_tpu/anim/
bvh.py``; reference ``kin_poly/mocap/bvh.py``, ``uhc/khrylib/mocap/
{skeleton.py,mocap_to_mujoco.py}``).

``parse_bvh`` and ``skeleton_to_mjcf`` are host numpy; ``bvh_to_pose``
composes the rotation channels on tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.core import tmath


@dataclass
class BVHJoint:
    name: str
    parent: int
    offset: np.ndarray
    channels: list[str] = field(default_factory=list)
    children: list[int] = field(default_factory=list)
    is_end: bool = False


@dataclass
class BVHData:
    joints: list[BVHJoint]
    frames: np.ndarray        # (T, n_channels)
    frame_time: float

    @property
    def fps(self) -> float:
        return 1.0 / self.frame_time


def parse_bvh(path: str) -> BVHData:
    with open(path) as f:
        tokens = f.read().split()

    joints: list[BVHJoint] = []
    stack: list[int] = []
    i = 0

    def expect(tok):
        nonlocal i
        assert tokens[i].upper() == tok, (tokens[i], tok)
        i += 1

    expect("HIERARCHY")
    while i < len(tokens):
        t = tokens[i].upper()
        if t in ("ROOT", "JOINT"):
            i += 1
            name = tokens[i]
            i += 1
            expect("{")
            parent = stack[-1] if stack else -1
            joints.append(BVHJoint(name=name, parent=parent, offset=np.zeros(3)))
            idx = len(joints) - 1
            if parent >= 0:
                joints[parent].children.append(idx)
            stack.append(idx)
        elif t == "END":
            i += 2  # 'End Site'
            expect("{")
            parent = stack[-1]
            joints.append(BVHJoint(name=joints[parent].name + "_end",
                                   parent=parent, offset=np.zeros(3), is_end=True))
            joints[parent].children.append(len(joints) - 1)
            stack.append(len(joints) - 1)
        elif t == "OFFSET":
            joints[stack[-1]].offset = np.array(
                [float(tokens[i + 1]), float(tokens[i + 2]), float(tokens[i + 3])])
            i += 4
        elif t == "CHANNELS":
            n = int(tokens[i + 1])
            joints[stack[-1]].channels = [c.upper() for c in tokens[i + 2:i + 2 + n]]
            i += 2 + n
        elif t == "}":
            stack.pop()
            i += 1
        elif t == "MOTION":
            i += 1
            break
        else:
            i += 1

    expect("FRAMES:")
    n_frames = int(tokens[i]); i += 1
    assert tokens[i].upper() == "FRAME" and tokens[i + 1].upper() == "TIME:"
    i += 2
    frame_time = float(tokens[i]); i += 1
    vals = np.array([float(x) for x in tokens[i:]], dtype=np.float64)
    n_ch = sum(len(j.channels) for j in joints)
    frames = vals[: n_frames * n_ch].reshape(n_frames, n_ch)
    return BVHData(joints=joints, frames=frames, frame_time=frame_time)


def bvh_to_pose(bvh: BVHData, scale: float = 0.01, degrees: bool = True,
                device=None, dtype: torch.dtype = torch.float32):
    """BVH channels -> (root_pos (T, 3) float64 or None, joint quats
    (T, J, 4)) as numpy. Each joint with channels composes its rotation
    channels left to right in the file's order; position channels scale by
    `scale`; end sites and joints without channels are skipped. `pos` is
    the root's position (zeros without position channels), None when the
    root has no channels at all."""
    dev = resolve_device(device)
    T = bvh.frames.shape[0]
    frames = torch.as_tensor(bvh.frames, dtype=dtype, device=dev)
    quats, pos = [], None
    ch_off = 0
    for j in bvh.joints:
        nc = len(j.channels)
        data = bvh.frames[:, ch_off:ch_off + nc]
        ang_data = frames[:, ch_off:ch_off + nc]
        ch_off += nc
        if j.is_end or nc == 0:
            continue
        p = np.zeros((T, 3))
        qj = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev).expand(T, 4)
        for ci, ch in enumerate(j.channels):
            if ch.endswith("POSITION"):
                p[:, "XYZ".index(ch[0])] = data[:, ci] * scale
            else:
                ang = torch.deg2rad(ang_data[:, ci]) if degrees else ang_data[:, ci]
                axis = torch.zeros(3, dtype=dtype, device=dev)
                axis["XYZ".index(ch[0])] = 1.0
                qj = tmath.quat_mul(qj, tmath.quat_about_axis(ang, axis))
        if j.parent == -1:
            pos = p
        quats.append(qj)
    return pos, torch.stack(quats, dim=1).cpu().numpy()


def skeleton_to_mjcf(bvh: BVHData, scale: float = 0.01,
                     density: float = 1000.0) -> str:
    """Emit an MJCF humanoid for the BVH skeleton: capsule geoms along each
    bone, 3 hinge joints (z, y, x) per non-root joint (the reference's
    skeleton.py:write_xml structure)."""
    lines = [
        '<mujoco model="bvh_skeleton">',
        '  <compiler angle="radian" inertiafromgeom="true"/>',
        '  <default>',
        '    <joint damping="0" armature="0.01" limited="true"/>',
        '    <geom condim="1" contype="7" conaffinity="7" margin="0.001"/>',
        '  </default>',
        '  <worldbody>',
        '    <geom name="floor" type="plane" condim="3" size="50 50 .2"/>',
    ]

    def emit(idx: int, indent: str):
        j = bvh.joints[idx]
        if j.is_end:
            return
        off = j.offset * scale
        lines.append(f'{indent}<body name="{j.name}" pos="{off[0]} {off[1]} {off[2]}">')
        if j.parent == -1:
            lines.append(f'{indent}  <joint name="{j.name}" type="free" limited="false" armature="0"/>')
        else:
            for ax, vec in zip("zyx", ("0 0 1", "0 1 0", "1 0 0")):
                lines.append(
                    f'{indent}  <joint name="{j.name}_{ax}" type="hinge" '
                    f'axis="{vec}" range="-3.14159 3.14159"/>')
        # capsule to the mean child offset (or a small sphere for leaves)
        child_offsets = [bvh.joints[c].offset * scale for c in j.children]
        if child_offsets:
            end = np.mean(child_offsets, axis=0)
            if np.linalg.norm(end) > 1e-6:
                lines.append(
                    f'{indent}  <geom type="capsule" size="0.04" '
                    f'fromto="0 0 0 {end[0]} {end[1]} {end[2]}"/>')
            else:
                lines.append(f'{indent}  <geom type="sphere" size="0.05"/>')
        else:
            lines.append(f'{indent}  <geom type="sphere" size="0.05"/>')
        for c in j.children:
            emit(c, indent + "  ")
        lines.append(f'{indent}</body>')

    emit(0, "    ")
    lines += ["  </worldbody>", "  <actuator>"]
    for j in bvh.joints:
        if j.parent >= 0 and not j.is_end:
            for ax in "zyx":
                lines.append(f'    <motor joint="{j.name}_{ax}" gear="1"/>')
    lines += ["  </actuator>", "</mujoco>"]
    return "\n".join(lines)
