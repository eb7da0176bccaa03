"""Static humanoid description (as ``kinpoly_tpu/anim/mjcf.py:41-100``)
and a synthetic SMPL humanoid built in code.

The JAX package parses the reference's SMPL-neutral MJCF and STL meshes;
those assets are not in this repository, so the port runs on
``synthetic_spec``: the same kinematic tree (24 bodies in SMPL bone order, a
free root and 23 three-hinge joints, nv = 75, nq = 76), SMPL-like bone
offsets in the SMPL y-up rest frame, box meshes, diagonal inertias, hinge
armature 0.01 and a 450 Hz timestep. Every width the trained controller
sees (784-wide observation, 75 actions) is the real one. Parsing the real
MJCF waits until the assets are in the repository.

``synthetic_spec(seed, with_objects=True)`` adds the AR scene's five free
objects, built in code in the reference scene's order (chair, box, table,
Can, step): boxes and one cylinder at household sizes and masses, posed so
that each rests on the floor at the object-frame height the AR takes use.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

# canonical SMPL bone order (kinpoly_tpu/anim/mjcf.py:31-40)
SMPL_BONE_NAMES = [
    "Pelvis", "L_Hip", "L_Knee", "L_Ankle", "L_Toe",
    "R_Hip", "R_Knee", "R_Ankle", "R_Toe",
    "Torso", "Spine", "Chest", "Neck", "Head",
    "L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand",
    "R_Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand",
]


@dataclass(frozen=True)
class Geom:
    """A primitive collision geom attached to a body, in body-local frame."""
    body: int
    gtype: str                # 'plane' | 'box' | 'cylinder' | 'sphere' | 'capsule'
    size: np.ndarray
    pos: np.ndarray           # (3,)
    quat: np.ndarray          # (4,) wxyz
    friction: np.ndarray      # (3,)
    condim: int
    margin: float
    mass: float | None = None


@dataclass(frozen=True)
class ObjectSpec:
    """A free-floating interactable object (chair/box/table/Can/step)."""
    name: str
    geoms: tuple[Geom, ...]
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.eye(3))


@dataclass(frozen=True)
class HumanoidSpec:
    """Static description of the SMPL humanoid. All numpy, host-side."""

    body_names: tuple[str, ...]        # (24,)
    parents: np.ndarray                # (24,) int, -1 for Pelvis
    body_pos: np.ndarray               # (24, 3) local offset from parent
    body_ipos: np.ndarray              # (24, 3) local CoM
    body_mass: np.ndarray              # (24,)
    body_inertia: np.ndarray           # (24, 3, 3) about CoM, body frame
    joint_axes: np.ndarray             # (23, 3, 3) hinge axes rows (z, y, x)
    jnt_range: np.ndarray              # (69, 2) radians
    armature: np.ndarray               # (75,) added rotor inertia per dof
    timestep: float
    mesh_verts: tuple[np.ndarray, ...]  # per body (Vi, 3) local frame
    mesh_faces: tuple[np.ndarray, ...]
    objects: tuple[ObjectSpec, ...]
    floor_friction: np.ndarray         # (3,)
    geom_margin: float

    @property
    def n_bodies(self) -> int:
        return len(self.body_names)

    @property
    def nq(self) -> int:
        return 7 + 3 * (self.n_bodies - 1)

    @property
    def nv(self) -> int:
        return 6 + 3 * (self.n_bodies - 1)

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)


class SpecTensors(NamedTuple):
    """The spec's per-body arrays as tensors of one dtype on one device
    (what the kinematics and dynamics read every substep)."""
    parents: tuple            # python ints
    parent_idx: torch.Tensor  # (B-1,) int64 parents of bodies 1..B-1
    body_pos: torch.Tensor    # (B, 3)
    body_ipos: torch.Tensor   # (B, 3)
    body_mass: torch.Tensor   # (B,)
    body_inertia: torch.Tensor  # (B, 3, 3)
    armature: torch.Tensor    # (nv,)
    mass_frac: torch.Tensor   # (B,) body_mass / total mass


def spec_tensors(spec: HumanoidSpec, dtype: torch.dtype,
                 device) -> SpecTensors:
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return SpecTensors(
        parents=tuple(int(p) for p in spec.parents),
        parent_idx=torch.as_tensor(np.asarray(spec.parents[1:], np.int64),
                                   device=device),
        body_pos=t(spec.body_pos), body_ipos=t(spec.body_ipos),
        body_mass=t(spec.body_mass), body_inertia=t(spec.body_inertia),
        armature=t(spec.armature),
        mass_frac=t(spec.body_mass / spec.body_mass.sum()))


# ---------------------------------------------------------------------------
# synthetic SMPL humanoid
# ---------------------------------------------------------------------------

_PARENT = {
    "Pelvis": None, "L_Hip": "Pelvis", "L_Knee": "L_Hip", "L_Ankle": "L_Knee",
    "L_Toe": "L_Ankle", "R_Hip": "Pelvis", "R_Knee": "R_Hip",
    "R_Ankle": "R_Knee", "R_Toe": "R_Ankle", "Torso": "Pelvis",
    "Spine": "Torso", "Chest": "Spine", "Neck": "Chest", "Head": "Neck",
    "L_Thorax": "Chest", "L_Shoulder": "L_Thorax", "L_Elbow": "L_Shoulder",
    "L_Wrist": "L_Elbow", "L_Hand": "L_Wrist", "R_Thorax": "Chest",
    "R_Shoulder": "R_Thorax", "R_Elbow": "R_Shoulder", "R_Wrist": "R_Elbow",
    "R_Hand": "R_Wrist",
}

# bone offsets from the parent joint (m), SMPL-neutral-like rest skeleton in
# the SMPL frame: +y up, +x to the body's left, +z forward
_OFFSET = {
    "Pelvis": (0.0, 0.0, 0.0),
    "L_Hip": (0.0585, -0.0823, -0.0177), "R_Hip": (-0.0603, -0.0905, -0.0135),
    "L_Knee": (0.0433, -0.3865, 0.0084), "R_Knee": (-0.0433, -0.3831, -0.0048),
    "L_Ankle": (-0.0148, -0.4269, -0.0374), "R_Ankle": (0.0191, -0.4200, -0.0346),
    "L_Toe": (0.0411, -0.0603, 0.1220), "R_Toe": (-0.0348, -0.0621, 0.1303),
    "Torso": (0.0044, 0.1244, -0.0384), "Spine": (0.0045, 0.1380, 0.0268),
    "Chest": (-0.0023, 0.0560, 0.0029), "Neck": (-0.0134, 0.2116, -0.0335),
    "Head": (0.0101, 0.0889, 0.0504),
    "L_Thorax": (0.0717, 0.1140, -0.0189), "R_Thorax": (-0.0830, 0.1125, -0.0237),
    "L_Shoulder": (0.1229, 0.0452, -0.0190), "R_Shoulder": (-0.1132, 0.0469, -0.0085),
    "L_Elbow": (0.2553, -0.0156, -0.0229), "R_Elbow": (-0.2601, -0.0144, -0.0313),
    "L_Wrist": (0.2657, 0.0127, -0.0074), "R_Wrist": (-0.2692, 0.0068, -0.0060),
    "L_Hand": (0.0867, -0.0106, -0.0156), "R_Hand": (-0.0888, -0.0099, -0.0137),
}

# box half-thickness around each bone (m); leaves get a fixed extent
_RADIUS = {
    "Pelvis": 0.09, "L_Hip": 0.07, "R_Hip": 0.07, "L_Knee": 0.05,
    "R_Knee": 0.05, "L_Ankle": 0.04, "R_Ankle": 0.04, "L_Toe": 0.03,
    "R_Toe": 0.03, "Torso": 0.08, "Spine": 0.08, "Chest": 0.09,
    "Neck": 0.045, "Head": 0.08, "L_Thorax": 0.05, "R_Thorax": 0.05,
    "L_Shoulder": 0.045, "R_Shoulder": 0.045, "L_Elbow": 0.035,
    "R_Elbow": 0.035, "L_Wrist": 0.03, "R_Wrist": 0.03, "L_Hand": 0.03,
    "R_Hand": 0.03,
}
_LEAF_EXTENT = {
    "Head": (0.0, 0.15, 0.02), "L_Toe": (0.0, 0.0, 0.05),
    "R_Toe": (0.0, 0.0, 0.05), "L_Hand": (0.08, 0.0, 0.0),
    "R_Hand": (-0.08, 0.0, 0.0),
}

# hinge ranges in degrees, rows (z, y, x) per body: z is the forward axis
# (ab/adduction), y the vertical (twist), x the lateral (flexion)
_RANGE_DEG = {
    "Hip": ((-60, 60), (-60, 60), (-120, 30)),
    "Knee": ((-10, 10), (-10, 10), (-2, 150)),
    "Ankle": ((-30, 30), (-30, 30), (-45, 45)),
    "Toe": ((-10, 10), (-10, 10), (-30, 45)),
    "Torso": ((-45, 45), (-45, 45), (-45, 60)),
    "Spine": ((-45, 45), (-45, 45), (-45, 60)),
    "Chest": ((-45, 45), (-45, 45), (-45, 60)),
    "Neck": ((-60, 60), (-60, 60), (-60, 60)),
    "Head": ((-45, 45), (-60, 60), (-45, 45)),
    "Thorax": ((-20, 20), (-20, 20), (-20, 20)),
    "Shoulder": ((-100, 100), (-100, 100), (-120, 120)),
    "Elbow": ((-5, 5), (-150, 5), (-5, 5)),
    "Wrist": ((-60, 60), (-60, 60), (-60, 60)),
    "Hand": ((-30, 30), (-30, 30), (-30, 30)),
}

TOTAL_MASS = 70.0
HINGE_ARMATURE = 0.01
TIMESTEP = 1.0 / 450.0
GEOM_MARGIN = 0.001

_BOX_FACES = np.asarray([
    [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
    [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
], dtype=np.int32)


def _box_corners(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return np.asarray([[(lo, hi)[i][0], (lo, hi)[j][1], (lo, hi)[k][2]]
                       for i in (0, 1) for j in (0, 1) for k in (0, 1)])


def synthetic_spec(seed: int = 0, with_objects: bool = False) -> HumanoidSpec:
    """The synthetic SMPL humanoid. Box corners carry a seeded jitter of up
    to 2 mm so that no two contact candidates tie in height or in support
    direction: candidate selection and per-substep top-k then have one
    answer, whatever order a framework breaks ties in. ``with_objects``
    adds ``synthetic_objects()``; without it the spec has no objects."""
    rng = np.random.RandomState(seed)
    names = SMPL_BONE_NAMES
    parents = np.asarray([-1 if _PARENT[n] is None else names.index(_PARENT[n])
                          for n in names], dtype=np.int32)
    body_pos = np.asarray([_OFFSET[n] for n in names], dtype=np.float64)
    children = {i: [c for c in range(len(names)) if parents[c] == i]
                for i in range(len(names))}

    verts, faces, ipos, vol, dims = [], [], [], [], []
    for i, n in enumerate(names):
        pts = [np.zeros(3)] + [body_pos[c] for c in children[i]]
        if not children[i]:
            pts.append(np.asarray(_LEAF_EXTENT[n]))
        pts = np.stack(pts)
        lo = pts.min(0) - _RADIUS[n]
        hi = pts.max(0) + _RADIUS[n]
        corners = _box_corners(lo, hi) + rng.uniform(-0.002, 0.002, (8, 3))
        verts.append(corners)
        faces.append(_BOX_FACES.copy())
        ipos.append(0.5 * (lo + hi))
        d = hi - lo
        dims.append(d)
        vol.append(float(np.prod(d)))
    vol = np.asarray(vol)
    mass = TOTAL_MASS * vol / vol.sum()
    dims = np.stack(dims)
    inertia = np.zeros((len(names), 3, 3))
    for i, (m, d) in enumerate(zip(mass, dims)):
        inertia[i] = np.diag(m / 12.0 * np.asarray(
            [d[1] ** 2 + d[2] ** 2, d[0] ** 2 + d[2] ** 2, d[0] ** 2 + d[1] ** 2]))

    axes = np.asarray([[0.0, 0, 1], [0, 1, 0], [1, 0, 0]])
    jnt_range = []
    for n in names[1:]:
        key = n.split("_")[-1]
        jnt_range.extend(np.deg2rad(np.asarray(_RANGE_DEG[key], np.float64)))
    armature = np.full(6 + 3 * (len(names) - 1), HINGE_ARMATURE)
    armature[:6] = 0.0

    return HumanoidSpec(
        body_names=tuple(names),
        parents=parents,
        body_pos=body_pos,
        body_ipos=np.stack(ipos),
        body_mass=mass,
        body_inertia=inertia,
        joint_axes=np.repeat(axes[None], len(names) - 1, axis=0),
        jnt_range=np.stack(jnt_range),
        armature=armature,
        timestep=TIMESTEP,
        mesh_verts=tuple(verts),
        mesh_faces=tuple(faces),
        objects=synthetic_objects() if with_objects else (),
        floor_friction=np.asarray([1.0, 0.1, 0.1]),
        geom_margin=GEOM_MARGIN,
    )


# the AR scene's objects: (name, mass kg, [(gtype, size, pos)]) in the
# reference scene's order. Object frames sit where the AR takes pose them:
# the chair's at its seat (seat top +0.02, legs to -0.38), the box's 0.1
# above its centre (it rests on the table top at -0.22), the table's 0.09
# above its top (legs to -0.79), the Can's at its lid (bottom at -0.69)
# and the step's 0.03 above its top (bottom at -0.37); box sizes are
# half-extents, the cylinder's (radius, half-height)
_OBJECTS = (
    ("chair", 7.0, [("box", (0.22, 0.22, 0.02), (0.0, 0.0, 0.0))]
     + [("box", (0.02, 0.02, 0.18), (sx * 0.19, sy * 0.19, -0.2))
        for sx in (-1, 1) for sy in (-1, 1)]
     + [("box", (0.22, 0.02, 0.25), (0.0, -0.2, 0.27))]),
    ("box", 1.0, [("box", (0.15, 0.19, 0.12), (0.0, 0.0, -0.1))]),
    ("table", 25.0, [("box", (0.45, 0.65, 0.02), (0.0, 0.0, -0.11))]
     + [("box", (0.03, 0.03, 0.34), (sx * 0.4, sy * 0.6, -0.45))
        for sx in (-1, 1) for sy in (-1, 1)]),
    ("Can", 3.0, [("cylinder", (0.279, 0.345), (0.0, 0.0, -0.345))]),
    ("step", 9.0, [("box", (0.4, 0.4, 0.17), (0.0, 0.0, -0.2))]),
)


def _geom_volume(gtype: str, size: np.ndarray) -> float:
    if gtype == "box":
        return 8.0 * float(np.prod(size))
    return 2.0 * np.pi * size[0] ** 2 * size[1]


def _geom_inertia(gtype: str, size: np.ndarray, m: float) -> np.ndarray:
    """Solid box (half-extents) or z-aligned cylinder (radius,
    half-height) about its centre."""
    if gtype == "box":
        s = size
        return np.diag(m / 3.0 * np.asarray(
            [s[1] ** 2 + s[2] ** 2, s[0] ** 2 + s[2] ** 2, s[0] ** 2 + s[1] ** 2]))
    r, h = size[0], size[1]
    return np.diag(m * np.asarray([r * r / 4 + h * h / 3,
                                   r * r / 4 + h * h / 3, r * r / 2]))


def synthetic_objects() -> tuple[ObjectSpec, ...]:
    """The five free objects of the AR scene. Each object's mass is spread
    over its geoms by volume; CoM and inertia (about the CoM, object frame)
    follow from the solid geoms and the parallel-axis theorem."""
    out = []
    for name, mass, parts in _OBJECTS:
        geoms = []
        for gtype, size, pos in parts:
            geoms.append(Geom(
                body=0, gtype=gtype, size=np.asarray(size, np.float64),
                pos=np.asarray(pos, np.float64),
                quat=np.asarray([1.0, 0.0, 0.0, 0.0]),
                friction=np.asarray([1.0, 0.1, 0.1]), condim=3,
                margin=GEOM_MARGIN))
        vol = np.asarray([_geom_volume(g.gtype, g.size) for g in geoms])
        m = mass * vol / vol.sum()
        com = np.sum(m[:, None] * np.stack([g.pos for g in geoms]), 0) / mass
        inertia = np.zeros((3, 3))
        for g, mi in zip(geoms, m):
            d = g.pos - com
            inertia += _geom_inertia(g.gtype, g.size, mi) + mi * (
                np.eye(3) * (d @ d) - np.outer(d, d))
        geoms = [dataclasses.replace(g, mass=float(mi))
                 for g, mi in zip(geoms, m)]
        out.append(ObjectSpec(name=name, geoms=tuple(geoms), mass=mass,
                              com=com, inertia=inertia))
    return tuple(out)


def standing_pose(spec: HumanoidSpec) -> tuple[np.ndarray, np.ndarray]:
    """Neutral standing (qpos (76,), qvel (75,)) for ``synthetic_spec``: the
    root turned by the SMPL base rotation (90 deg about x, so +y points up),
    hinges at zero, and the lowest mesh vertex 0.5 mm into the floor."""
    q = np.zeros(spec.nq)
    q[3:7] = [np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0]
    world = np.zeros((spec.n_bodies, 3))
    for i in range(1, spec.n_bodies):
        world[i] = world[spec.parents[i]] + spec.body_pos[i]
    # rest-frame height (+y) is world z under the base rotation
    lowest = min(float((world[i, 1] + v[:, 1]).min())
                 for i, v in enumerate(spec.mesh_verts))
    q[2] = -lowest - 0.0005
    return q, np.zeros(spec.nv)
