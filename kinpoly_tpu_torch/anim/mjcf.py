"""Parse the reference's global-coordinate MJCF humanoid into a static spec
(port of ``kinpoly_tpu/anim/mjcf.py``), host-side numpy.

The reference scene files use MuJoCo's removed ``coordinate="global"`` mode:
body, joint and geom positions are given in the world frame of the rest
pose, every body quaternion is identity, and the STL mesh vertices are in
world coordinates. ``parse_humanoid`` reads that representation once and
derives the kinematic tree (parents, local offsets, per-dof hinge axes),
exact per-body mass, CoM and inertia from the mesh geoms (density 1000, as
``inertiafromgeom="true"``), local-frame mesh vertices for the contact
candidates, and the interactable object bodies (chair, box, table, Can,
step) with their primitive geoms. ``export_local_mjcf`` writes an
equivalent local-coordinate MJCF and translated STLs, which MuJoCo 2.3 and
later (without global coordinates) load. ``export_global_mjcf`` writes a
spec in the reference's global-coordinate form, which ``parse_humanoid``
reads back: it stands in for the absent reference files when the parser is
checked or timed.

The dataclasses live in ``anim/spec.py`` beside the synthetic humanoid and
are re-exported here. The reference assets are not in this repository, so
the port's scripts run on ``spec.synthetic_spec``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from kinpoly_tpu_torch.anim import stl
from kinpoly_tpu_torch.anim.spec import (SMPL_BONE_NAMES, Geom, HumanoidSpec,
                                         ObjectSpec)
from kinpoly_tpu_torch.core import tmath

__all__ = ["SMPL_BONE_NAMES", "Geom", "HumanoidSpec", "ObjectSpec",
           "parse_humanoid", "export_local_mjcf", "export_global_mjcf"]


def _require(ok: bool, msg: str) -> None:
    """Refuse an MJCF outside what the parser reads (ValueError)."""
    if not ok:
        raise ValueError(msg)


def _parse_vec(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()], dtype=np.float64)


def parse_humanoid(xml_path: str) -> HumanoidSpec:
    """Parse a global-coordinate MJCF humanoid (and its STL meshes) into a
    spec: hinge ranges in radians whatever ``compiler angle`` says, a mesh
    named after its file's basename when it has no name, the free root's
    armature 0."""
    tree = ET.parse(xml_path)
    root = tree.getroot()
    compiler = root.find("compiler")
    _require(compiler.get("coordinate") == "global",
             f"{xml_path}: expected a global-coordinate MJCF")
    use_degrees = compiler.get("angle", "degree") == "degree"
    base_dir = os.path.dirname(os.path.abspath(xml_path))

    timestep = float(root.find("option").get("timestep", "0.002"))

    # defaults (the reference uses a single default class)
    default = root.find("default")
    d_joint = default.find("joint") if default is not None else None
    d_geom = default.find("geom") if default is not None else None
    default_armature = float(d_joint.get("armature", "0")) if d_joint is not None else 0.0
    default_margin = float(d_geom.get("margin", "0")) if d_geom is not None else 0.0
    default_condim = int(d_geom.get("condim", "1")) if d_geom is not None else 1

    mesh_files = {m.get("name", os.path.splitext(os.path.basename(m.get("file")))[0]): os.path.join(base_dir, m.get("file"))
                  for m in root.find("asset").findall("mesh")}

    worldbody = root.find("worldbody")

    floor = None
    for g in worldbody.findall("geom"):
        if g.get("type") == "plane":
            floor = g
    floor_friction = _parse_vec(floor.get("friction", "1 0.005 0.0001")) if floor is not None else np.array([1.0, 0.005, 0.0001])

    body_names: list[str] = []
    parents: list[int] = []
    world_pos: list[np.ndarray] = []
    joint_axes: list[np.ndarray] = []
    jnt_range: list[np.ndarray] = []
    mesh_names: list[str] = []
    objects: list[ObjectSpec] = []

    def walk(elem, parent_idx):
        name = elem.get("name")
        joints = elem.findall("joint")
        if len(joints) == 1 and joints[0].get("type") == "free" and name != "Pelvis":
            objects.append(_parse_object(elem, default_margin))
            return
        idx = len(body_names)
        body_names.append(name)
        parents.append(parent_idx)
        pos = _parse_vec(elem.get("pos"))
        quat = _parse_vec(elem.get("quat", "1 0 0 0"))
        _require(np.allclose(quat, [1, 0, 0, 0]), f"non-identity body quat on {name}")
        world_pos.append(pos)
        if parent_idx == -1:
            _require(joints[0].get("type") == "free", f"root {name} has no free joint")
        else:
            _require(len(joints) == 3, f"{name} must have 3 hinges")
            axes, ranges = [], []
            for j in joints:
                _require(j.get("type") == "hinge", f"{name} has a non-hinge joint")
                jpos = _parse_vec(j.get("pos"))
                _require(np.allclose(jpos, pos), f"joint of {name} not at body origin")
                axes.append(_parse_vec(j.get("axis")))
                r = _parse_vec(j.get("range"))
                ranges.append(np.deg2rad(r) if use_degrees else r)
            joint_axes.append(np.stack(axes))
            jnt_range.extend(ranges)
        geom = elem.find("geom")
        _require(geom is not None and geom.get("type") == "mesh",
                 f"{name} has no mesh geom")
        mesh_names.append(geom.get("mesh"))
        for child in elem.findall("body"):
            walk(child, idx)

    for b in worldbody.findall("body"):
        walk(b, -1)

    parents_arr = np.asarray(parents, dtype=np.int32)
    world_pos_arr = np.stack(world_pos)
    body_pos = world_pos_arr.copy()
    has_parent = parents_arr >= 0
    body_pos[has_parent] -= world_pos_arr[parents_arr[has_parent]]

    # mesh geometry + exact mass properties (world verts -> body-local)
    mesh_verts, mesh_faces, ipos, mass, inertia = [], [], [], [], []
    for i, mname in enumerate(mesh_names):
        verts, faces = stl.read_stl(mesh_files[mname])
        local = verts - world_pos_arr[i]
        mp = stl.mesh_mass_properties(local, faces, density=1000.0)
        mesh_verts.append(local)
        mesh_faces.append(faces)
        ipos.append(mp.com)
        mass.append(mp.mass)
        inertia.append(mp.inertia)

    armature = np.full(6 + 3 * (len(body_names) - 1), default_armature)
    armature[:6] = 0.0  # free joint has armature=0 in the reference model

    return HumanoidSpec(
        body_names=tuple(body_names),
        parents=parents_arr,
        body_pos=body_pos,
        body_ipos=np.stack(ipos),
        body_mass=np.asarray(mass),
        body_inertia=np.stack(inertia),
        joint_axes=np.stack(joint_axes),
        jnt_range=np.stack(jnt_range),
        armature=armature,
        timestep=timestep,
        mesh_verts=tuple(mesh_verts),
        mesh_faces=tuple(mesh_faces),
        objects=tuple(objects),
        floor_friction=floor_friction,
        geom_margin=default_margin,
    )


def _quat_from_euler_xyz(e: np.ndarray) -> np.ndarray:
    """Extrinsic x-y-z euler -> wxyz quaternion (host-side numpy)."""
    def aa(angle, axis):
        q = np.zeros(4)
        q[0] = np.cos(angle / 2)
        q[1 + axis] = np.sin(angle / 2)
        return q

    def mul(a, b):
        w1, x1, y1, z1 = a
        w2, x2, y2, z2 = b
        return np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ])

    return mul(aa(e[2], 2), mul(aa(e[1], 1), aa(e[0], 0)))


def _parse_object(elem, default_margin: float) -> ObjectSpec:
    geoms = []
    total_mass, wsum = 0.0, np.zeros(3)
    for g in elem.findall("geom"):
        gtype = g.get("type", "sphere")
        pos = _parse_vec(g.get("pos", "0 0 0"))
        if g.get("euler") is not None:
            e = np.deg2rad(_parse_vec(g.get("euler")))
            quat = _quat_from_euler_xyz(e)  # MuJoCo default eulerseq="xyz" (extrinsic)
        else:
            quat = _parse_vec(g.get("quat", "1 0 0 0"))
        m = float(g.get("mass", "0"))
        geoms.append(Geom(
            body=0,
            gtype=gtype,
            size=_parse_vec(g.get("size")),
            pos=pos,
            quat=quat,
            friction=_parse_vec(g.get("friction", "1 0.005 0.0001")),
            condim=int(g.get("condim", "1")),
            margin=float(g.get("margin", str(default_margin))),
            mass=m,
        ))
        total_mass += m
        wsum += m * pos
    com = wsum / max(total_mass, 1e-9)
    # crude box/cylinder inertia sum about com (objects are mostly static props)
    I = np.zeros((3, 3))
    for g in geoms:
        m = g.mass or 0.0
        if g.gtype == "box":
            s = g.size
            diag = m / 3.0 * np.array([s[1] ** 2 + s[2] ** 2, s[0] ** 2 + s[2] ** 2, s[0] ** 2 + s[1] ** 2])
        elif g.gtype == "cylinder":
            r, h = g.size[0], g.size[1]
            diag = m * np.array([r * r / 4 + h * h / 3, r * r / 4 + h * h / 3, r * r / 2])
        else:
            r = g.size[0]
            diag = np.full(3, 0.4 * m * r * r)
        Ig = np.diag(diag)
        r_off = g.pos - com
        I += Ig + m * (np.eye(3) * (r_off @ r_off) - np.outer(r_off, r_off))
    return ObjectSpec(name=elem.get("name"), geoms=tuple(geoms), mass=total_mass, com=com, inertia=I)


# ---------------------------------------------------------------------------
# local-coordinate export, loadable by MuJoCo 3.x
# ---------------------------------------------------------------------------


def export_local_mjcf(spec: HumanoidSpec, out_dir: str, with_objects: bool = False,
                      explicit_inertia: bool = False) -> str:
    """Write a local-coordinate MJCF and translated STLs equivalent to the
    global-coordinate model, loadable by MuJoCo 3.x. Returns the XML path."""
    os.makedirs(os.path.join(out_dir, "geom"), exist_ok=True)
    for name, verts, faces in zip(spec.body_names, spec.mesh_verts, spec.mesh_faces):
        stl.write_stl(os.path.join(out_dir, "geom", f"{name}.stl"), verts, faces)

    lines = [
        '<mujoco model="humanoid_local">',
        f'  <compiler angle="radian" inertiafromgeom="{"false" if explicit_inertia else "true"}"/>',
        '  <size njmax="8000" nconmax="4000"/>',
        f'  <option timestep="{spec.timestep}"/>',
        '  <default>',
        '    <joint damping="0.0" armature="0.01" stiffness="0.0" limited="true"/>',
        '    <geom conaffinity="7" condim="1" contype="7" margin="0.001" rgba="0.8 0.6 .4 1"/>',
        '  </default>',
        '  <asset>',
    ]
    for name in spec.body_names:
        lines.append(f'    <mesh name="{name}" file="geom/{name}.stl"/>')
    lines += ['  </asset>', '  <worldbody>',
              '    <geom name="floor" type="plane" condim="3" friction="{} {} {}" pos="0 0 0" size="100 100 .2"/>'.format(*spec.floor_friction)]

    children: dict[int, list[int]] = {}
    for i, p in enumerate(spec.parents):
        children.setdefault(int(p), []).append(i)

    jr = spec.jnt_range

    def emit(i: int, indent: str):
        name = spec.body_names[i]
        pos = spec.body_pos[i]
        lines.append(f'{indent}<body name="{name}" pos="{pos[0]} {pos[1]} {pos[2]}">')
        if explicit_inertia:
            m = spec.body_mass[i]
            c = spec.body_ipos[i]
            I = spec.body_inertia[i]
            full = f"{I[0,0]} {I[1,1]} {I[2,2]} {I[0,1]} {I[0,2]} {I[1,2]}"
            lines.append(f'{indent}  <inertial pos="{c[0]} {c[1]} {c[2]}" mass="{m}" fullinertia="{full}"/>')
        if spec.parents[i] == -1:
            lines.append(f'{indent}  <joint name="{name}" type="free" limited="false" armature="0" damping="0" stiffness="0"/>')
        else:
            dof0 = 3 * (i - 1)
            for k, suffix in enumerate("zyx"):
                ax = spec.joint_axes[i - 1, k]
                r = jr[dof0 + k]
                lines.append(
                    f'{indent}  <joint name="{name}_{suffix}" type="hinge" pos="0 0 0" '
                    f'axis="{ax[0]} {ax[1]} {ax[2]}" range="{r[0]} {r[1]}"/>'
                )
        lines.append(f'{indent}  <geom type="mesh" mesh="{name}" contype="0" conaffinity="1"/>')
        for c_idx in children.get(i, []):
            emit(c_idx, indent + "  ")
        lines.append(f'{indent}</body>')

    emit(0, "    ")

    if with_objects:
        for obj in spec.objects:
            lines.append(f'    <body name="{obj.name}" pos="0 0 0">')
            lines.append(f'      <joint name="{obj.name}" type="free" limited="false" armature="0" damping="0" stiffness="0"/>')
            for g in obj.geoms:
                size = " ".join(str(x) for x in g.size)
                q = g.quat
                lines.append(
                    f'      <geom contype="1" conaffinity="1" type="{g.gtype}" size="{size}" '
                    f'pos="{g.pos[0]} {g.pos[1]} {g.pos[2]}" quat="{q[0]} {q[1]} {q[2]} {q[3]}" '
                    f'condim="{g.condim}" mass="{g.mass}"/>'
                )
            lines.append('    </body>')

    lines += ['  </worldbody>', '  <actuator>']
    for i, name in enumerate(spec.body_names[1:], start=1):
        for suffix in "zyx":
            lines.append(f'    <motor name="{name}_{suffix}" joint="{name}_{suffix}" gear="1"/>')
    lines += ['  </actuator>', '</mujoco>']

    xml_path = os.path.join(out_dir, "humanoid_local.xml")
    with open(xml_path, "w") as f:
        f.write("\n".join(lines))
    return xml_path


def _num(x) -> str:
    """Space-separated floats that parse back to the same float64s."""
    return " ".join(repr(float(v)) for v in np.asarray(x).reshape(-1))


def export_global_mjcf(spec: HumanoidSpec, out_dir: str,
                       angle: str = "degree") -> str:
    """Write spec as a global-coordinate MJCF in the reference's form: body
    and joint positions in the world frame of the rest pose, identity body
    quaternions, one STL per body with world-frame vertices (its mesh named
    after the file), hinge ranges in ``angle`` units ("degree" or
    "radian"), the hinges' armature (``spec.armature[6]``) and the geom
    margin as the defaults, and each object geom's orientation as an
    extrinsic xyz ``euler`` in degrees. ``parse_humanoid`` reads back the
    tree, offsets, axes, ranges, objects and floor friction, and takes the
    masses and inertias from the meshes. Returns the XML path."""
    _require(angle in ("degree", "radian"), f"angle {angle!r}: degree or radian")
    os.makedirs(os.path.join(out_dir, "geom"), exist_ok=True)
    world = np.zeros((spec.n_bodies, 3))
    for i in range(1, spec.n_bodies):
        world[i] = world[spec.parents[i]] + spec.body_pos[i]
    lines = [
        '<mujoco model="humanoid_global">',
        f'  <compiler angle="{angle}" coordinate="global" inertiafromgeom="true"/>',
        f'  <option timestep="{_num(spec.timestep)}"/>',
        '  <default>',
        f'    <joint armature="{_num(spec.armature[6])}" damping="0" limited="true"/>',
        f'    <geom condim="1" margin="{_num(spec.geom_margin)}"/>',
        '  </default>',
        '  <asset>',
    ]
    for i, name in enumerate(spec.body_names):
        stl.write_stl(os.path.join(out_dir, "geom", f"{name}.stl"),
                      spec.mesh_verts[i] + world[i], spec.mesh_faces[i])
        lines.append(f'    <mesh file="geom/{name}.stl"/>')
    lines += ['  </asset>', '  <worldbody>',
              f'    <geom name="floor" type="plane" condim="3" '
              f'friction="{_num(spec.floor_friction)}" size="100 100 .2"/>']

    children: dict[int, list[int]] = {}
    for i, p in enumerate(spec.parents):
        children.setdefault(int(p), []).append(i)

    def emit(i: int, indent: str):
        name = spec.body_names[i]
        lines.append(f'{indent}<body name="{name}" pos="{_num(world[i])}">')
        if spec.parents[i] == -1:
            lines.append(f'{indent}  <joint name="{name}" type="free"/>')
        else:
            for k, suffix in enumerate("zyx"):
                r = spec.jnt_range[3 * (i - 1) + k]
                r = np.rad2deg(r) if angle == "degree" else r
                lines.append(
                    f'{indent}  <joint name="{name}_{suffix}" type="hinge" '
                    f'pos="{_num(world[i])}" axis="{_num(spec.joint_axes[i - 1, k])}" '
                    f'range="{_num(r)}"/>')
        lines.append(f'{indent}  <geom type="mesh" mesh="{name}"/>')
        for c in children.get(i, []):
            emit(c, indent + "  ")
        lines.append(f'{indent}</body>')

    emit(0, "    ")
    for obj in spec.objects:
        lines.append(f'    <body name="{obj.name}" pos="0 0 0">')
        lines.append(f'      <joint name="{obj.name}" type="free"/>')
        for g in obj.geoms:
            # extrinsic xyz is the static-frame 'sxyz' sequence
            euler = np.rad2deg(tmath.euler_from_quat(
                torch.as_tensor(np.asarray(g.quat), dtype=torch.float64), "sxyz").numpy())
            lines.append(
                f'      <geom type="{g.gtype}" size="{_num(g.size)}" pos="{_num(g.pos)}" '
                f'euler="{_num(euler)}" mass="{_num(g.mass or 0.0)}" '
                f'friction="{_num(g.friction)}" condim="{g.condim}" '
                f'margin="{_num(g.margin)}"/>')
        lines.append('    </body>')
    lines += ['  </worldbody>', '</mujoco>']
    xml_path = os.path.join(out_dir, "humanoid_global.xml")
    with open(xml_path, "w") as f:
        f.write("\n".join(lines))
    return xml_path
