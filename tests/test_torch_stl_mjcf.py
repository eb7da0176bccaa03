"""Port parity of the STL and MJCF tools (kinpoly_tpu_torch.anim.stl and
.mjcf) against kinpoly_tpu.anim, on files the tests write:

- binary STL: vertices and faces equal to the JAX package's reader (its
  native helper's first-occurrence order), -0.0 and 0.0 two vertices, mass
  properties equal; ASCII STL in the JAX reader's sorted order;
  ``write_stl`` bytes identical
- ``parse_humanoid`` on the global-coordinate MJCF that the port's
  ``export_global_mjcf`` writes of ``synthetic_spec(with_objects=True)``
  with the chair's seat turned (world-frame bodies, joints and STL meshes;
  ranges in degrees or radians; meshes named by their files; object geoms
  posed by ``euler``): every field equal, objects included, and the
  written spec recovered
- ``export_local_mjcf``: XML text and STL bytes identical
"""

import dataclasses
import os
import struct

import numpy as np
import pytest

from kinpoly_tpu.anim import mjcf as jmjcf
from kinpoly_tpu.anim import stl as jstl
from kinpoly_tpu.utils import native as jnative
from kinpoly_tpu_torch.anim import mjcf as tmjcf
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.anim import stl as tstl

from test_torch_objects import jax_spec


def _equal(a, b, path="spec"):
    """Field-by-field equality of specs, objects, geoms, arrays, tuples."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def _box_mesh(rng):
    v = sp._box_corners(np.array([-0.1, -0.2, -0.05]), np.array([0.2, 0.1, 0.3]))
    return v + rng.uniform(-0.01, 0.01, v.shape), sp._BOX_FACES.copy()


# ---------------------------------------------------------------------------
# STL
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def native_lib():
    """The JAX package reads binary STLs with its native helper wherever a
    C++ compiler is present; the port must give that helper's order."""
    lib = jnative.get_lib()
    assert lib is not None, "the JAX package's native STL helper did not build"
    return lib


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_stl_matches_jax(tmp_path, native_lib, seed):
    rng = np.random.RandomState(seed)
    v, f = _box_mesh(rng)
    # shuffle the face order so that first occurrence differs from sorted order
    f = f[rng.permutation(len(f))][:, rng.permutation(3)] if seed else f
    path = str(tmp_path / "m.stl")
    jstl.write_stl(path, v, f)
    vj, fj = jstl.read_stl(path)
    vt, ft = tstl.read_stl(path)
    assert vt.dtype == np.float64 and ft.dtype == np.int32
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    mj = jstl.mesh_mass_properties(vj, fj, density=1000.0)
    mt = tstl.mesh_mass_properties(vt, ft, density=1000.0)
    assert mt.mass == mj.mass
    np.testing.assert_array_equal(mt.com, mj.com)
    np.testing.assert_array_equal(mt.inertia, mj.inertia)


def test_binary_stl_order_is_first_occurrence(tmp_path, native_lib):
    """Not the sorted order: the first corner of the first triangle is
    vertex 0 even where it sorts last."""
    tri = np.array([[[9.0, 9, 9], [0, 0, 0], [1, 0, 0]],
                    [[0.0, 0, 0], [9, 9, 9], [0, 1, 0]]], np.float32)
    path = tmp_path / "o.stl"
    _write_raw_stl(path, tri)
    vt, ft = tstl.read_stl(str(path))
    vj, fj = jstl.read_stl(str(path))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(ft, [[0, 1, 2], [1, 0, 3]])


def _write_raw_stl(path, tri: np.ndarray):
    """Binary STL with zero normals from float32 corners (F, 3, 3)."""
    rec = np.zeros((len(tri), 50), np.uint8)
    rec[:, 12:48] = tri.astype("<f4").reshape(len(tri), 9).view(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80 + struct.pack("<I", len(tri)) + rec.tobytes())


def test_binary_stl_signed_zero_is_two_vertices(tmp_path, native_lib):
    tri = np.array([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]],
                    [[-0.0, 0, 0], [0, 1, 0], [0, 0, 1]]], np.float32)
    path = tmp_path / "z.stl"
    _write_raw_stl(path, tri)
    vt, ft = tstl.read_stl(str(path))
    vj, fj = jstl.read_stl(str(path))
    assert len(vt) == len(vj) == 5
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(np.signbit(vt), np.signbit(vj))


def test_ascii_stl_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    v, f = _box_mesh(rng)
    lines = ["solid box"]
    for tri in v[f]:
        lines += ["  facet normal 0 0 0", "    outer loop"]
        lines += [f"      vertex {_vec((x, y, z))}" for x, y, z in tri]
        lines += ["    endloop", "  endfacet"]
    lines.append("endsolid box")
    path = tmp_path / "a.stl"
    path.write_text("\n".join(lines))
    vj, fj = jstl.read_stl(str(path))
    vt, ft = tstl.read_stl(str(path))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(vt, v[np.lexsort(v.T[::-1])])


def test_write_stl_bytes_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    spec = sp.synthetic_spec(2)
    for i in (0, 7, 13):
        v = spec.mesh_verts[i] + rng.normal(0, 1e-3, spec.mesh_verts[i].shape)
        jstl.write_stl(str(tmp_path / "j.stl"), v, spec.mesh_faces[i])
        tstl.write_stl(str(tmp_path / "t.stl"), v, spec.mesh_faces[i])
        assert (tmp_path / "j.stl").read_bytes() == (tmp_path / "t.stl").read_bytes()


# ---------------------------------------------------------------------------
# MJCF
# ---------------------------------------------------------------------------


def _vec(x):
    return " ".join(repr(float(v)) for v in np.asarray(x).reshape(-1))


def turned_chair_spec():
    """synthetic_spec(with_objects=True) with the chair's seat geom turned
    (a seeded unit quaternion), so that its ``euler`` is not zero."""
    spec = sp.synthetic_spec(0, with_objects=True)
    q = np.random.RandomState(8).randn(4)
    chair = spec.objects[0]
    seat = dataclasses.replace(chair.geoms[0], quat=q / np.linalg.norm(q))
    objects = (dataclasses.replace(chair, geoms=(seat,) + chair.geoms[1:]),) + spec.objects[1:]
    return dataclasses.replace(spec, objects=objects)


@pytest.mark.parametrize("angle", ["degree", "radian"])
def test_parse_humanoid_matches_jax(tmp_path, native_lib, angle):
    """export_global_mjcf writes every mesh without a name (named after its
    file) and every object geom's orientation as an euler in degrees."""
    spec = turned_chair_spec()
    xml = tmjcf.export_global_mjcf(spec, str(tmp_path), angle)
    pj = jmjcf.parse_humanoid(xml)
    pt = tmjcf.parse_humanoid(xml)
    assert isinstance(pt, sp.HumanoidSpec)
    _equal(pj, pt)
    # what the parse recovers of the spec it was written from
    assert pt.body_names == spec.body_names
    np.testing.assert_array_equal(pt.parents, spec.parents)
    np.testing.assert_allclose(pt.body_pos, spec.body_pos, atol=1e-12)
    np.testing.assert_array_equal(pt.joint_axes, spec.joint_axes)
    np.testing.assert_allclose(pt.jnt_range, spec.jnt_range, atol=1e-12)
    np.testing.assert_array_equal(pt.armature, spec.armature)
    assert pt.timestep == spec.timestep and pt.geom_margin == spec.geom_margin
    np.testing.assert_array_equal(pt.floor_friction, spec.floor_friction)
    assert [o.name for o in pt.objects] == [o.name for o in spec.objects]
    for o_t, o_s in zip(pt.objects, spec.objects):
        assert o_t.mass == pytest.approx(o_s.mass, rel=1e-12)
        for g_t, g_s in zip(o_t.geoms, o_s.geoms):
            np.testing.assert_allclose(g_t.quat, g_s.quat, atol=1e-12)
            np.testing.assert_array_equal(g_t.size, g_s.size)
    # the mesh masses of boxes whose corners are float32: the box volumes
    vol = np.asarray([tstl.mesh_mass_properties(v, f).mass
                      for v, f in zip(spec.mesh_verts, spec.mesh_faces)])
    np.testing.assert_allclose(pt.body_mass, vol, rtol=1e-5)


def test_parse_humanoid_refuses_a_local_mjcf(tmp_path):
    """Both parsers refuse an MJCF without global coordinates (the JAX one
    by assert, the port with a ValueError)."""
    xml = tmjcf.export_local_mjcf(sp.synthetic_spec(0), str(tmp_path))
    with pytest.raises(AssertionError):
        jmjcf.parse_humanoid(xml)
    with pytest.raises(ValueError, match="global-coordinate"):
        tmjcf.parse_humanoid(xml)


def test_mjcf_reexports_the_spec_dataclasses():
    assert tmjcf.HumanoidSpec is sp.HumanoidSpec
    assert tmjcf.Geom is sp.Geom and tmjcf.ObjectSpec is sp.ObjectSpec
    assert tmjcf.SMPL_BONE_NAMES == jmjcf.SMPL_BONE_NAMES


@pytest.mark.parametrize("e", [(0.0, 0.0, 0.0), (0.3, -1.2, 2.5), (np.pi, 0.5, -0.1)])
def test_quat_from_euler_xyz_matches_jax(e):
    np.testing.assert_array_equal(tmjcf._quat_from_euler_xyz(np.asarray(e)),
                                  jmjcf._quat_from_euler_xyz(np.asarray(e)))


@pytest.mark.parametrize("with_objects", [False, True])
@pytest.mark.parametrize("explicit_inertia", [False, True])
def test_export_local_mjcf_matches_jax(tmp_path, with_objects, explicit_inertia):
    spec = sp.synthetic_spec(1, with_objects=True)
    pj = jmjcf.export_local_mjcf(jax_spec(spec), str(tmp_path / "j"),
                                 with_objects=with_objects,
                                 explicit_inertia=explicit_inertia)
    pt = tmjcf.export_local_mjcf(spec, str(tmp_path / "t"),
                                 with_objects=with_objects,
                                 explicit_inertia=explicit_inertia)
    assert os.path.basename(pt) == os.path.basename(pj)
    with open(pj) as fj, open(pt) as ft:
        assert ft.read() == fj.read()
    names = sorted(os.listdir(tmp_path / "j" / "geom"))
    assert names == sorted(os.listdir(tmp_path / "t" / "geom"))
    assert len(names) == spec.n_bodies
    for n in names:
        assert ((tmp_path / "t" / "geom" / n).read_bytes()
                == (tmp_path / "j" / "geom" / n).read_bytes())
