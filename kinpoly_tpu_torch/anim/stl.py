"""STL meshes and their exact mass properties (port of
``kinpoly_tpu/anim/stl.py``), host-side numpy.

The reference humanoid takes its body masses and inertias from its STL mesh
geoms at MuJoCo's default density of 1000 kg/m^3 (``inertiafromgeom``);
``mesh_mass_properties`` computes them with the signed-tetrahedron
decomposition.

Vertex order: a binary file's vertices are numbered in the order they first
occur, two corners being one vertex when their float32 bit patterns are
equal (so -0.0 and 0.0 are two vertices). That is the order the JAX
package's native STL reader gives (``native/kinpoly_native.cpp``), which it
takes wherever a C++ compiler is present. An ASCII file's vertices are
sorted by value, as the JAX package's ASCII reader sorts them.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


def read_stl(path) -> tuple[np.ndarray, np.ndarray]:
    """Read an STL file -> (verts (V, 3) float64, faces (F, 3) int32)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:5] == b"solid" and b"facet" in data[:200]:
        return _read_ascii_stl(data)
    if len(data) < 84:
        raise ValueError(f"{path}: {len(data)} bytes is too short for a binary STL")
    (ntri,) = struct.unpack_from("<I", data, 80)
    if 84 + 50 * ntri > len(data):
        raise ValueError(f"{path}: {ntri} triangles need {84 + 50 * ntri} "
                         f"bytes, the file has {len(data)}")
    return parse_binary_stl(data, ntri)


def parse_binary_stl(data: bytes, ntri: int) -> tuple[np.ndarray, np.ndarray]:
    """The `ntri` triangles of a binary STL buffer -> (verts, faces) in the
    first-occurrence vertex order."""
    rec = np.frombuffer(data, dtype=np.uint8, count=ntri * 50, offset=84)
    corners = rec.reshape(ntri, 50)[:, 12:48].copy().view("<u4").reshape(-1, 3)
    _, first, inv = np.unique(corners, axis=0, return_index=True,
                              return_inverse=True)
    # renumber the unique rows (sorted by bits) by their first occurrence
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    verts = corners[first[order]].view("<f4").astype(np.float64)
    faces = rank[inv.reshape(-1)].reshape(-1, 3).astype(np.int32)
    return verts, faces


def _read_ascii_stl(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    verts = []
    for line in data.decode("ascii", "ignore").splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            verts.append([float(x) for x in line.split()[1:4]])
    tri = np.asarray(verts, dtype=np.float64).reshape(-1, 3, 3)
    flat = tri.reshape(-1, 3)
    uniq, inv = np.unique(flat.view([("x", "f8"), ("y", "f8"), ("z", "f8")]),
                          return_inverse=True)
    return uniq.view("f8").reshape(-1, 3), inv.reshape(-1, 3).astype(np.int32)


def write_stl(path, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write a binary STL: unit face normals, float32 corners, an empty
    80-byte header and zero attribute counts."""
    tri = verts[faces]  # (F, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True).clip(1e-12)
    f = faces.shape[0]
    buf = bytearray(84 + 50 * f)
    struct.pack_into("<I", buf, 80, f)
    rec = np.zeros((f, 50), dtype=np.uint8)
    payload = np.concatenate([n[:, None, :], tri], axis=1).astype("<f4").reshape(f, 48 // 4)
    rec[:, :48] = payload.view(np.uint8).reshape(f, 48)
    buf[84:] = rec.tobytes()
    with open(path, "wb") as fh:
        fh.write(buf)


@dataclass(frozen=True)
class MassProperties:
    mass: float
    com: np.ndarray       # (3,)
    inertia: np.ndarray   # (3, 3) about the CoM, same axes as the vertices


def mesh_mass_properties(verts: np.ndarray, faces: np.ndarray,
                         density: float = 1000.0) -> MassProperties:
    """Exact mass, CoM and inertia of a watertight triangle mesh from signed
    tetrahedra against the origin (MuJoCo's legacy ``inertiafromgeom`` for
    mesh geoms)."""
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    d = np.einsum("ij,ij->i", a, np.cross(b, c))  # 6 * signed tet volume

    vol = d.sum() / 6.0
    com = (d[:, None] * (a + b + c)).sum(axis=0) / 24.0 / vol

    # second moments about the origin: C_ij = rho * \int x_i x_j dV
    def sec(i, j):
        s = (
            2.0 * (a[:, i] * a[:, j] + b[:, i] * b[:, j] + c[:, i] * c[:, j])
            + a[:, i] * b[:, j] + a[:, j] * b[:, i]
            + a[:, i] * c[:, j] + a[:, j] * c[:, i]
            + b[:, i] * c[:, j] + b[:, j] * c[:, i]
        )
        return (d * s).sum() / 120.0

    C = np.array([[sec(i, j) for j in range(3)] for i in range(3)]) * density
    mass = vol * density
    I_origin = np.eye(3) * np.trace(C) - C
    # parallel-axis shift to the CoM
    r = com
    I_com = I_origin - mass * (np.eye(3) * (r @ r) - np.outer(r, r))
    return MassProperties(mass=float(mass), com=com, inertia=I_com)
