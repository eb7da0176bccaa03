"""The host helpers of the JAX package's ``utils/native.py``, in numpy:
``parse_stl`` and ``mesh_mass_properties`` with that module's return
shapes (over ``anim/stl.py``), and ``gather_windows``, the expert-clip
window gather of the data loader.

Not to be confused with ``kinpoly_tpu_torch/native.py``, which builds and
loads the CUDA kernels. The JAX package backs these three with a C++
library and a numpy fallback; here numpy does the work.
"""

from __future__ import annotations

import struct

import numpy as np

from kinpoly_tpu_torch.anim import stl


def parse_stl(data: bytes):
    """Binary STL buffer -> (verts (V, 3) float64, faces (F, 3) int32),
    vertices numbered in the order they first occur; None for a buffer
    too short for its triangle count."""
    if len(data) < 84:
        return None
    (ntri,) = struct.unpack_from("<I", data, 80)
    if 84 + 50 * ntri > len(data):
        return None
    return stl.parse_binary_stl(data, ntri)


def mesh_mass_properties(verts: np.ndarray, faces: np.ndarray,
                         density: float = 1000.0):
    """-> (mass, com (3,), inertia (3, 3) about the CoM)."""
    mp = stl.mesh_mass_properties(np.asarray(verts, np.float64),
                                  np.asarray(faces), density)
    return mp.mass, mp.com, mp.inertia


def gather_windows(clip: np.ndarray, starts: np.ndarray, win_len: int) -> np.ndarray:
    """clip (T, D), starts (B,) -> float32 windows (B, win_len, D); frames
    past the end repeat the clip's last frame."""
    clip = np.ascontiguousarray(clip, np.float32)
    starts = np.ascontiguousarray(starts, np.int32)
    idx = np.minimum(starts[:, None] + np.arange(win_len)[None], clip.shape[0] - 1)
    return clip[idx]
