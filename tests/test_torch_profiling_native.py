"""The port's host utilities (kinpoly_tpu_torch.utils.flags, .native)
against their JAX package counterparts on the CPU: the flags singleton;
``gather_windows`` equal to the JAX package's numpy path (float32,
last-frame padding) and to its C++ path where a compiler built it;
``parse_stl`` and ``mesh_mass_properties`` with the JAX module's return
shapes. The port's tracing is tested in ``test_torch_spans.py``."""

import numpy as np
import pytest
import torch

from kinpoly_tpu.utils import flags as jflags
from kinpoly_tpu.utils import native as jnative
from kinpoly_tpu_torch.anim import stl
from kinpoly_tpu_torch.utils import flags as tflags
from kinpoly_tpu_torch.utils import native as tnative

torch.set_num_threads(1)


def test_flags_singleton_as_jax():
    assert vars(tflags.flags) == vars(jflags.flags) == {"debug": False}
    f = tflags.Flags({"a": 1, "b": "x"})
    assert (f.a, f.b) == (1, "x")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gather_windows_matches_jax(monkeypatch, dtype):
    rng = np.random.RandomState(0)
    clip = rng.randn(37, 5).astype(dtype)
    starts = np.asarray([0, 3, 30, 36, 12], np.int64)
    got = tnative.gather_windows(clip, starts, 9)
    assert got.dtype == np.float32 and got.shape == (5, 9, 5)
    np.testing.assert_array_equal(got[3], np.repeat(clip[36:37].astype(np.float32), 9, 0))
    if jnative.get_lib() is not None:                  # the C++ path
        np.testing.assert_array_equal(got, jnative.gather_windows(clip, starts, 9))
    monkeypatch.setattr(jnative, "get_lib", lambda: None)   # the numpy path
    np.testing.assert_array_equal(got, jnative.gather_windows(clip, starts, 9))


def _box_mesh():
    v = np.asarray([[x, y, z] for x in (0.0, 0.3) for y in (-0.1, 0.2)
                    for z in (0.05, 0.5)])
    f = np.asarray([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                    [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                    [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def test_stl_helpers_have_the_jax_shapes(tmp_path):
    v, f = _box_mesh()
    stl.write_stl(tmp_path / "box.stl", v, f)
    data = (tmp_path / "box.stl").read_bytes()
    verts, faces = tnative.parse_stl(data)
    assert verts.dtype == np.float64 and faces.dtype == np.int32
    if jnative.get_lib() is not None:
        jv, jf = jnative.parse_stl(data)
        np.testing.assert_array_equal(verts, jv)
        np.testing.assert_array_equal(faces, jf)
    assert tnative.parse_stl(data[:60]) is None
    assert tnative.parse_stl(data[:200]) is None       # fewer bytes than triangles
    mass, com, inertia = tnative.mesh_mass_properties(verts, faces, 1000.0)
    assert isinstance(mass, float) and com.shape == (3,) and inertia.shape == (3, 3)
    np.testing.assert_allclose(mass, 0.3 * 0.3 * 0.45 * 1000.0, rtol=1e-6)
    if jnative.get_lib() is not None:
        jm, jc, ji = jnative.mesh_mass_properties(verts, faces, 1000.0)
        np.testing.assert_allclose(mass, jm, rtol=1e-12)
        np.testing.assert_allclose(com, jc, rtol=0, atol=1e-12)
        np.testing.assert_allclose(inertia, ji, rtol=0, atol=1e-12)
