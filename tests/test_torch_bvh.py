"""Port parity of the BVH reader and writer (kinpoly_tpu_torch.anim.bvh)
against kinpoly_tpu.anim.bvh, float64 on the CPU, on BVH files the test
writes: mixed rotation channel orders, a joint with position channels, a
joint without channels, end sites (one of zero length), seeded frames.
``parse_bvh`` gives the same tree and frames, ``bvh_to_pose`` the same
root positions (zeros for a root without position channels, None for a
root without channels) and joint quaternions within 1e-12, and
``skeleton_to_mjcf`` the same string, byte for byte."""

import numpy as np
import pytest
import torch

from kinpoly_tpu.anim import bvh as jbvh
from kinpoly_tpu_torch.anim import bvh as tbvh

torch.set_num_threads(1)

TOL = 1e-12


def _hierarchy(root_channels):
    return f"""HIERARCHY
ROOT Hips
{{
  OFFSET 0.0 0.0 0.0
  CHANNELS {len(root_channels)} {' '.join(root_channels)}
  JOINT Spine
  {{
    OFFSET 0.13 10.25 -0.7
    CHANNELS 3 Yrotation Xrotation Zrotation
    JOINT Neck
    {{
      OFFSET 0.0 12.5 1.0
      CHANNELS 0
      JOINT Head
      {{
        OFFSET 0.01 6.333 0.0
        CHANNELS 3 Xrotation Zrotation Yrotation
        End Site
        {{
          OFFSET 0.0 0.0 0.0
        }}
      }}
    }}
  }}
  JOINT LeftLeg
  {{
    OFFSET 5.0 -10.0 0.25
    CHANNELS 6 Xrotation Yposition Zrotation Xposition Yrotation Zposition
    End Site
    {{
      OFFSET 0.0 -40.0 3.3
    }}
  }}
  JOINT RightLeg
  {{
    OFFSET -5.0 -10.0 0.25
    CHANNELS 2 Zrotation Zrotation
    End Site
    {{
      OFFSET 0.1 -39.5 2.9
    }}
  }}
}}
"""


def _write(tmp_path, root_channels, n_frames=5, seed=0):
    n_ch = len(root_channels) + 3 + 0 + 3 + 6 + 2
    rng = np.random.RandomState(seed)
    frames = rng.uniform(-170, 170, (n_frames, n_ch))
    text = _hierarchy(root_channels) + (
        f"MOTION\nFrames: {n_frames}\nFrame Time: 0.0083333\n"
        + "\n".join(" ".join(repr(float(v)) for v in row) for row in frames) + "\n")
    path = tmp_path / "t.bvh"
    path.write_text(text)
    return str(path)


ROOTS = {
    "pos_first": ["Xposition", "Yposition", "Zposition",
                  "Zrotation", "Xrotation", "Yrotation"],
    "rot_first": ["Yrotation", "Xposition", "Zrotation", "Zposition",
                  "Xrotation", "Yposition"],
    "no_position": ["Zrotation", "Yrotation", "Xrotation"],
    "no_channels": [],
}


@pytest.mark.parametrize("root", sorted(ROOTS))
def test_parse_and_pose_match_jax(tmp_path, root):
    path = _write(tmp_path, ROOTS[root])
    a, b = jbvh.parse_bvh(path), tbvh.parse_bvh(path)
    assert len(a.joints) == len(b.joints) == 9
    for x, y in zip(a.joints, b.joints):
        assert (x.name, x.parent, x.channels, x.children, x.is_end) == \
            (y.name, y.parent, y.channels, y.children, y.is_end)
        np.testing.assert_array_equal(x.offset, y.offset)
    np.testing.assert_array_equal(a.frames, b.frames)
    assert a.frame_time == b.frame_time and a.fps == b.fps

    for scale, degrees in ((0.01, True), (1.0, False)):
        pj, qj = jbvh.bvh_to_pose(a, scale=scale, degrees=degrees)
        pt, qt = tbvh.bvh_to_pose(b, scale=scale, degrees=degrees,
                                  device="cpu", dtype=torch.float64)
        if root == "no_channels":     # the root is skipped: no position
            assert pj is None and pt is None
        else:                         # zeros without position channels
            np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL)
        n_joints = 4 if root == "no_channels" else 5
        assert qt.shape == np.asarray(qj).shape == (5, n_joints, 4)
        np.testing.assert_allclose(qt, np.asarray(qj), rtol=0, atol=TOL)


@pytest.mark.parametrize("root", sorted(ROOTS))
@pytest.mark.parametrize("scale", [0.01, 0.0254, 1.0])
def test_skeleton_to_mjcf_is_byte_equal(tmp_path, root, scale):
    path = _write(tmp_path, ROOTS[root])
    a = jbvh.skeleton_to_mjcf(jbvh.parse_bvh(path), scale=scale)
    b = tbvh.skeleton_to_mjcf(tbvh.parse_bvh(path), scale=scale)
    assert a.encode() == b.encode()
    # the zero-length end site makes a sphere, the others capsules
    assert 'type="sphere"' in b and 'type="capsule"' in b
