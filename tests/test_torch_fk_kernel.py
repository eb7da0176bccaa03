"""The host side of the kinematics kernel K5 (``csrc/fk.cu``) on the CPU:
its tree table, the trees it refuses, the rule that sends a pose to the
kernel or to the plain code, and ``fk_frames``'s plain path. The kernel
itself is compared with the plain code on the card, in
``tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from kinpoly_tpu_torch import native
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.physics import dynamics as dyn
from kinpoly_tpu_torch.physics import fk as fklib
from torch_trees import random_body_tree, seeded_poses


def _synthetic():
    return sp.spec_tensors(sp.synthetic_spec(0), torch.float64, "cpu")


def _random(seed, n_body, max_depth):
    return random_body_tree(np.random.RandomState(seed), n_body, max_depth)


TREES = {
    "synthetic": _synthetic,
    "chain32": lambda: _random(1, 32, 32),
    "random32": lambda: _random(2, 32, 6),
    "random17": lambda: _random(3, 17, 4),
    "one_body": lambda: _random(4, 1, 1),
}


@pytest.fixture
def no_library(monkeypatch):
    """native.library() raises: a path that reaches the kernel fails."""
    def refuse():
        raise AssertionError("native.library() called")
    monkeypatch.setattr(native, "library", refuse)


def _walk(st, qpos):
    """The kernel's walk in plain torch: every body's local quaternion at
    once, then the levels of ``tree_table`` in order, each composing the
    bodies at that depth onto their parents, as the warp does."""
    table, n_level = fklib.tree_table(st.parents)
    parent, depth = table
    B = len(parent)
    lead = qpos.shape[:-1]
    a = qpos[..., 7:].reshape(lead + (B - 1, 3))
    local = tmath.quat_from_euler(a[..., 0], a[..., 1], a[..., 2], "rzyx")
    xq = torch.zeros(lead + (B, 4), dtype=qpos.dtype)
    xp = torch.zeros(lead + (B, 3), dtype=qpos.dtype)
    xq[..., 0, :] = tmath.quat_norm(qpos[..., 3:7])
    xp[..., 0, :] = qpos[..., 0:3]
    for d in range(1, n_level + 1):
        sel = np.flatnonzero(depth == d)
        p = parent[sel]
        xq[..., sel, :] = tmath.quat_mul(xq[..., p, :], local[..., sel - 1, :])
        xp[..., sel, :] = xp[..., p, :] + tmath.quat_rot_vec(
            xq[..., p, :], st.body_pos[sel])
    return xp, xq, xp + tmath.quat_rot_vec(xq, st.body_ipos)


def test_tree_table_of_the_synthetic_humanoid():
    spec = sp.synthetic_spec(0)
    table, n_level = fklib.tree_table(tuple(int(p) for p in spec.parents))
    assert table.dtype == np.int32 and table.shape == (2, 24)
    assert list(table[0]) == [int(p) for p in spec.parents]
    # below the pelvis: torso, spine, chest, thorax, shoulder, elbow, wrist,
    # hand
    assert n_level == 8
    name = {n: i for i, n in enumerate(spec.body_names)}
    assert table[1, name["Pelvis"]] == 0
    assert table[1, name["Head"]] == 5
    assert table[1, name["L_Hand"]] == table[1, name["R_Hand"]] == 8
    assert table[1, name["L_Toe"]] == 4


@pytest.mark.parametrize("tree", sorted(TREES))
def test_tree_table_levels(tree):
    """Every body sits one level below its parent, and each level holds
    bodies: the walk of levels 1..n_level reaches every body once, after
    its parent."""
    st = TREES[tree]()
    table, n_level = fklib.tree_table(st.parents)
    parent, depth = table
    assert parent[0] == -1 and depth[0] == 0
    for b in range(1, len(parent)):
        assert depth[b] == depth[parent[b]] + 1
    assert sorted(set(depth.tolist())) == list(range(n_level + 1))


@pytest.mark.parametrize("tree", sorted(TREES))
def test_level_walk_is_the_plain_fk(tree):
    """The kernel's order of work, bit for bit the plain loop's results in
    float64, on seeded poses with unnormalised roots and angles up to
    +-4 pi."""
    st = TREES[tree]()
    qpos = torch.tensor(seeded_poses(np.random.RandomState(5), 9,
                                     len(st.parents)))
    res = fklib.fk(st, qpos)
    xp, xq, xi = _walk(st, qpos)
    assert torch.equal(res.xpos, xp)
    assert torch.equal(res.xquat, xq)
    assert torch.equal(res.xipos, xi)


@pytest.mark.parametrize("parents,what", [
    (tuple([-1] + list(range(32))), "33 bodies"),
    ((-1, 0, 2, 1), "preorder"),
    ((-1, 0, 1, 3), "preorder"),
    ((0, 0, 1), "preorder"),
    ((), "0 bodies"),
])
def test_tree_table_refuses_what_the_kernel_cannot_take(parents, what):
    with pytest.raises(ValueError, match="bodies" if "bod" in what else what):
        fklib.tree_table(parents)


def test_launch_refuses_other_dtypes_and_shapes(no_library):
    """The kernel's host checks, reached directly: they raise before any
    launch (the library is never loaded)."""
    st32 = sp.spec_tensors(sp.synthetic_spec(0), torch.float32, "cpu")
    q = torch.zeros(4, 76)
    with pytest.raises(ValueError, match="float32"):
        fklib._launch(st32, q.double(), frames=False)
    with pytest.raises(ValueError, match=r"\(\.\.\., 76\)"):
        fklib._launch(st32, torch.zeros(4, 75), frames=True)
    with pytest.raises(ValueError, match="body_pos"):
        fklib._launch(_synthetic(), q, frames=False)


@pytest.mark.parametrize("grad", [False, True])
def test_a_cpu_pose_never_reaches_the_kernel(no_library, grad):
    """CPU poses, with and without a gradient, take the plain code: the
    same outputs as ``_fk_plain`` and ``dof_frames``, and autograd flows
    through them."""
    st = _synthetic()
    qpos = torch.tensor(seeded_poses(np.random.RandomState(6), 5, 24),
                        requires_grad=grad)
    before = dict(native.LAUNCHES)
    res = fklib.fk(st, qpos)
    res2, df = fklib.fk_frames(st, qpos)
    plain = fklib._fk_plain(st, qpos)
    for a, b, c in zip(res, res2, plain):
        assert torch.equal(a, c) and torch.equal(b, c)
    for a, b in zip(df, fklib.dof_frames(st, qpos, plain)):
        assert torch.equal(a, b)
    assert dict(native.LAUNCHES) == before
    if grad:
        (res.xipos.sum() + df.axis.sum()).backward()
        assert qpos.grad is not None and bool(torch.isfinite(qpos.grad).all())


@pytest.mark.parametrize("tree", sorted(TREES))
def test_fk_frames_on_the_cpu_is_fk_then_dof_frames(tree, no_library):
    st = TREES[tree]()
    qpos = torch.tensor(seeded_poses(np.random.RandomState(7), 6,
                                     len(st.parents))).reshape(2, 3, -1)
    res, df = fklib.fk_frames(st, qpos)
    ref = fklib.fk(st, qpos)
    ref_df = fklib.dof_frames(st, qpos, ref)
    for a, b in zip(res + df, ref + ref_df):
        assert a.shape == b.shape and torch.equal(a, b)


def test_fk_frames_counts_one_fk_call(no_library):
    from kinpoly_tpu_torch.utils import profiling
    st = _synthetic()
    qpos = torch.tensor(seeded_poses(np.random.RandomState(8), 2, 24))
    before = profiling.COUNTS["fk"]
    fklib.fk_frames(st, qpos)
    dyn.kin_state(st, qpos)
    assert profiling.COUNTS["fk"] - before == 2
