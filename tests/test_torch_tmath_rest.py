"""Port parity of the last tmath functions against kinpoly_tpu.core.tmath,
float64 on the CPU: ``mat_to_quat`` on every branch and at the branch ties,
``quat_about_axis`` on non-unit axes, and the 6D rotation set; finite
gradients at the degenerate inputs of tests/test_grad_safety.py. Tolerance
1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.core import tmath as jtm
from kinpoly_tpu_torch.core import tmath as ttm

torch.set_num_threads(1)

TOL = 1e-12


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


def _unit_quats(rng, n):
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _branch_mats():
    """Rotations that take each of the four branches, and ties between
    them: the identity (w), pi about x, y and z (x, y, z branches), pi
    about (1, 1, 0) and (1, 1, 1) (diagonal ties), and a negative trace
    with m00 = m11 = m22."""
    mats = [np.eye(3)]
    for axis in ([1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 1, 1], [0, 1, 1]):
        a = np.asarray(axis, float) / np.linalg.norm(axis)
        mats.append(2 * np.outer(a, a) - np.eye(3))      # rotation by pi
    q = np.array([0.3, 1.0, 1.0, 1.0])
    q /= np.linalg.norm(q)
    mats.append(np.asarray(jtm.quat_to_mat(jnp.asarray(q))))
    return np.stack(mats)


def test_mat_to_quat_matches_jax():
    rng = np.random.RandomState(0)
    m = np.asarray(jtm.quat_to_mat(jnp.asarray(_unit_quats(rng, 200))))
    m = np.concatenate([m, _branch_mats()]).reshape(4, -1, 3, 3)
    _close(jtm.mat_to_quat(jnp.asarray(m)), ttm.mat_to_quat(torch.tensor(m)))
    # the sign flip is on w < 0 only: w = 0 keeps its sign
    q = ttm.mat_to_quat(torch.tensor(_branch_mats()))
    assert torch.all(q[:, 0] >= 0)


@pytest.mark.parametrize("which", ["w", "x", "y", "z"])
def test_mat_to_quat_gradient_matches_jax(which):
    q = {"w": [0.9, 0.1, 0.2, 0.3], "x": [0.1, 0.9, 0.2, 0.3],
         "y": [0.1, 0.2, 0.9, 0.3], "z": [0.1, 0.2, 0.3, 0.9]}[which]
    m = np.asarray(jtm.quat_to_mat(jnp.asarray(q) / np.linalg.norm(q)))
    w = np.random.RandomState(1).randn(4)
    gj = jax.grad(lambda x: jnp.sum(jtm.mat_to_quat(x) * w))(jnp.asarray(m))
    mt = torch.tensor(m, requires_grad=True)
    (ttm.mat_to_quat(mt) * torch.tensor(w)).sum().backward()
    _close(gj, mt.grad)


def test_quat_about_axis_matches_jax():
    rng = np.random.RandomState(2)
    ang = rng.uniform(-4, 4, (5, 6))
    axis = rng.randn(5, 6, 3) * 3.0
    _close(jtm.quat_about_axis(jnp.asarray(ang), jnp.asarray(axis)),
           ttm.quat_about_axis(torch.tensor(ang), torch.tensor(axis)))
    # one axis for a batch of angles, as the BVH reader calls it
    _close(jtm.quat_about_axis(jnp.asarray(ang[0]), jnp.asarray([0.0, 2.0, 0.0])),
           ttm.quat_about_axis(torch.tensor(ang[0]), torch.tensor([0.0, 2.0, 0.0])))


def test_rot6d_set_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(3, 7, 6)
    _close(jtm.rot6d_to_mat(jnp.asarray(x)), ttm.rot6d_to_mat(torch.tensor(x)))
    q = _unit_quats(rng, 40).reshape(5, 8, 4)
    _close(jtm.quat_to_rot6d(jnp.asarray(q)), ttm.quat_to_rot6d(torch.tensor(q)))
    _close(jtm.rot6d_to_quat(jnp.asarray(x)), ttm.rot6d_to_quat(torch.tensor(x)))
    m = np.asarray(jtm.quat_to_mat(jnp.asarray(q)))
    _close(jtm.mat_to_rot6d(jnp.asarray(m)), ttm.mat_to_rot6d(torch.tensor(m)))
    # the columns are (b1, b2, b3): the first column is a1's direction
    mt = ttm.rot6d_to_mat(torch.tensor(x))
    a1 = x[..., :3] / np.linalg.norm(x[..., :3], axis=-1, keepdims=True)
    np.testing.assert_allclose(mt[..., :, 0].numpy(), a1, atol=1e-14)


@pytest.mark.parametrize("x", [[0.0] * 6, [1.0, 0, 0, 2.0, 0, 0]],
                         ids=["zero", "parallel"])
def test_rot6d_gradient_finite_and_matches_jax_at_degenerate(x):
    w = np.random.RandomState(4).randn(3, 3)
    gj = jax.grad(lambda v: jnp.sum(jtm.rot6d_to_mat(v) * w))(jnp.asarray(x))
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    (ttm.rot6d_to_mat(xt) * torch.tensor(w)).sum().backward()
    assert torch.isfinite(xt.grad).all()
    _close(gj, xt.grad)
