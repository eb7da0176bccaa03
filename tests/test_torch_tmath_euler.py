"""Port parity of the Euler conversions and the shortest-rotation axis-angle
against kinpoly_tpu.core.tmath, float64 on the CPU: ``euler_from_mat``,
``euler_from_quat`` and ``quat_from_euler`` for every sequence code, also
at gimbal lock (middle angle +-pi/2, and 0 or pi for the repeated-axis
sequences), batched; ``rotation_from_quat_shortest`` with w < 0, angles
over pi and near identity."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.core import tmath as jtm
from kinpoly_tpu_torch.core import tmath as ttm

TOL = 1e-10
AXES = sorted(jtm._AXES2TUPLE)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


def _unit_quats(rng, shape):
    q = rng.randn(*shape, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_axes_table_is_jax_table():
    assert ttm._AXES2TUPLE == jtm._AXES2TUPLE
    assert ttm._NEXT_AXIS == jtm._NEXT_AXIS


@pytest.mark.parametrize("axes", AXES)
def test_euler_round_trips_match_jax(axes):
    rng = np.random.RandomState(7)
    q = _unit_quats(rng, (3, 5))
    _close(jtm.euler_from_quat(jnp.asarray(q), axes),
           ttm.euler_from_quat(torch.tensor(q), axes))
    m = np.asarray(jtm.quat_to_mat(jnp.asarray(q)))
    _close(jtm.euler_from_mat(jnp.asarray(m), axes),
           ttm.euler_from_mat(torch.tensor(m), axes))
    e = rng.uniform(-np.pi, np.pi, (4, 6, 3))
    _close(jtm.quat_from_euler(*(jnp.asarray(e[..., i]) for i in range(3)), axes),
           ttm.quat_from_euler(*(torch.tensor(e[..., i]) for i in range(3)), axes))


@pytest.mark.parametrize("axes", AXES)
def test_euler_gimbal_lock_matches_jax(axes):
    """The middle angle at the degenerate value of each sequence kind
    (+-pi/2 without repetition, 0 and pi with it): both branches are
    evaluated and the degenerate one selected."""
    rng = np.random.RandomState(3)
    rep = jtm._AXES2TUPLE[axes][2]
    mids = (0.0, np.pi) if rep else (np.pi / 2, -np.pi / 2)
    e = rng.uniform(-np.pi, np.pi, (2 * len(mids), 3))
    e[:, 1] = np.repeat(mids, 2)
    q = np.asarray(jtm.quat_from_euler(*(jnp.asarray(e[:, i]) for i in range(3)), axes))
    m = np.asarray(jtm.quat_to_mat(jnp.asarray(q)))
    ej = np.asarray(jtm.euler_from_mat(jnp.asarray(m), axes))
    et = ttm.euler_from_mat(torch.tensor(m), axes)
    _close(ej, et)
    # the degenerate branch was taken: one of the outer angles is 0
    assert np.all(np.min(np.abs(ej[:, [0, 2]]), axis=-1) == 0.0)


def test_rotation_from_quat_shortest_matches_jax():
    rng = np.random.RandomState(9)
    q = _unit_quats(rng, (40,))
    q[:10] *= np.sign(q[:10, :1]) * -1.0          # w < 0: angle over pi, wrapped
    # near identity, on both sides of the 1e-8 cut, and -identity
    eps = np.array([0.0, 1e-10, 5e-9, 2e-8, 1e-6])
    near = np.zeros((len(eps), 4))
    near[:, 0] = 1.0 - eps
    near[:, 1] = np.sqrt(1.0 - near[:, 0] ** 2)
    q = np.concatenate([q, near, -near, [[1.0, 0, 0, 0], [-1.0, 0, 0, 0]]])
    aj = np.asarray(jtm.rotation_from_quat_shortest(jnp.asarray(q)))
    at = ttm.rotation_from_quat_shortest(torch.tensor(q))
    _close(aj, at)
    assert np.all(np.linalg.norm(aj, axis=-1) <= np.pi + 1e-12)
    assert np.all(at[-2:].numpy() == 0.0)
