"""Port parity: the AR rollout of the kinematic policy in the AR env (mean
actions and auto-reset), kinpoly_tpu_torch against kinpoly_tpu, float64 on
the CPU, on the envs of ``test_torch_env_ar.build_envs`` with a tight
termination distance, so that envs fail within the few steps run and the
reset path is taken. ``test_torch_rollout_ar_failsafe.py`` runs the
evaluation's fail-safe teleports through ``check_rollout`` (each variant's
JAX compile takes ~45 s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.rl import rollout_ar as jroa
from kinpoly_tpu_torch.rl import rollout_ar as troa

from test_torch_env_ar import OBS_TOL, STATE_TOL, build_envs

torch.set_num_threads(1)

STEPS = 3
THRESH = 1.0        # summed body distance (m) past which an env fails


@pytest.fixture(scope="module")
def envs():
    return build_envs(body_diff_thresh=THRESH)


def _close(a, b, tol):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b)
    else:
        err = float(np.abs(a - b).max())
        assert err <= tol, err


def check_rollout(e, fail_safe: bool) -> None:
    """STEPS steps of both rollouts from the reset of one env per take:
    every trajectory field and the final carry."""
    jrun = jroa.make_ar_rollout(e.jenv, e.jp, STEPS, fail_safe=fail_safe)
    jcarry = jroa.init_ar_rollout_state(e.jenv, e.jp, jax.random.PRNGKey(7),
                                        jnp.arange(e.n, dtype=jnp.int32))
    jcarry, jtraj = jax.jit(lambda c: jrun(c, e.params, mean_action=True))(jcarry)
    trun = troa.make_ar_rollout(e.tenv, e.tp, STEPS, fail_safe=fail_safe)
    tcarry, ttraj = trun(troa.init_ar_rollout_state(e.tenv, e.tp,
                                                    torch.arange(e.n)))
    for f in ("obs", "actions", "rewards", "log_probs", "cc_action", "cc_state",
              "percents"):
        _close(getattr(jtraj, f), getattr(ttraj, f), OBS_TOL)
    for f in ("gt_qpos", "curr_qpos", "res_qpos", "obj_qpos"):
        _close(getattr(jtraj, f), getattr(ttraj, f), STATE_TOL)
    for f in ("masks", "fails", "ends", "clips"):
        _close(np.asarray(getattr(jtraj, f)).astype(np.float64),
               getattr(ttraj, f).to(torch.float64), 0)
    for f in ("qpos", "qvel", "obj_qpos", "obj_qvel"):
        _close(getattr(jcarry.env_state.sim, f),
               getattr(tcarry.env_state.sim, f), STATE_TOL)
    _close(jcarry.obs, tcarry.obs, OBS_TOL)
    _close(jcarry.gru, tcarry.gru, OBS_TOL)
    fails = ttraj.fails.numpy()
    assert fails.any()                     # the teleport/reset path ran
    if fail_safe:
        assert ttraj.masks.numpy().all()   # only a take's end terminates
    else:
        assert (ttraj.masks.numpy() == 0).any()


def test_ar_rollout_matches_jax(envs):
    check_rollout(envs, fail_safe=False)
