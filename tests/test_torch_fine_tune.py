"""Port parity of the controller fine-tuning rewards
(``fine_tune_kin_action_reward``, ``fine_tune_action_reward``,
``fine_tune_reward``) against kinpoly_tpu.rl.rewards, float64 on the CPU:
batched (8, .) seeded inputs under perfect and off tracking, the end bonus
off, on and per env, the default weights and others, and the scalar
defaults of ``end_reward`` and ``is_end``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.core import tmath as jtm
from kinpoly_tpu.rl import rewards as jrw
from kinpoly_tpu_torch.rl import rewards as trw

TOL = 1e-10
DT = 1.0 / 30.0
IDS = ("fine_tune_kin_action_reward", "fine_tune_action_reward",
       "fine_tune_reward")
WEIGHTS = {
    "defaults": {},
    "other": dict(k_rp=2.0, k_rq=0.5, k_v=0.3, k_a=1.5, k_p=3.0, w_rp=0.7,
                  w_rq=1.3, w_a=0.2, w_p=0.4, w_v=0.6, w_end=2.5),
}


def _quats(rng, n, k):
    x = rng.randn(n, k, 4)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).reshape(n, 4 * k)


def fine_tune_inputs(rng, n, perfect=True, end_reward=2.0, is_end=None):
    """(JAX FineTuneInputs, port FineTuneInputs) of n envs; the expert head
    velocity is the finite difference of the (prev -> cur) head pair, so
    perfect tracking puts every term at distance 0. is_end None keeps the
    inputs' defaults (end_reward 0.0, is_end False)."""
    prev_h = np.concatenate([rng.randn(n, 3), _quats(rng, n, 1)], -1)
    cur_h = np.concatenate([prev_h[:, :3] + 0.01 * rng.randn(n, 3),
                            _quats(rng, n, 1)], -1)
    hvel = np.concatenate([
        (cur_h[:, :3] - prev_h[:, :3]) / DT,
        np.asarray(jtm.angvel_fd(jnp.asarray(prev_h[:, 3:]),
                                 jnp.asarray(cur_h[:, 3:]), DT))], -1)
    bq = _quats(rng, n, 23)
    act = rng.randn(n, 75)
    if perfect:
        e_h, e_hvel, e_bq, old = cur_h, hvel, bq, act
    else:
        e_h = np.concatenate([cur_h[:, :3] + 0.3 * rng.randn(n, 3),
                              _quats(rng, n, 1)], -1)
        e_hvel = hvel + rng.randn(n, 6)
        e_bq, old = _quats(rng, n, 23), act + 0.5 * rng.randn(n, 75)
    raw = dict(head_pose=cur_h, prev_head_pose=prev_h, e_head_pose=e_h,
               e_head_vel=e_hvel, bquat=bq, e_bquat=e_bq, action=act,
               old_action=old)
    jin = jrw.FineTuneInputs(**{k: jnp.asarray(v) for k, v in raw.items()})
    tin = trw.FineTuneInputs(**{k: torch.tensor(v) for k, v in raw.items()})
    if is_end is not None:
        jin = jin._replace(end_reward=jnp.asarray(end_reward),
                           is_end=jnp.asarray(is_end))
        tin = tin._replace(end_reward=torch.tensor(end_reward),
                           is_end=torch.tensor(is_end))
    return jin, tin


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("end", ["default", "none", "all", "mixed"])
@pytest.mark.parametrize("perfect", [True, False])
@pytest.mark.parametrize("rid", IDS)
def test_fine_tune_reward_matches_jax(rid, perfect, end, weights):
    n = 8
    is_end = {"default": None, "none": np.zeros(n, bool),
              "all": np.ones(n, bool),
              "mixed": np.arange(n) % 3 == 0}[end]
    jin, tin = fine_tune_inputs(np.random.RandomState(11), n, perfect,
                                is_end=is_end)
    ws = WEIGHTS[weights]
    rj, cj = jrw.FINE_TUNE_REWARDS[rid](jin, ws, DT)
    rt, ct = trw.FINE_TUNE_REWARDS[rid](tin, ws, DT)
    _close(rj, rt)
    _close(cj, ct)
    assert rt.shape == (n,) and rt.dtype == torch.float64
    if perfect:
        np.testing.assert_allclose(ct.numpy(), 1.0, atol=1e-4)


@pytest.mark.parametrize("rid", IDS)
def test_end_bonus_semantics(rid):
    """With the scalar is_end True: fine_tune_kin_action_reward adds
    w_end (0 by default) x end_reward, fine_tune_action_reward adds w_end
    (1 by default) x end_reward, fine_tune_reward multiplies by
    end_reward."""
    jin, tin = fine_tune_inputs(np.random.RandomState(5), 4, False,
                                end_reward=3.0, is_end=False)
    base, _ = trw.FINE_TUNE_REWARDS[rid](tin, {}, DT)
    tend = tin._replace(is_end=True, end_reward=3.0)
    jend = jin._replace(is_end=True, end_reward=3.0)
    r, _ = trw.FINE_TUNE_REWARDS[rid](tend, {}, DT)
    rj, _ = jrw.FINE_TUNE_REWARDS[rid](jend, {}, DT)
    _close(rj, r)
    want = {"fine_tune_kin_action_reward": base,
            "fine_tune_action_reward": base + 3.0,
            "fine_tune_reward": base * 3.0}[rid]
    np.testing.assert_allclose(r.numpy(), want.numpy(), rtol=1e-12)


def test_registry_returns_fine_tune_rewards():
    for rid in IDS:
        assert trw.get_kin_poly_reward(rid) is trw.FINE_TUNE_REWARDS[rid]
        assert jrw.get_kin_poly_reward(rid).__name__ == \
            trw.get_kin_poly_reward(rid).__name__
