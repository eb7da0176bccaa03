"""Port parity of the pose metric suite (``evaluate_pair``) against
kinpoly_tpu.metrics.pose_metrics, float64 on the CPU, on two seeded
trajectories of the synthetic humanoid."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.anim import mjcf
from kinpoly_tpu.config import defaults as jdefaults
from kinpoly_tpu.metrics import pose_metrics as jpm
from kinpoly_tpu.physics import engine as jeng
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import uhc_control_params
from kinpoly_tpu_torch.metrics import pose_metrics as tpm
from kinpoly_tpu_torch.physics import engine as teng

# many tiny torch ops: one intra-op thread per process keeps several test
# workers from oversubscribing the CPU
torch.set_num_threads(1)

RTOL = 1e-8


def _trajectories(spec, seed, T=24):
    """A walking-in-place ground truth (pelvis drifting, joints wandering,
    the pelvis sinking so that feet and legs meet the floor) and a noisy
    prediction of it."""
    rng = np.random.RandomState(seed)
    q0 = sp.standing_pose(spec)[0]
    gt = np.repeat(q0[None], T, axis=0)
    gt[:, 0] += np.linspace(0, 0.3, T)
    gt[:, 2] -= np.linspace(0, 0.25, T)
    gt[:, 7:] += np.cumsum(rng.uniform(-0.02, 0.02, (T, 69)), axis=0)
    pred = gt.copy()
    pred[:, :3] += rng.normal(0, 0.02, (T, 3))
    pred[:, 3:7] += rng.normal(0, 0.02, (T, 4))
    pred[:, 3:7] /= np.linalg.norm(pred[:, 3:7], axis=-1, keepdims=True)
    pred[:, 7:] += rng.normal(0, 0.05, (T, 69))
    return pred, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_pair_matches_jax(seed):
    spec = sp.synthetic_spec(0)
    jspec = mjcf.HumanoidSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec),
                          solver="ltdl")
    tm = teng.build_model(spec, uhc_control_params(spec), device="cpu",
                          dtype=torch.float64)
    pred, gt = _trajectories(spec, seed)
    want = jpm.evaluate_pair(jspec, jnp.asarray(pred), jnp.asarray(gt),
                             cand=(jm.cand_verts, jm.cand_body))
    got = tpm.evaluate_pair(tm, torch.tensor(pred), torch.tensor(gt))
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL, err_msg=k)
        assert float(v) > 0, k           # every metric sees these inputs
