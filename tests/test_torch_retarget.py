"""Port parity of the gradient rig conversion (kinpoly_tpu_torch.anim.
retarget) against kinpoly_tpu.anim.retarget, float64 on the CPU, on the
synthetic humanoid: targets from FK of seeded qpos (hinges and root xy
perturbed by up to 0.2 around the standing pose, as tests/test_retarget.py
makes them), 20 Adam iterations at T = 4 from the standing pose and from
the default start, qpos within 1e-8, the reported loss and the joint errors
likewise; one 300-iteration fit must come within the 3 cm mean joint error
of tests/test_retarget.py:30."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.anim import retarget as jrt
from kinpoly_tpu.physics import fk as jfk
from kinpoly_tpu_torch.anim import retarget as trt
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.physics import fk as tfk

from test_torch_objects import jax_spec

torch.set_num_threads(1)

TOL = 1e-8


@pytest.fixture(scope="module")
def setup():
    spec = sp.synthetic_spec(0)
    standing, _ = sp.standing_pose(spec)
    return spec, jax_spec(spec), standing


def targets(spec, standing, T, seed):
    rng = np.random.RandomState(seed)
    q = np.repeat(standing[None], T, 0)
    q[:, 7:] += rng.uniform(-0.2, 0.2, (T, 69))
    q[:, :2] += rng.uniform(-0.2, 0.2, (T, 2))
    st = sp.spec_tensors(spec, torch.float64, "cpu")
    return tfk.fk(st, torch.tensor(q)).xpos


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


@pytest.mark.parametrize("start", ["standing", "default"])
def test_fit_qpos_matches_jax(setup, start):
    spec, jspec, standing = setup
    tgt = targets(spec, standing, 4, 0)
    init = standing if start == "standing" else None
    kw = dict(iters=20, lr=0.03, w_smooth=0.5, w_limit=10.0)
    want = jrt.fit_qpos(jspec, jnp.asarray(tgt.numpy()),
                        None if init is None else jnp.asarray(init), **kw)
    got = trt.fit_qpos(spec, tgt, init, **kw)
    _close(want.qpos, got.qpos)
    _close(want.loss, got.loss)
    _close(want.jpos_err, got.jpos_err)


def test_fit_qpos_subset_and_single_frame_match_jax(setup):
    """T = 1 (no smoothness term) and a joint subset."""
    spec, jspec, standing = setup
    tgt = targets(spec, standing, 1, 1)
    sub = np.asarray([0, 3, 7, 12, 16, 20])
    kw = dict(iters=15, joint_subset=sub)
    want = jrt.fit_qpos(jspec, jnp.asarray(tgt.numpy()[:, sub]), jnp.asarray(standing), **kw)
    got = trt.fit_qpos(spec, tgt[:, sub], standing, **kw)
    _close(want.qpos, got.qpos)
    _close(want.jpos_err, got.jpos_err)


def test_fit_qpos_recovers_fk_targets(setup):
    spec, _, standing = setup
    tgt = targets(spec, standing, 4, 2)
    res = trt.fit_qpos(spec, tgt, standing, iters=300, lr=0.03, w_smooth=0.01)
    err = float(res.jpos_err.mean())
    assert err < 0.03, err                 # 3 cm mean joint error
    assert torch.isfinite(res.qpos).all()
    h = res.qpos[:, 7:].numpy()
    assert (h > spec.jnt_range[:, 0] - 0.1).all()
    assert (h < spec.jnt_range[:, 1] + 0.1).all()
