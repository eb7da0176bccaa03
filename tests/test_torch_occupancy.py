"""Port parity of the body occupancy maps (kinpoly_tpu_torch.anim.occupancy)
against kinpoly_tpu.anim.occupancy, float64 on the CPU, on the synthetic
humanoid and its five objects (boxes and cylinders): ``base_grid`` at both
default sizes, and ``body_occupancy`` for every object around seeded
standing poses, batched, equal voxel for voxel; an object with no geom gives
an all-False map of the right shape."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.anim import occupancy as jocc
from kinpoly_tpu.physics import contact as jct
from kinpoly_tpu_torch.anim import occupancy as tocc
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.physics import contact as tct

from test_torch_objects import jax_spec

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    spec = sp.synthetic_spec(0, with_objects=True)
    jspec = jax_spec(spec)
    return spec, jspec, tct.scene_from_spec(spec), jct.scene_from_spec(jspec)


def poses(spec, n, seed):
    """Standing poses turned and shifted, and each object placed around the
    pelvis with a random orientation."""
    rng = np.random.RandomState(seed)
    standing, _ = sp.standing_pose(spec)
    q = np.repeat(standing[None], n, 0)
    q[:, 7:] += rng.uniform(-0.3, 0.3, (n, 69))
    q[:, :2] += rng.uniform(-0.5, 0.5, (n, 2))
    n_obj = len(spec.objects)
    oq = rng.randn(n, n_obj, 4)
    oq /= np.linalg.norm(oq, axis=-1, keepdims=True)
    op = q[:, None, :3] + rng.uniform(-0.4, 0.4, (n, n_obj, 3))
    return q, np.concatenate([op, oq], axis=-1)


def test_base_grid_is_jax():
    for args in ((), (0.6, 16), (1.0, 5)):
        np.testing.assert_array_equal(tocc.base_grid(*args), jocc.base_grid(*args))
    assert tocc.base_grid().shape == (32 ** 3, 3)


@pytest.mark.parametrize("obj", range(5))
def test_body_occupancy_matches_jax(scenes, obj):
    spec, jspec, ts, js = scenes
    q, oq = poses(spec, 6, obj)
    body_idx = np.arange(0, 24, 3)
    want = np.asarray(jocc.body_occupancy(jspec, js, jnp.asarray(q), jnp.asarray(oq),
                                          body_idx, obj, voxel_num=16))
    got = tocc.body_occupancy(spec, ts, torch.tensor(q), torch.tensor(oq),
                              body_idx, obj, voxel_num=16)
    assert got.dtype == torch.bool and got.shape == (6, 8, 16, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()                       # the objects do overlap the grids


def test_object_without_geoms_is_empty(scenes):
    spec, jspec, ts, js = scenes
    q, oq = poses(spec, 2, 9)
    oq = np.concatenate([oq, oq[:, :1]], axis=1)     # a sixth, geom-less object
    want = np.asarray(jocc.body_occupancy(jspec, js, jnp.asarray(q), jnp.asarray(oq),
                                          np.asarray([0, 5]), 5, voxel_num=4))
    got = tocc.body_occupancy(spec, ts, torch.tensor(q), torch.tensor(oq),
                              np.asarray([0, 5]), 5, voxel_num=4)
    assert got.shape == want.shape == (2, 2, 4, 4, 4)
    assert not got.any() and not want.any()
