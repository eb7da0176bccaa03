"""Port parity of ``AMASSDataset`` (kinpoly_tpu_torch.data.amass_dataset)
against kinpoly_tpu's, on the synthetic humanoid: the windows that
``sample_seq`` draws under one ``np.random.RandomState``, before and after
``record_result`` reweights the takes, ``sampling_probs``, the whole-take
accessors, and ``to_bank`` field by field (float64 on the CPU, 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.data.amass_dataset import AMASSDataset as JDataset
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.data.amass_dataset import AMASSDataset as TDataset

from test_torch_objects import jax_spec

torch.set_num_threads(1)

TOL = 1e-10


def seeded_takes(spec, lengths=(40, 10, 40), seed=0) -> dict:
    """Standing-pose takes with a seeded walk of the joint angles, and an
    extra per-frame array and a scalar field that windows must slice and
    skip."""
    rng = np.random.RandomState(seed)
    q0, _ = sp.standing_pose(spec)
    takes = {}
    for i, T in enumerate(lengths):
        q = np.repeat(q0[None], T, axis=0)
        q[:, 7:] += np.cumsum(rng.uniform(-0.01, 0.01, (T, 69)), axis=0)
        q[:, :2] += np.cumsum(rng.normal(0, 0.003, (T, 2)), axis=0)
        takes[f"take_{2 - i}"] = dict(qpos=q, obj_pose=rng.randn(T, 7),
                                      action="sit", betas=rng.randn(10))
    return takes


def _same_window(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("full_sample", [False, True])
def test_windows_and_sampling_match_jax(full_sample):
    takes = seeded_takes(sp.synthetic_spec(0))
    dj, dt = JDataset(takes, t_min=10, t_max=30), TDataset(takes, t_min=10, t_max=30)
    assert dt.keys == dj.keys
    rj, rt = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(12):
        _same_window(dj.sample_seq(rj, full_sample), dt.sample_seq(rt, full_sample))
    np.testing.assert_array_equal(dt.sampling_probs(), dj.sampling_probs())
    for d in (dj, dt):
        d.record_result("take_0", 0.1)
        d.record_result(1, 1.0, start=4)
        d.record_result("take_1", 0.7)
        d.record_result(2, 0.0)
    pj, pt = dj.sampling_probs(), dt.sampling_probs()
    np.testing.assert_array_equal(pt, pj)
    assert pt[0] > pt[1]
    for _ in range(12):
        _same_window(dj.sample_seq(rj, full_sample), dt.sample_seq(rt, full_sample))
    for i in range(len(dt.keys)):
        _same_window(dj.get_seq_by_ind(i), dt.get_seq_by_ind(i))
    for a, b in zip(dj.iter_seq(), dt.iter_seq()):
        _same_window(a, b)


@pytest.mark.parametrize("pad_to", [None, 90])
def test_to_bank_matches_jax(pad_to):
    spec = sp.synthetic_spec(0)
    takes = seeded_takes(spec)
    bj = JDataset(takes).to_bank(jax_spec(spec), dt=1 / 30, dtype=np.float64,
                                 pad_to=pad_to)
    bt = TDataset(takes).to_bank(spec, dt=1 / 30, dtype=torch.float64,
                                 pad_to=pad_to, device="cpu")
    assert bt._fields == bj._fields
    for f in bt._fields:
        a, b = np.asarray(getattr(bj, f)), getattr(bt, f).numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        err = float(np.abs(a - b).max())
        assert err < TOL, (f, err)
    assert bt.qpos.shape == (3, pad_to or 40, 76)
    np.testing.assert_array_equal(bt.length.numpy(), [40, 10, 40])
