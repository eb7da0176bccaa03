"""Port parity of the SMPL conversion (kinpoly_tpu_torch.anim.smpl) and the
AMASS pipeline (kinpoly_tpu_torch.data.amass) against kinpoly_tpu, float64
on the CPU, on the synthetic humanoid and seeded AMASS npz files the tests
write (no AMASS data is in the repository):

- ``smpl_to_qpose`` and ``qpose_to_smpl``, batched, with and without a
  translation; ``flip_smpl`` exactly
- ``fix_height``: a grounded take, one rejected by ``begin_feet_thresh``
  and one by ``gnd_thresh``
- ``process_amass_dir`` on a tree of npz files at 120 Hz and 50 Hz (SMPL-H
  poses, ``mocap_framerate`` and ``mocap_frame_rate``), a file without
  poses, a too-short one and a levitating one, with ``flip_augment``: the
  same takes kept, their qpos within 1e-10 and the rest equal; the bank
  file read back by ``read_bank`` and by ``joblib.load``
"""

import os

import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from kinpoly_tpu.anim import smpl as jsmpl
from kinpoly_tpu.data import amass as jamass
from kinpoly_tpu_torch.anim import smpl as tsmpl
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.data import amass as tamass
from kinpoly_tpu_torch.data.banks import read_bank

from test_torch_objects import jax_spec

torch.set_num_threads(1)

TOL = 1e-10
F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def specs():
    spec = sp.synthetic_spec(0)
    return spec, jax_spec(spec)


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


def amass_sequence(rng, n_frames: int, n_pose: int = 156, z0: float = 0.92):
    """An upright seeded SMPL(-H) sequence: the root turned 90 deg about x
    (the SMPL frame's +y up), every joint on a slow random walk, the root
    drifting over the floor."""
    poses = np.zeros((n_frames, n_pose))
    poses[:, 0] = np.pi / 2
    walk = np.cumsum(rng.normal(0, 0.01, (n_frames, 72)), axis=0)
    poses[:, :72] += 0.2 * rng.uniform(-1, 1, 72) + walk
    trans = np.zeros((n_frames, 3))
    trans[:, :2] = np.cumsum(rng.normal(0, 0.005, (n_frames, 2)), axis=0)
    trans[:, 2] = z0 + 0.02 * np.sin(np.linspace(0, 3, n_frames))
    return poses, trans


def write_amass_tree(root: str, seed: int = 0) -> None:
    """The AMASS tree of this file's pipeline test."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "A", "sub"))
    os.makedirs(os.path.join(root, "B"))
    p, t = amass_sequence(rng, 480)                    # 4 s at 120 Hz
    np.savez(os.path.join(root, "A", "walk_poses.npz"), poses=p, trans=t,
             mocap_framerate=120.0, betas=rng.randn(16), gender="neutral")
    p, t = amass_sequence(rng, 150)                    # 3 s at 50 Hz
    np.savez(os.path.join(root, "A", "sub", "turn.npz"), poses=p, trans=t,
             mocap_frame_rate=np.array(50.0))
    np.savez(os.path.join(root, "B", "shape.npz"), betas=rng.randn(10))
    p, t = amass_sequence(rng, 8)                      # under min_len
    np.savez(os.path.join(root, "B", "short.npz"), poses=p, trans=t,
             mocap_framerate=30.0)
    p, t = amass_sequence(rng, 90, z0=60.0)            # feet far off the floor
    np.savez(os.path.join(root, "B", "high.npz"), poses=p, trans=t)


@pytest.mark.parametrize("batch", [(7,), (2, 3)])
@pytest.mark.parametrize("with_trans", [True, False])
def test_smpl_qpose_round_trip_matches_jax(specs, batch, with_trans):
    spec, jspec = specs
    rng = np.random.RandomState(1)
    aa = rng.normal(0, 0.8, batch + (72,))
    aa[..., 3:6] *= 4.0                 # an angle past pi among them
    trans = rng.normal(0, 1, batch + (3,)) if with_trans else None
    qj = jsmpl.smpl_to_qpose(jspec, jnp.asarray(aa),
                             None if trans is None else jnp.asarray(trans))
    qt = tsmpl.smpl_to_qpose(spec, torch.tensor(aa),
                             None if trans is None else torch.tensor(trans))
    _close(qj, qt)
    aj, tj = jsmpl.qpose_to_smpl(jspec, qj)
    at, tt = tsmpl.qpose_to_smpl(spec, qt)
    _close(aj, at)
    _close(tj, tt)
    np.testing.assert_array_equal(tsmpl.smpl_to_mujoco_index(spec),
                                  jsmpl.smpl_to_mujoco_index(jspec))
    if not with_trans:
        assert np.all(qt[..., 2].numpy() == tsmpl.DEFAULT_ROOT_Z)


def test_flip_smpl_matches_jax():
    p = np.random.RandomState(2).randn(11, 72)
    np.testing.assert_array_equal(tamass.flip_smpl(p), jamass.flip_smpl(p))
    np.testing.assert_array_equal(tamass.flip_smpl(tamass.flip_smpl(p)), p)
    assert tamass.LEFT_RIGHT_IDX == jamass.LEFT_RIGHT_IDX


@pytest.mark.parametrize("case", ["grounded", "begin_feet", "gnd"])
def test_fix_height_matches_jax(specs, case):
    spec, jspec = specs
    rng = np.random.RandomState(3)
    p, t = amass_sequence(rng, 40, n_pose=72,
                          z0=60.0 if case == "begin_feet" else 0.92)
    if case == "gnd":
        t[20:, 2] -= 0.6                # sinks after the first frame
    q = np.asarray(tsmpl.smpl_to_qpose(spec, torch.tensor(p), torch.tensor(t)))
    oj = jamass.fix_height(jspec, q)
    ot = tamass.fix_height(spec, q, **F64)
    if case == "grounded":
        _close(oj, ot)
        assert abs(float(ot[0, 2] - q[0, 2])) > 1e-3
    else:
        assert oj is None and ot is None


def test_process_amass_dir_matches_jax(specs, tmp_path):
    spec, jspec = specs
    root = str(tmp_path / "amass")
    write_amass_tree(root)
    bank = str(tmp_path / "takes.pkl")
    tj = jamass.process_amass_dir(jspec, root, flip_augment=True)
    tt = tamass.process_amass_dir(spec, root, out_path=bank, flip_augment=True,
                                  **F64)
    assert sorted(tt) == sorted(tj) == sorted(
        ["A_walk_poses", "A_walk_poses_flip", "A_sub_turn", "A_sub_turn_flip"])
    assert tt["A_walk_poses"]["qpos"].shape == (120, 76)    # 120 Hz: every 4th
    assert tt["A_sub_turn"]["qpos"].shape == (75, 76)       # 50 Hz: every 2nd
    for k in tj:
        assert sorted(tt[k]) == sorted(tj[k])
        _close(tj[k]["qpos"], tt[k]["qpos"])
        assert tt[k]["qpos"].dtype == np.float64
        np.testing.assert_array_equal(tt[k]["pose_aa"], tj[k]["pose_aa"])
        np.testing.assert_array_equal(tt[k]["trans"], tj[k]["trans"])
        assert tt[k]["seq_name"] == tj[k]["seq_name"] == k
    for back in (read_bank(bank), joblib.load(bank)):
        assert sorted(back) == sorted(tt)
        for k in tt:
            for f, v in tt[k].items():
                np.testing.assert_array_equal(back[k][f], v)


def test_load_amass_npz_matches_jax(tmp_path):
    root = str(tmp_path / "amass")
    write_amass_tree(root, seed=5)
    for rel in ("A/walk_poses.npz", "A/sub/turn.npz", "B/shape.npz"):
        ej = jamass.load_amass_npz(os.path.join(root, rel))
        et = tamass.load_amass_npz(os.path.join(root, rel))
        if ej is None:
            assert et is None
            continue
        assert sorted(et) == sorted(ej)
        for k in ej:
            np.testing.assert_array_equal(et[k], ej[k])
    assert tamass.load_amass_npz(os.path.join(root, "A/sub/turn.npz"))[
        "framerate"] == 50.0


def test_gen_standing_take_matches_jax(specs):
    spec, jspec = specs
    q0, _ = sp.standing_pose(spec)
    a, b = tamass.gen_standing_take(spec, q0, 30), jamass.gen_standing_take(jspec, q0, 30)
    assert sorted(a) == sorted(b) and a["seq_name"] == b["seq_name"]
    np.testing.assert_array_equal(a["qpos"], b["qpos"])
