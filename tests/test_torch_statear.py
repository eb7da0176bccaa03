"""Port parity: the StateAR data of the kinematic policy (derive_features,
the dataset's whole takes and windows, load_annotations on the wild bank)
and the kin_poly configuration, kinpoly_tpu_torch against kinpoly_tpu on
the CPU. derive_features is held in float64; load_annotations derives in
float32, as the JAX loader does."""

import dataclasses
import os

import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from kinpoly_tpu.config.config import KinPolyConfig as JKinPolyConfig
from kinpoly_tpu.data import statear as jsa
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import KinPolyConfig
from kinpoly_tpu_torch.data import statear as tsa

from test_torch_objects import jax_spec

torch.set_num_threads(1)

TOL = 1e-12          # float64 features
F32_TOL = 1e-6       # float32 features (FK positions of order 1 m)
WILD = os.path.join(os.path.dirname(__file__), "..", "data_bank",
                    "wild_takes_r5.pkl")
FIELDS = ("qpos", "qvel", "wbpos", "wbquat", "bquat", "head_pose",
          "head_vels", "obj_pose", "obj_head_relative_poses",
          "action_one_hot", "target")


@pytest.fixture(scope="module")
def specs():
    spec = sp.synthetic_spec(0, with_objects=True)
    return spec, jax_spec(spec)


@pytest.fixture(scope="module")
def raw():
    return joblib.load(WILD)


@pytest.fixture(scope="module")
def loaded(specs):
    spec, jspec = specs
    return (jsa.load_annotations(WILD, spec=jspec),
            tsa.load_annotations(WILD, spec=spec))


@pytest.mark.parametrize("name", ["wild-sit-01", "wild-push-02",
                                  "wild-avoid-00", "wild-step-01"])
def test_derive_features(specs, raw, name):
    spec, jspec = specs
    t = raw[name]
    args = (t["qpos"].astype(np.float64), t["obj_pose"], t["action"])
    kw = dict(obj2_pose=t.get("table_pose"))
    a = jsa.derive_features(jspec, *args, **kw)
    b = tsa.derive_features(spec, *args, **kw)
    assert a["action"] == b["action"] == t["action"]
    for k in FIELDS:
        x, y = np.asarray(a[k]), b[k]
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert float(np.abs(x - y).max()) < TOL, k


def test_head_vel_and_root_vel():
    rng = np.random.RandomState(0)
    pose = rng.normal(size=(2, 9, 7))
    pose[..., 3:7] /= np.linalg.norm(pose[..., 3:7], axis=-1, keepdims=True)
    pose[:, 4] = pose[:, 3]                          # a zero rotation step
    for jf, tf in ((jsa.get_head_vel, tsa.get_head_vel),
                   (jsa.get_root_vel, tsa.get_root_vel),
                   (jsa.get_traj_de_heading, tsa.get_traj_de_heading)):
        x = np.asarray(jf(jnp.asarray(pose if jf is not jsa.get_traj_de_heading
                                      else np.pad(pose, ((0, 0), (0, 0), (0, 69))))))
        y = tf(torch.tensor(pose if tf is not tsa.get_traj_de_heading
                            else np.pad(pose, ((0, 0), (0, 0), (0, 69))))).numpy()
        assert float(np.abs(x - y).max()) < TOL
    obj = rng.normal(size=(2, 9, 7))
    x = jsa.get_obj_relative_pose(jnp.asarray(obj), jnp.asarray(pose))
    y = tsa.get_obj_relative_pose(torch.tensor(obj), torch.tensor(pose))
    assert float(np.abs(np.asarray(x) - y.numpy()).max()) < TOL


def test_load_annotations(raw, loaded):
    """The bank through the port's reader and derivation against
    joblib.load and the JAX loader: names, actions and raw fields exactly,
    features in float32 within F32_TOL; the head's linear velocity, a
    finite difference of the head position, within 2 F32_TOL / dt. Its
    angular velocity is held in float64 only (test_derive_features): the
    near-identity branch of the rotation vector (1 - |w| < 1e-8) flips on
    one-ulp differences of the float32 head rotations of still frames and
    moves that frame's angular velocity by up to ~2e-2 in either
    package."""
    jt, tt = loaded
    assert [t["name"] for t in tt] == [t["name"] for t in jt] == list(raw)
    for a, b in zip(jt, tt):
        r = raw[b["name"]]
        assert a["action"] == b["action"] == r["action"]
        np.testing.assert_array_equal(b["qpos"], r["qpos"])
        assert b["qpos"].dtype == np.float32
        for k in FIELDS:
            x, y = np.asarray(a[k]), b[k]
            assert x.shape == y.shape and x.dtype == y.dtype, k
            if k == "head_vels":
                assert float(np.abs(x[:, :3] - y[:, :3]).max()) < \
                    2 * F32_TOL / tsa.DT
                continue
            assert float(np.abs(x - y).max()) < F32_TOL, k


def test_whole_take_and_batches(loaded):
    """Both datasets over the same takes: whole takes padded to the longest
    and seeded windows (adaptive sampling on) identical."""
    _, tt = loaded
    jd = jsa.StateARDataset(tt, fr_num=60)
    td = tsa.StateARDataset(tt, fr_num=60)
    np.testing.assert_array_equal(jd.freq_indices, td.freq_indices)
    t_max = max(t["qpos"].shape[0] for t in tt)
    for i in (0, 5, 11):
        for a, b in zip(jd.whole_take(i, pad_to=t_max),
                        td.whole_take(i, pad_to=t_max)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    # windows: the same seeded draws pick the same takes and starts
    freq = {0: [1.0, 0.0], 3: [0.0]}
    ba = jd.get_batch(np.random.RandomState(5), 6, freq_dict=freq)
    bb = td.get_batch(np.random.RandomState(5), 6, freq_dict=freq)
    for a, b in zip(ba, bb):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_kin_poly_config():
    """KinPolyConfig() against kin_poly.yml as the JAX package reads it."""
    j, t = JKinPolyConfig("kin_poly"), KinPolyConfig()
    assert t.name == j.id
    for f in dataclasses.fields(t):
        if f.name != "name":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.traj_ar_config()) == dataclasses.asdict(
        j.traj_ar_config())
    assert dataclasses.asdict(t.reward_weights()) == dataclasses.asdict(
        j.reward_weights())
    assert t.model_dir() == j.model_dir
    assert KinPolyConfig().model_dir("results_r5") == os.path.join(
        "results_r5", "statear", "kin_poly", "models")
