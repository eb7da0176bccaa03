"""Port parity of the SMPL body model (kinpoly_tpu_torch.anim.smpl_model)
against kinpoly_tpu.anim.smpl_model, float64 on the CPU: ``lbs`` (with and
without pose blendshapes, translation, batched), ``shaped_vertices``,
``joint_positions``, and ``load_smpl_model`` on a written .npz and .pkl of
the synthetic model (16 betas cut to 10, a sparse regressor in the pickle,
a ``kintree_table`` rooted at 4294967295). Tolerance 1e-10. The restricted
unpickler refuses any other class."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from kinpoly_tpu.anim import smpl_model as jsm
from kinpoly_tpu_torch.anim import smpl_model as tsm

torch.set_num_threads(1)

TOL = 1e-10
F64 = dict(dtype=torch.float64)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


def _inputs(seed, lead=(3,)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*lead, 10), rng.uniform(-0.6, 0.6, lead + (72,)),
            rng.randn(*lead, 3))


def test_names_and_parents_are_jax():
    assert tsm.SMPL_BONE_NAMES == jsm.SMPL_BONE_NAMES
    np.testing.assert_array_equal(tsm.SMPL_PARENTS, jsm.SMPL_PARENTS)
    a = jsm.synthetic_model(np.random.RandomState(5))
    b = tsm.synthetic_model(np.random.RandomState(5))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("blend", [True, False])
def test_lbs_matches_jax(blend):
    model = jsm.synthetic_model(np.random.RandomState(0), V=96)
    betas, pose, trans = _inputs(1, (2, 3))
    vj, jj = jsm.lbs(model, jnp.asarray(betas), jnp.asarray(pose),
                     jnp.asarray(trans), with_pose_blend=blend)
    st = tsm.smpl_tensors(model, torch.float64, "cpu")
    for m in (model, st):       # host arrays moved per call, or tensors
        vt, jt = tsm.lbs(m, torch.tensor(betas), torch.tensor(pose),
                         torch.tensor(trans), with_pose_blend=blend)
        _close(vj, vt)
        _close(jj, jt)
    vj, jj = jsm.lbs(model, jnp.asarray(betas[0, 0]), jnp.asarray(pose[0, 0]))
    vt, jt = tsm.lbs(model, torch.tensor(betas[0, 0]), torch.tensor(pose[0, 0]))
    _close(vj, vt)
    _close(jj, jt)


def test_shape_functions_match_jax():
    model = jsm.synthetic_model(np.random.RandomState(2))
    betas = np.random.RandomState(3).randn(4, 10)
    _close(jsm.shaped_vertices(model, jnp.asarray(betas)),
           tsm.shaped_vertices(model, torch.tensor(betas)))
    _close(jsm.joint_positions(model, jnp.asarray(betas)),
           tsm.joint_positions(model, torch.tensor(betas)))


def test_pose_blendshapes_apply_only_at_207():
    model = jsm.synthetic_model(np.random.RandomState(4))
    cut = model._replace(posedirs=model.posedirs[..., :200])
    betas, pose, _ = _inputs(5)
    v_cut, _ = tsm.lbs(cut, torch.tensor(betas), torch.tensor(pose))
    v_none, _ = tsm.lbs(model, torch.tensor(betas), torch.tensor(pose),
                        with_pose_blend=False)
    assert torch.equal(v_cut, v_none)
    vj, _ = jsm.lbs(cut, jnp.asarray(betas), jnp.asarray(pose))
    _close(vj, v_cut)


def _archive(seed):
    """The synthetic model as an SMPL archive: 16 betas, faces, and a
    kintree_table whose root entry is 4294967295 (uint32 -1)."""
    rng = np.random.RandomState(seed)
    m = jsm.synthetic_model(rng)
    V = m.v_template.shape[0]
    kin = np.stack([m.parents.astype(np.int64), np.arange(24)]).astype(np.uint32)
    assert kin[0, 0] == 4294967295
    return dict(v_template=m.v_template,
                shapedirs=np.concatenate([m.shapedirs, rng.randn(V, 3, 6)], -1),
                posedirs=m.posedirs, J_regressor=m.J_regressor, weights=m.weights,
                kintree_table=kin, f=rng.randint(0, V, (30, 3)).astype(np.uint32))


def _check_loaded(path):
    a, b = jsm.load_smpl_model(str(path)), tsm.load_smpl_model(str(path))
    for name in jsm.SMPLModel._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y)
    assert b.parents[0] == -1 and b.shapedirs.shape[-1] == 10
    betas, pose, trans = _inputs(6)
    vj, jj = jsm.lbs(a, jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(trans))
    vt, jt = tsm.lbs(b, torch.tensor(betas), torch.tensor(pose), torch.tensor(trans))
    _close(vj, vt)
    _close(jj, jt)


def test_load_npz_matches_jax(tmp_path):
    d = _archive(7)
    d["kintree_table"] = d["kintree_table"].astype(np.int64)
    d["kintree_table"][0, 0] = 4294967295
    np.savez(tmp_path / "smpl.npz", **d)
    _check_loaded(tmp_path / "smpl.npz")


@pytest.mark.parametrize("protocol", [0, 2])
def test_load_pkl_with_sparse_regressor_matches_jax(tmp_path, protocol):
    d = _archive(8)
    d["J_regressor"] = scipy.sparse.csc_matrix(d["J_regressor"])
    with open(tmp_path / "smpl.pkl", "wb") as f:
        pickle.dump(d, f, protocol=protocol)
    _check_loaded(tmp_path / "smpl.pkl")


class Evil:
    def __reduce__(self):
        return (print, ("ran",))


def test_pkl_with_another_class_is_refused(tmp_path):
    d = _archive(9)
    d["extra"] = Evil()
    with open(tmp_path / "evil.pkl", "wb") as f:
        pickle.dump(d, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        tsm.load_smpl_model(str(tmp_path / "evil.pkl"))
    with pytest.raises(FileNotFoundError):
        tsm.load_smpl_model(str(tmp_path / "absent.pkl"))
