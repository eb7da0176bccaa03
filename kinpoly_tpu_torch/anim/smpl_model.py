"""SMPL body model (port of ``kinpoly_tpu/anim/smpl_model.py``): shape
blendshapes, pose blendshapes, joint regression and linear blend skinning,
batched over poses on tensors.

The licensed SMPL archives are not in the repository; ``load_smpl_model``
reads a standard .npz or .pkl archive when one is given, and
``synthetic_model`` makes a random model of SMPL's structure for tests. The
model's arrays stay numpy on the host (``SMPLModel``); ``smpl_tensors``
puts them on a device in one dtype, and ``lbs`` takes either.

A .pkl archive is read by a restricted unpickler that admits numpy's array
reconstructors and scipy.sparse's matrix classes (SMPL stores
``J_regressor`` sparse) and nothing else: no other code can run, and an
archive of chumpy objects is refused.

Conventions are SMPL's: 24 joints in ``SMPL_BONE_NAMES`` order, axis-angle
pose (..., 72), betas (..., 10), the translation applied to the root.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from kinpoly_tpu_torch.anim.smpl import SMPL_JOINT_NAMES
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.data.banks import NUMPY_GLOBALS, numpy_global

SMPL_BONE_NAMES = list(SMPL_JOINT_NAMES)

SMPL_PARENTS = np.asarray(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21], dtype=np.int32)

_SPARSE_CLASSES = frozenset({"csc_matrix", "csr_matrix", "coo_matrix",
                             "csc_array", "csr_array", "coo_array"})
_KEYS = ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
         "kintree_table", "f")
# what a protocol 0-2 pickle of those objects also names, under Python 3's
# and Python 2's module names
_PICKLE_HELPERS = frozenset({("copyreg", "_reconstructor"),
                             ("copy_reg", "_reconstructor"),
                             ("builtins", "object"), ("__builtin__", "object"),
                             ("_codecs", "encode")})


class SMPLModel(NamedTuple):
    v_template: np.ndarray    # (V, 3)
    shapedirs: np.ndarray     # (V, 3, n_betas)
    posedirs: np.ndarray      # (V, 3, 207) pose blendshapes (9 x 23)
    J_regressor: np.ndarray   # (24, V)
    weights: np.ndarray       # (V, 24) LBS weights
    parents: np.ndarray       # (24,)
    faces: np.ndarray = None  # (F, 3)


class SMPLTensors(NamedTuple):
    """An SMPLModel's arrays as tensors of one dtype on one device."""
    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    J_regressor: torch.Tensor
    weights: torch.Tensor
    parents: tuple            # python ints


def smpl_tensors(model: SMPLModel, dtype: torch.dtype, device) -> SMPLTensors:
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return SMPLTensors(t(model.v_template), t(model.shapedirs),
                       t(model.posedirs), t(model.J_regressor),
                       t(model.weights), tuple(int(p) for p in model.parents))


def _as_tensors(model, like: torch.Tensor) -> SMPLTensors:
    if isinstance(model, SMPLTensors):
        return model
    return smpl_tensors(model, like.dtype, like.device)


class _ModelUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in NUMPY_GLOBALS:
            return numpy_global(module, name)
        if module.split(".")[:2] == ["scipy", "sparse"] and name in _SPARSE_CLASSES:
            import scipy.sparse
            return getattr(scipy.sparse, name)
        if (module, name) in _PICKLE_HELPERS:
            return pickle.Unpickler.find_class(self, module, name)
        raise pickle.UnpicklingError(
            f"SMPL archive refers to {module}.{name}, which is not allowed "
            f"(an archive of chumpy objects must be converted to numpy first)")


def load_smpl_model(path: str) -> SMPLModel:
    """Read a standard SMPL model archive (.npz, or .pkl of numpy arrays and
    a sparse ``J_regressor``). ``shapedirs`` keeps its first 10 betas; a
    ``kintree_table``'s root entry 4294967295 becomes -1."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"SMPL model archive not found: {path}. Download the SMPL "
            f"neutral model (SMPL_NEUTRAL.pkl / .npz) from the SMPL "
            f"website (licensed; not redistributable with this repo).")
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            d = {k: z[k] for k in _KEYS if k in z.files}
    else:
        with open(path, "rb") as f:
            d = _ModelUnpickler(f, encoding="latin1").load()

    def arr(x):
        if hasattr(x, "toarray"):       # scipy.sparse J_regressor
            x = x.toarray()
        return np.asarray(x, np.float64)

    return SMPLModel(
        v_template=arr(d["v_template"]),
        shapedirs=arr(d["shapedirs"])[..., :10],
        posedirs=arr(d["posedirs"]),
        J_regressor=arr(d["J_regressor"]),
        weights=arr(d["weights"]),
        parents=(np.asarray(d["kintree_table"][0], np.int32)
                 if "kintree_table" in d else SMPL_PARENTS),
        faces=np.asarray(d["f"], np.int32) if "f" in d else None,
    )


def shaped_vertices(model, betas: torch.Tensor) -> torch.Tensor:
    """v_template + shape blendshapes (..., V, 3)."""
    m = _as_tensors(model, betas)
    return m.v_template + torch.einsum("vxb,...b->...vx", m.shapedirs, betas)


def joint_positions(model, betas: torch.Tensor) -> torch.Tensor:
    """Rest-pose joints from the regressor (..., 24, 3)."""
    m = _as_tensors(model, betas)
    return torch.einsum("jv,...vx->...jx", m.J_regressor,
                        shaped_vertices(m, betas))


def lbs(model, betas: torch.Tensor, pose_aa: torch.Tensor,
        trans: torch.Tensor | None = None, with_pose_blend: bool = True):
    """The SMPL forward: betas (..., 10), pose (..., 72) [, trans (..., 3)]
    -> (vertices (..., V, 3), joints (..., 24, 3)). Shape blendshapes,
    joint regression, pose blendshapes (the 23 non-root rotation matrices
    less the identity; applied when ``posedirs`` has SMPL's 207 columns),
    the kinematic chain, skinning. `model` is an SMPLModel (moved to the
    pose's device and dtype for this call) or an SMPLTensors."""
    m = _as_tensors(model, pose_aa)
    v_shaped = shaped_vertices(m, betas)
    J = joint_positions(m, betas)
    R = tmath.quat_to_mat(tmath.quat_from_expmap(
        pose_aa.reshape(pose_aa.shape[:-1] + (24, 3))))

    if with_pose_blend and m.posedirs.shape[-1] == 207:
        eye = torch.eye(3, dtype=R.dtype, device=R.device)
        pose_feat = (R[..., 1:, :, :] - eye).reshape(pose_aa.shape[:-1] + (207,))
        v_shaped = v_shaped + torch.einsum("vxp,...p->...vx", m.posedirs, pose_feat)

    # the chain, parents before children
    Rw = [R[..., 0, :, :]]
    tw = [J[..., 0, :]]
    for j in range(1, 24):
        p = m.parents[j]
        Rw.append(Rw[p] @ R[..., j, :, :])
        tw.append(tw[p] + (Rw[p] @ (J[..., j, :] - J[..., p, :])[..., None])[..., 0])
    Rw = torch.stack(Rw, dim=-3)                             # (..., 24, 3, 3)
    tw = torch.stack(tw, dim=-2)                             # (..., 24, 3)

    # skinning transforms relative to the rest pose
    t_rel = tw - (Rw @ J[..., None])[..., 0]
    Rv = torch.einsum("vj,...jxy->...vxy", m.weights, Rw)
    tv = torch.einsum("vj,...jx->...vx", m.weights, t_rel)
    verts = (Rv @ v_shaped[..., None])[..., 0] + tv
    joints = tw
    if trans is not None:
        verts = verts + trans[..., None, :]
        joints = joints + trans[..., None, :]
    return verts, joints


def synthetic_model(rng: np.random.RandomState, V: int = 64) -> SMPLModel:
    """A random model of SMPL's structure (10 betas, 207 pose blendshapes,
    a normalised regressor and skinning weights), the same draws as the JAX
    package's for the same `rng`."""
    vt = rng.randn(V, 3) * 0.3
    Jr = np.abs(rng.rand(24, V))
    Jr /= Jr.sum(axis=1, keepdims=True)
    W = np.abs(rng.rand(V, 24)) ** 4
    W /= W.sum(axis=1, keepdims=True)
    return SMPLModel(
        v_template=vt,
        shapedirs=rng.randn(V, 3, 10) * 0.01,
        posedirs=rng.randn(V, 3, 207) * 0.001,
        J_regressor=Jr,
        weights=W,
        parents=SMPL_PARENTS,
    )
