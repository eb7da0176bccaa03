"""Voxel occupancy of the space around bodies by an object's geoms (port of
``kinpoly_tpu/anim/occupancy.py``; reference ``kin_poly/utils/
torch_humanoid.py:get_body_occup_map``, the scene feature of the SpaceNet
VAE).

For each selected body a cubic grid (edge `map_length`, `voxel_num`^3
cells), centred on the body and turned to its heading, is tested against
the object's box and cylinder geoms.
"""

from __future__ import annotations

import numpy as np
import torch

from kinpoly_tpu_torch.anim.spec import spec_tensors
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.physics import fk as fklib


def base_grid(map_length: float = 0.6, voxel_num: int = 32) -> np.ndarray:
    """(V^3, 3) cell centres; numpy's "xy" meshgrid, so the first two grid
    axes are swapped against the coordinates."""
    x = np.linspace(-map_length / 2, map_length / 2, voxel_num)
    X, Y, Z = np.meshgrid(x, x, x, indexing="xy")
    return np.stack([X, Y, Z], axis=-1).reshape(-1, 3)


def body_occupancy(spec, scene, qpos: torch.Tensor, obj_qpos: torch.Tensor,
                   body_idx: np.ndarray, obj_index: int,
                   map_length: float = 0.6, voxel_num: int = 16) -> torch.Tensor:
    """qpos (..., 76) and object poses (..., n_obj, 7) -> boolean occupancy
    (..., n_bodies, V, V, V) by the geoms of object `obj_index` of `scene`
    (a ``physics.contact.SceneGeoms``); strict inside tests, a cylinder's
    size[0] its radius and size[1] its half-height. All False when the
    object has no geom."""
    dtype, dev = qpos.dtype, qpos.device
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    grid = t(base_grid(map_length, voxel_num))
    res = fklib.fk(spec_tensors(spec, dtype, dev), qpos)
    bi = torch.as_tensor(np.asarray(body_idx), device=dev)
    bpos = res.xpos[..., bi, :]                           # (..., B, 3)
    hq = tmath.heading_q(res.xquat[..., bi, :])
    # grid points in the world: heading-aligned, body-centred
    pts = bpos[..., None, :] + tmath.quat_rot_vec(hq[..., None, :], grid)

    op = obj_qpos[..., obj_index, :3]
    oq = obj_qpos[..., obj_index, 3:7]
    occ = None
    for gi in np.nonzero(np.asarray(scene.obj) == obj_index)[0]:
        size = t(scene.size[gi])
        wq = tmath.quat_mul(oq, t(scene.quat[gi]))
        wp = op + tmath.quat_rot_vec(oq, t(scene.pos[gi]))
        local = tmath.quat_rot_vec_inv(wq[..., None, None, :],
                                       pts - wp[..., None, None, :])
        if scene.gtype[gi] == 0:
            inside = torch.all(torch.abs(local) < size, dim=-1)
        else:
            inside = ((torch.linalg.norm(local[..., :2], dim=-1) < size[0])
                      & (torch.abs(local[..., 2]) < size[1]))
        occ = inside if occ is None else (occ | inside)

    cube = (voxel_num, voxel_num, voxel_num)
    if occ is None:
        return torch.zeros(qpos.shape[:-1] + (len(body_idx),) + cube,
                           dtype=torch.bool, device=dev)
    return occ.reshape(occ.shape[:-1] + cube)
