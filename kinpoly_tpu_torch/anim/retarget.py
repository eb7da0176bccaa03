"""Gradient-based rig conversion (port of ``kinpoly_tpu/anim/retarget.py``;
reference ``uhc/data_process/grad_rig_conversion.py``): fit a whole qpos
sequence to world joint targets through the differentiable FK, with torch
autograd and Adam.

fit_qpos solves   argmin_q  || FK(q).xpos - target_jpos ||^2
                + w_smooth  || q[1:] - q[:-1] ||^2
                + w_limit   (joint-range violation of the hinges)^2

with the root rotation an exponential-map increment about the initial
quaternion, which keeps it on the manifold without a projection.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kinpoly_tpu_torch.anim.spec import spec_tensors
from kinpoly_tpu_torch.core import tmath
from kinpoly_tpu_torch.physics import fk as fklib
from kinpoly_tpu_torch.rl.optim import AdamChain


class FitResult(NamedTuple):
    qpos: torch.Tensor      # (T, 76)
    loss: torch.Tensor      # the loss of the last step before the final update
    jpos_err: torch.Tensor  # (T,) mean joint error per frame (m), after it


def _safe_expmap_quat(e: torch.Tensor) -> torch.Tensor:
    """``tmath.quat_from_expmap`` with a finite gradient at e = 0, where the
    root increment starts: sqrt(e.e + 1e-16) in place of |e|."""
    safe = torch.sqrt(torch.sum(e * e, dim=-1, keepdim=True) + 1e-16)
    half = 0.5 * safe
    return torch.cat([torch.cos(half), e * (torch.sin(half) / safe)], dim=-1)


def _assemble(params, base_quat: torch.Tensor) -> torch.Tensor:
    trans, rot_exp, hinge = params
    quat = tmath.quat_norm(tmath.quat_mul(_safe_expmap_quat(rot_exp), base_quat))
    return torch.cat([trans, quat, hinge], dim=-1)


def fit_qpos(spec, target_jpos: torch.Tensor, init_qpos=None,
             iters: int = 300, lr: float = 0.02, w_smooth: float = 1.0,
             w_limit: float = 10.0, joint_subset: np.ndarray | None = None
             ) -> FitResult:
    """target_jpos (T, J, 3) world joint positions (the spec's body order,
    or the bodies `joint_subset` names) -> the fitted qpos sequence, on the
    targets' device and in their dtype. Without `init_qpos` every frame
    starts at z 0.92 with the root quaternion (0.5, 0.5, 0.5, 0.5)."""
    T = target_jpos.shape[0]
    dtype, dev = target_jpos.dtype, target_jpos.device
    target_jpos = target_jpos.detach()
    if init_qpos is None:
        q0 = torch.zeros((T, 76), dtype=dtype, device=dev)
        q0[:, 2] = 0.92
        q0[:, 3:7] = 0.5
    else:
        q0 = torch.as_tensor(init_qpos, dtype=dtype, device=dev).expand(T, 76)
    st = spec_tensors(spec, dtype, dev)
    base_quat = q0[:, 3:7].clone()
    params = [q0[:, :3].clone().requires_grad_(),
              torch.zeros((T, 3), dtype=dtype, device=dev, requires_grad=True),
              q0[:, 7:].clone().requires_grad_()]
    lo = torch.as_tensor(spec.jnt_range[:, 0], dtype=dtype, device=dev)
    hi = torch.as_tensor(spec.jnt_range[:, 1], dtype=dtype, device=dev)
    sel = (torch.arange(target_jpos.shape[1], device=dev) if joint_subset is None
           else torch.as_tensor(np.asarray(joint_subset), device=dev))

    def loss_fn():
        q = _assemble(params, base_quat)
        jp = fklib.fk(st, q).xpos[:, sel]
        fit = torch.mean(torch.sum((jp - target_jpos) ** 2, dim=-1))
        smooth = (torch.mean(torch.sum((q[1:] - q[:-1]) ** 2, dim=-1))
                  if T > 1 else 0.0)
        h = params[2]
        viol = torch.clamp(h - hi, min=0.0) + torch.clamp(lo - h, min=0.0)
        limit = torch.mean(torch.sum(viol ** 2, dim=-1))
        return fit + w_smooth * smooth + w_limit * limit

    opt = AdamChain(params, lr)
    loss = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(iters):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
    with torch.no_grad():
        q = _assemble(params, base_quat)
        err = torch.linalg.norm(fklib.fk(st, q).xpos[:, sel] - target_jpos,
                                dim=-1).mean(-1)
    return FitResult(qpos=q, loss=loss.detach(), jpos_err=err)
