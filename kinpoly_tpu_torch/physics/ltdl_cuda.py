"""Wrappers of the LTDL kernels K1 (factor) and K2 (solve) in
``csrc/ltdl.cu``.

Both take the engine's batch-leading layout directly: packed rows
(..., nv, Dmax+1) and right-hand sides (..., nv, R), float32, contiguous,
on a CUDA device. A CPU tensor goes to the plain version in ``ltdl``; a CUDA
tensor launches the kernel or raises. Solve launches are counted per
right-hand-side width, as ``ltdl_solve[R=r]``.
"""

from __future__ import annotations

import torch

from kinpoly_tpu_torch import native
from kinpoly_tpu_torch.physics import ltdl

SMEM_MAX = 232448            # a block's most on sm_90 (227 KB)


def factor_smem_bytes(nv: int, dp1: int) -> int:
    """Shared memory of a K1 block with one env: the block's depth and
    ancestor tables (each rounded to 16 bytes), then per env two broadcast
    rows of 32 floats and its packed rows."""
    r4 = lambda x: (x + 3) // 4 * 4
    return 4 * (r4(nv) + r4(nv * dp1) + 64 + nv * dp1)


def solve_smem_bytes(nv: int, dp1: int, nr: int) -> int:
    """Shared memory of one env of kernel K2 at width ``nr``, each region
    rounded to 16 bytes: the block's three int tables, then
    - R = 1: the packed rows, the pivots and the right-hand side;
    - R > 1: the columns of L, sized for the most a preorder tree can hold
      (depth[k] <= min(k, Dmax), plus 3 floats of alignment per column,
      since the launcher cannot read the depth table), the pivots, and the
      right-hand sides at an even row stride (a region that first holds the
      packed rows, so at least nv * (Dmax + 1) floats)."""
    r4 = lambda x: (x + 3) // 4 * 4
    if nr == 1:
        return 4 * (r4(3 * nv) + r4(nv * dp1) + r4(2 * nv))
    n_col = r4(sum(min(k, dp1 - 1) for k in range(nv)) + 3 * nv)
    return 4 * (r4(3 * nv) + n_col + r4(nv) + r4(nv * max(nr + nr % 2, dp1)))


def _check(name: str, x: torch.Tensor, shape_tail: tuple) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape[-len(shape_tail):]) != shape_tail:
        raise ValueError(f"{name}: expected (..., {shape_tail}), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _tables(topo: ltdl.LTDLTopo, device: torch.device):
    tabs = topo.kernel_tables
    if tabs[0].device != device:
        raise ValueError(f"topology tables live on {tabs[0].device}, "
                         f"the input on {device}")
    return tabs


def factor(topo: ltdl.LTDLTopo, R: torch.Tensor) -> torch.Tensor:
    """Packed M = L^T D L (kernel K1)."""
    if R.device.type == "cpu":
        return ltdl.factor(topo, R)
    nv, dp1 = topo.nv, topo.dmax + 1
    _check("ltdl_factor", R, (nv, dp1))
    if dp1 > 32:
        raise ValueError(f"ltdl_factor: tree depth {dp1 - 1} exceeds a warp")
    if not topo.preorder:
        raise ValueError("ltdl_factor: the kernel needs the dofs in "
                         "depth-first preorder")
    if factor_smem_bytes(nv, dp1) > SMEM_MAX:
        raise ValueError(f"ltdl_factor: {nv} dofs exceed the kernel's "
                         f"shared memory")
    anc, depth = _tables(topo, R.device)
    n = R.numel() // (nv * dp1)
    out = torch.empty_like(R)
    if n == 0:
        return out
    rc = native.library().ltdl_factor(
        R.data_ptr(), out.data_ptr(), anc.data_ptr(), depth.data_ptr(),
        n, nv, dp1, ltdl.DIAG_REG,
        torch.cuda.current_stream(R.device).cuda_stream)
    native.check_launch("ltdl_factor", rc)
    return out


def solve(topo: ltdl.LTDLTopo, Rf: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = M^-1 B from the packed factor (kernel K2); B (..., nv, R)."""
    if Rf.device.type == "cpu" and B.device.type == "cpu":
        return ltdl.solve(topo, Rf, B)
    nv, dp1 = topo.nv, topo.dmax + 1
    _check("ltdl_solve", Rf, (nv, dp1))
    nr = B.shape[-1]
    _check("ltdl_solve", B, (nv, nr))
    if B.shape[:-2] != Rf.shape[:-2] or B.device != Rf.device:
        raise ValueError(f"ltdl_solve: factor {tuple(Rf.shape)} on "
                         f"{Rf.device} vs rhs {tuple(B.shape)} on {B.device}")
    if not topo.preorder:
        raise ValueError("ltdl_solve: the kernel needs the dofs in "
                         "depth-first preorder")
    if nr < 1 or solve_smem_bytes(nv, dp1, nr) > SMEM_MAX:
        raise ValueError(f"ltdl_solve: {nr} right-hand sides exceed the "
                         f"kernel's shared memory")
    _, depth = _tables(topo, B.device)
    n = B.numel() // (nv * nr)
    X = torch.empty_like(B)
    if n == 0:
        return X
    rc = native.library().ltdl_solve(
        Rf.data_ptr(), B.data_ptr(), X.data_ptr(), depth.data_ptr(),
        n, nv, dp1, nr,
        torch.cuda.current_stream(B.device).cuda_stream)
    native.check_launch(f"ltdl_solve[R={nr}]", rc)
    return X
