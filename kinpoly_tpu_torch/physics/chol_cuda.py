"""Wrappers of the dense Cholesky kernels K4a-c in ``csrc/chol.cu``.

A (or L) is (..., n, n) and B (..., n, R), float32, contiguous, on one CUDA
device; only the lower triangle of A (or L) is read. A CPU tensor goes to
the plain version in ``chol``; a CUDA tensor launches the kernel or raises.
Launches are counted per right-hand-side width, as ``name[R=r]``.
"""

from __future__ import annotations

import torch

from kinpoly_tpu_torch import native
from kinpoly_tpu_torch.physics import chol

SMEM_MAX = 232448            # a block's most on sm_90 (227 KB)


def solve_smem_bytes(n: int, nr: int) -> int:
    """Shared memory of one env (one block) of K4a, K4b and K4c, in their
    layout (``csrc/chol.cu``): with np = n rounded up to 4, the np rows of
    A (or L) folded in pairs into np / 2 rows of stride SL, the R
    right-hand-side rows of stride Se, then the np reciprocal pivots and
    the 4 x 4 diagonal block; SL >= np + 4 and Se >= np are the first
    multiples of 4 with an odd number of 16-byte chunks."""
    odd_quads = lambda x: x if (x // 4) % 2 == 1 else x + 4
    np_ = (n + 3) // 4 * 4
    return 4 * (np_ // 2 * odd_quads(np_ + 4) + nr * odd_quads(np_) + np_ + 16)


def _check(name: str, A: torch.Tensor, B: torch.Tensor) -> tuple[int, int, int]:
    """(envs, n, R) after checking what the kernel takes."""
    for x in (A, B):
        if x.device.type != "cuda" or x.device != A.device:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {A.device} and {B.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
    n = A.shape[-1]
    if A.dim() < 3 or A.shape[-2] != n or B.shape[:-1] != A.shape[:-1]:
        raise ValueError(f"{name}: expected A (..., n, n) and B (..., n, R), "
                         f"got {tuple(A.shape)} and {tuple(B.shape)}")
    nr = B.shape[-1]
    if n < 1 or nr < 1 or solve_smem_bytes(n, nr) > SMEM_MAX:
        raise ValueError(f"{name}: n = {n} with {nr} right-hand sides exceeds "
                         f"the kernel's shared memory")
    return A.numel() // (n * n), n, nr


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def solve_only(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = A^-1 B for SPD A, factor not returned (kernel K4a)."""
    if A.device.type == "cpu" and B.device.type == "cpu":
        return chol.solve_only(A, B)
    n_env, n, nr = _check("chol_solve_only", A, B)
    X = torch.empty_like(B)
    if n_env == 0:
        return X
    rc = native.library().chol_solve_only(
        A.data_ptr(), B.data_ptr(), X.data_ptr(), n_env, n, nr, _stream(B))
    native.check_launch(f"chol_solve_only[R={nr}]", rc)
    return X


def factor_solve(A: torch.Tensor, B: torch.Tensor):
    """(L, X = A^-1 B), L lower with zeros above the diagonal (kernel K4b)."""
    if A.device.type == "cpu" and B.device.type == "cpu":
        return chol.factor_solve(A, B)
    n_env, n, nr = _check("chol_factor_solve", A, B)
    L = torch.empty_like(A)
    X = torch.empty_like(B)
    if n_env == 0:
        return L, X
    rc = native.library().chol_factor_solve(
        A.data_ptr(), B.data_ptr(), L.data_ptr(), X.data_ptr(), n_env, n, nr,
        _stream(B))
    native.check_launch(f"chol_factor_solve[R={nr}]", rc)
    return L, X


def apply(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = (L L^T)^-1 B for a lower factor L (kernel K4c)."""
    if L.device.type == "cpu" and B.device.type == "cpu":
        return chol.apply(L, B)
    n_env, n, nr = _check("chol_apply", L, B)
    X = torch.empty_like(B)
    if n_env == 0:
        return X
    rc = native.library().chol_apply(
        L.data_ptr(), B.data_ptr(), X.data_ptr(), n_env, n, nr, _stream(B))
    native.check_launch(f"chol_apply[R={nr}]", rc)
    return X
