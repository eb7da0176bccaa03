"""Dense batched Cholesky factor and triangular solves, plain PyTorch: the
oracles of the kernels K4a-c in ``csrc/chol.cu`` (as the device
routines ``_factor``, ``_fwd_solve`` and ``_bwd_solve`` of
``kinpoly_tpu/physics/pallas_chol.py``).

Batch-leading: A and L are (..., n, n), B and X (..., n, R). Only the lower
triangle of A (or L) is read. There is no pivot floor: an input that is not
SPD gives NaN, as XLA and the Pallas kernels do.
"""

from __future__ import annotations

import torch


def factor(A: torch.Tensor) -> torch.Tensor:
    """Right-looking Cholesky: L (..., n, n), lower, zeros above the
    diagonal. Column j is the working column scaled by the square root of
    its pivot; the trailing block then loses the outer product of the
    strictly-lower part."""
    n = A.shape[-1]
    W = A.clone()
    L = torch.zeros_like(A)
    for j in range(n):
        d = torch.sqrt(W[..., j, j])
        col = W[..., j:, j] / d[..., None]
        L[..., j:, j] = col
        u = col[..., 1:]
        W[..., j + 1:, j + 1:] -= u[..., :, None] * u[..., None, :]
    return L


def apply(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = (L L^T)^-1 B: the forward solve L Y = B, then L^T X = Y."""
    n = L.shape[-1]
    X = B.clone()
    for j in range(n):
        X[..., j, :] = X[..., j, :] / L[..., j, j, None]
        X[..., j + 1:, :] -= L[..., j + 1:, j, None] * X[..., j, None, :]
    for j in reversed(range(n)):
        X[..., j, :] = X[..., j, :] / L[..., j, j, None]
        X[..., :j, :] -= L[..., j, :j, None] * X[..., j, None, :]
    return X


def solve_only(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = A^-1 B through the factor, which is not returned (K4a)."""
    return apply(factor(A), B)


def factor_solve(A: torch.Tensor, B: torch.Tensor):
    """(L, X = A^-1 B) (K4b)."""
    L = factor(A)
    return L, apply(L, B)
