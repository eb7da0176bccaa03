"""Wrapper of the block-PSOR kernel K3 in ``csrc/pgs.cu``.

Takes the engine's batch-leading layout: A (..., C, C), rhs and R
(..., C), Dinv (..., K, 3, 3), mu and active (..., K), float32 and
contiguous on a CUDA device (``active`` may be bool). A CPU tensor goes to
the plain version ``contact.psor_plain``; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from kinpoly_tpu_torch import native
from kinpoly_tpu_torch.physics import contact

SMEM_MAX = 232448            # a block's most on sm_90 (227 KB)
MAX_ROWS = 256               # at most 8 rows of A f per lane


def smem_bytes(C: int, K: int) -> int:
    """Shared memory of one warp: 32 / G envs (G = 16 lanes per env up to
    128 rows, 32 beyond), each with A at an odd row stride
    (rounded to 16 bytes) and a 24-float record per block (rhs, R, Dinv,
    mu, active, f)."""
    envs = 2 if C <= 128 else 1
    return 4 * envs * ((C * (C | 1) + 3) // 4 * 4 + 24 * K)


def pgs_solve(A: torch.Tensor, rhs: torch.Tensor, Dinv: torch.Tensor,
              R: torch.Tensor, mu: torch.Tensor, active: torch.Tensor,
              iters: int) -> torch.Tensor:
    """Contact forces f (..., C) after ``iters`` PSOR sweeps."""
    if A.device.type == "cpu":
        return contact.psor_plain(A, rhs, Dinv, R, mu, active, iters)
    C = rhs.shape[-1]
    K = mu.shape[-1]
    lead = rhs.shape[:-1]
    active = active.to(torch.float32)
    expect = {"A": (A, lead + (C, C)), "rhs": (rhs, lead + (C,)),
              "Dinv": (Dinv, lead + (K, 3, 3)), "R": (R, lead + (C,)),
              "mu": (mu, lead + (K,)), "active": (active, lead + (K,))}
    for name, (x, shape) in expect.items():
        if x.device != A.device or x.device.type != "cuda":
            raise ValueError(f"pgs_solve: {name} on {x.device}, A on {A.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"pgs_solve: {name} is {x.dtype}, not float32")
        if tuple(x.shape) != shape:
            raise ValueError(f"pgs_solve: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"pgs_solve: {name} is not contiguous")
    if C != 3 * K:
        raise ValueError(f"pgs_solve: {C} rows for {K} blocks")
    if C > MAX_ROWS or smem_bytes(C, K) > SMEM_MAX:
        raise ValueError(f"pgs_solve: {C} rows exceed the kernel's shared memory")
    f = torch.empty_like(rhs)
    n = rhs.numel() // C
    if n == 0:
        return f
    rc = native.library().pgs_solve(
        A.data_ptr(), rhs.data_ptr(), Dinv.data_ptr(), R.data_ptr(),
        mu.data_ptr(), active.data_ptr(), f.data_ptr(), n, C, K, iters,
        torch.cuda.current_stream(A.device).cuda_stream)
    native.check_launch("pgs_solve", rc)
    return f
