"""Frozen operation and byte counts: the chip's published peaks, the
bytes and FLOPs that each kernel of the substep needs for its launch's
shapes (K1 ``ltdl_factor``, K2 ``ltdl_solve``, K3 ``pgs_solve``), and the
FLOPs one training iteration's or evaluation step's algorithm needs.

The kernel counts are those of the port's ``chip_smoke.py`` (its
``bound_ms`` and the K1-K3 byte and FLOP expressions), kept here so that a
change to the program cannot change them. Each counts what the inputs
need: every input byte read once, every output byte written once, the
packed factor's live slots only.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores

# the synthetic SMPL humanoid's dof tree (anim/spec.py, 24 bodies, 75
# dofs): each dof's depth below the root in the LTDL ordering
DEPTH = (list(range(18)) + list(range(6, 18)) + list(range(6, 21))
         + list(range(15, 30)) + list(range(15, 30)))


def bound_s(n_bytes: float, n_flop: float) -> float:
    """The least time the chip could take: the larger of bytes over the
    HBM rate and FLOPs over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flop / F32_FLOP_PER_S)


def ltdl_factor(n_env: int, depth: list) -> tuple[float, float]:
    """K1, one packed M = L^T D L per env: (bytes, FLOPs)."""
    n_valid = sum(d + 1 for d in depth)
    flop = n_env * sum(d * (d + 1) + 2 * d for d in depth)
    return 2 * n_env * n_valid * 4, float(flop)


def ltdl_solve(n_env: int, depth: list, nr: int) -> tuple[float, float]:
    """K2, X = M^-1 B with B (nv, nr) per env: (bytes, FLOPs)."""
    nv = len(depth)
    n_valid = sum(d + 1 for d in depth)
    flop = n_env * nr * (4 * sum(depth) + nv)
    return (n_env * n_valid + 2 * n_env * nv * nr) * 4, float(flop)


def pgs_solve(n_env: int, n_blocks: int, iters: int,
              active_bytes: int = 1) -> tuple[float, float]:
    """K3, ``iters`` PSOR sweeps over K = n_blocks 3-row blocks (C = 3K
    rows) per env: A (C, C), rhs, R and f (C), Dinv (K, 3, 3), mu and
    active (K): (bytes, FLOPs)."""
    C, K = 3 * n_blocks, n_blocks
    n_bytes = 4 * n_env * (C * C + 3 * C + 9 * K + K) + n_env * K * active_bytes
    flop = n_env * iters * K * (3 * C * 2 + 9 * 2 + 12)
    return float(n_bytes), float(flop)


def mlp_flop(widths: list) -> float:
    """FLOPs of one row through dense layers of these widths (in, h1, ...,
    out): a multiply and an add per weight."""
    return float(sum(2 * a * b for a, b in zip(widths[:-1], widths[1:])))


def mcp_flop(obs_dim: int, action_dim: int, n_prim: int, hsize: list,
             composer: list) -> float:
    """One row through the MCP policy: n_prim primitive MLPs and the
    composer's weights, and the weighted sum of the primitives."""
    prim = n_prim * mlp_flop([obs_dim, *hsize, action_dim])
    comp = mlp_flop([obs_dim, *composer, n_prim])
    return prim + comp + 2 * n_prim * action_dim


def substep_flop(depth: list, n_blocks: int, iters: int, n_rhs: int,
                 n_bodies: int = 24) -> float:
    """The physics FLOPs of one substep of one env that the algorithm
    needs: FK over the bodies (a quaternion product and a rotation per
    body), CRBA into the packed rows, two factorisations, the solves with
    1 and n_rhs right-hand sides, the Delassus product J M^-1 J^T
    (C x nv x C) and the PSOR sweeps."""
    nv = len(depth)
    C = 3 * n_blocks
    fk = n_bodies * (28 + 30)
    crba = sum(2 * 6 * 6 * (d + 1) for d in depth)
    f1 = sum(d * (d + 1) + 2 * d for d in depth)
    s = (1 + n_rhs) * (4 * sum(depth) + nv)
    delassus = 2 * C * nv * C
    psor = iters * n_blocks * (3 * C * 2 + 9 * 2 + 12)
    return float(fk + crba + 2 * f1 + s + delassus + psor)
