"""The numbers a check compares: gaps between what the program produced
and what the reference works out, each reduced to one float (the worst
row, coordinate or leaf)."""

from __future__ import annotations

import math

import torch


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |p - r| / max(1, |r|) over all elements: absolute where the
    reference is small, relative where it is large."""
    p = prog.to(ref.dtype).to(ref.device)
    d = (p - ref).abs() / torch.clamp(ref.abs(), min=1.0)
    return float(d.max()) if d.numel() else 0.0


def row_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's rel_gap (the last dim's elements reduced)."""
    p = prog.to(ref.dtype).to(ref.device)
    d = (p - ref).abs() / torch.clamp(ref.abs(), min=1.0)
    return d.reshape(d.shape[0], -1).amax(dim=1) if d.dim() > 1 else d


def quantile(rows: torch.Tensor, q: float) -> float:
    """The q-quantile of `rows` by nearest rank (no interpolation, so an
    infinite row reads infinite, not NaN)."""
    v = rows.double().flatten().sort().values
    return float(v[min(v.numel() - 1, max(0, math.ceil(q * v.numel()) - 1))])


def leaf_norm_gap(prog: list, ref: list, keep: list | None = None) -> float:
    """The worst leaf's |norm(p) - norm(r)| over the larger of norm(r) and
    the median leaf's norm(r) (some leaves are all but zero). `keep`
    (bools) leaves out the leaves marked False."""
    pn = [float(torch.linalg.vector_norm(p.double())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = float(torch.tensor(rn).median())
    worst = 0.0
    for i, (a, b) in enumerate(zip(pn, rn)):
        if keep is not None and not keep[i]:
            continue
        worst = max(worst, abs(a - b) / max(b, med, 1e-30))
    return worst


def moved_leaves(grad1_ref: list, floor: float = 1e-3) -> list:
    """Leaves whose first gradient in the reference is at least `floor`
    times the median leaf's: the others move under Adam by round-off."""
    n = [float(torch.linalg.vector_norm(g.double())) for g in grad1_ref]
    med = float(torch.tensor(n).median())
    return [x >= floor * med for x in n]


# the share of an env step's rows whose gaps may lie above the compared one
ROW_Q = 0.99


def step_numbers(p_sim, r_sim, p_obs, r_obs, p_rew, r_rew, p_done,
                 r_done) -> list:
    """The env step's numbers over its rows (one per recorded control step
    and env): the 99th percentile of the rows' state, observation and
    reward gaps, a row whose done flag differs counting as infinitely far.
    So a fault in more than one row in a hundred shows; the widest row is
    not compared, since one env in a few thousand whose contact set parts
    float32 from float64 within the 15 substeps moves by O(1)."""
    differs = p_done.to(r_done.device) != r_done
    out = []
    for k, (p, r) in dict(state=(p_sim, r_sim), obs=(p_obs, r_obs),
                          reward=(p_rew, r_rew)).items():
        v = row_gaps(p, r)
        v = torch.where(differs, torch.full_like(v, float("inf")), v)
        out.append((f"step_{k}", quantile(v, ROW_Q)))
    return out
