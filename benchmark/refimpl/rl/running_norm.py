"""Running observation normalisation (as ``kinpoly_tpu/rl/running_norm.py``; the reference ZFilter, clip +-5): the
(count, mean, M2) state, batch updates by Chan's parallel merge, and the
clipped standardisation."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RunningNorm(NamedTuple):
    count: torch.Tensor   # ()
    mean: torch.Tensor    # (d,)
    m2: torch.Tensor      # (d,) sum of squared deviations


def init(dim: int, device=None) -> RunningNorm:
    """Empty stats in float32, as the JAX package keeps them."""
    z = torch.zeros(dim, dtype=torch.float32, device=device)
    return RunningNorm(z.new_zeros(()), z, z.clone())


def update_batch(rn: RunningNorm, x: torch.Tensor) -> RunningNorm:
    """Fold a batch x (..., d) into the stats (Chan's parallel merge). The
    count keeps its float32, as in JAX; mean and M2 take the wider of their
    own and the batch's dtype."""
    flat = x.reshape(-1, x.shape[-1])
    n_b = torch.tensor(flat.shape[0], dtype=rn.count.dtype,
                       device=rn.count.device)
    mean_b = flat.mean(dim=0)
    m2_b = torch.sum((flat - mean_b) ** 2, dim=0)
    n = rn.count + n_b
    delta = mean_b - rn.mean
    mean = rn.mean + delta * n_b / torch.clamp(n, min=1.0)
    m2 = rn.m2 + m2_b + delta ** 2 * rn.count * n_b / torch.clamp(n, min=1.0)
    return RunningNorm(count=n, mean=mean, m2=m2)


def std(rn: RunningNorm) -> torch.Tensor:
    """sqrt(M2 / max(n - 1, 1)) in the stats' dtype. The sqrt goes through
    float64 and back, which rounds it correctly: torch's vectorised float32
    sqrt on the CPU can be an ulp off numpy's and XLA's."""
    var = torch.clamp(rn.m2 / torch.clamp(rn.count - 1.0, min=1.0), min=1e-12)
    return torch.sqrt(var.double()).to(var.dtype)


def apply(rn: RunningNorm, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
    """(x - mean) / (std + 1e-8), clipped. The stats keep their own dtype
    (float32 in the checkpoints) and are cast only after the std, as the
    JAX package's type promotion does."""
    y = (x - rn.mean.to(x.dtype)) / (std(rn) + 1e-8).to(x.dtype)
    return torch.clamp(y, -clip, clip)
