"""Running observation normalisation (port of
``kinpoly_tpu/rl/running_norm.py``; the reference ZFilter, clip +-5)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RunningNorm(NamedTuple):
    count: torch.Tensor   # ()
    mean: torch.Tensor    # (d,)
    m2: torch.Tensor      # (d,) sum of squared deviations


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
