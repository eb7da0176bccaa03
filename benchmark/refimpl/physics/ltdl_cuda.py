"""The reference's stand-in for the port's K1/K2 wrappers: the plain LTDL
factor and solve on every device."""

from __future__ import annotations

import torch

from refimpl.physics import ltdl


def factor(topo: ltdl.LTDLTopo, R: torch.Tensor) -> torch.Tensor:
    return ltdl.factor(topo, R)


def solve(topo: ltdl.LTDLTopo, Rf: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return ltdl.solve(topo, Rf, B)
