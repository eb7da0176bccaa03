"""The reference's stand-in for the port's K3 wrapper: plain PSOR on
every device."""

from __future__ import annotations

import torch

from refimpl.physics import contact


def pgs_solve(A: torch.Tensor, rhs: torch.Tensor, Dinv: torch.Tensor,
              R: torch.Tensor, mu: torch.Tensor, active: torch.Tensor,
              iters: int) -> torch.Tensor:
    return contact.psor_plain(A, rhs, Dinv, R, mu, active, iters)
