"""The reference's stand-in for the port's K4a-c wrappers: the plain dense
Cholesky on every device."""

from __future__ import annotations

from refimpl.physics import chol

solve_only = chol.solve_only
factor_solve = chol.factor_solve
apply = chol.apply
