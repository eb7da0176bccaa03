"""Training-liveness guards against the silent-freeze failure class (port of
``kinpoly_tpu/utils/liveness.py``).

A supervised optimiser chain that zeroes NaN gradient entries can run on
while learning nothing. ``grad_nonfinite_fraction`` counts the gradient
leaves that hold a non-finite value (logged per update as ``grad_nan_frac``
and ``bc_nan_frac``); ``check_supervised_liveness`` aborts a supervised
phase whose loss does not drop.

The leaves are those of the JAX package's flax parameter tree, so that the
logged fractions mean the same in both packages: a ``Linear`` is a kernel
and a bias leaf, a GRU is flax ``GRUCell``'s 10 leaves (``ir``/``iz``/``in``
kernel and bias, ``hr``/``hz`` kernel, ``hn`` kernel and bias) cut from the
torch GRU's 4 stacked (r, z, n) parameters; the r and z hidden biases have
no flax leaf.
"""

from __future__ import annotations

import numpy as np
import torch

# above this per-step fraction of zeroed gradient leaves, training is
# effectively frozen
NAN_FRAC_WARN = 0.05


def _gru_part(name: str) -> str | None:
    leaf = name.rsplit(".", 1)[-1]
    for part in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        if leaf.startswith(part):
            return part
    return None


def flax_leaves(name: str, t: torch.Tensor) -> list[torch.Tensor]:
    """The flax leaves of torch parameter (or gradient) `t` named `name`:
    a GRU's stacked weights and input biases are 3 leaves (r, z, n), its
    hidden bias 1 (n); any other parameter is one leaf."""
    part = _gru_part(name)
    if part is None:
        return [t]
    chunks = list(t.chunk(3, dim=0))
    return chunks[2:] if part == "bias_hh" else chunks


def n_flax_leaves(name: str) -> int:
    part = _gru_part(name)
    return 1 if part in (None, "bias_hh") else 3


def grad_nonfinite_fraction(named_grads) -> torch.Tensor:
    """Fraction of flax gradient leaves holding any non-finite value, a
    0-dim float32 tensor (no host sync). `named_grads`: (name, gradient or
    None) pairs, as ``[(n, p.grad) for n, p in module.named_parameters()]``;
    a None gradient is a leaf of zeros."""
    named_grads = list(named_grads)
    flags = [torch.any(~torch.isfinite(x))
             for name, g in named_grads if g is not None
             for x in flax_leaves(name, g)]
    if not flags:
        return torch.zeros((), dtype=torch.float32)
    n = sum(n_flax_leaves(name) for name, _ in named_grads)
    return torch.stack(flags).sum().to(torch.float32) / n


class LivenessError(RuntimeError):
    """A supervised training phase failed to learn (flat or rising loss)."""


def check_supervised_liveness(losses, phase: str = "supervised",
                              nan_fracs=None, min_drop: float = 0.10,
                              floor: float = 1.0, head: int = 5) -> None:
    """Abort if a supervised phase's loss curve is flat.

    losses: sampled losses in step order (the train_init yield stream).
    Requires median(last `head`) <= (1 - min_drop) * median(first `head`)
    unless the phase started converged (first median <= `floor`, e.g. a
    resumed checkpoint). Raises LivenessError, naming the zeroed gradients
    as the likely cause when their counter was hot."""
    losses = [float(x) for x in losses]
    if len(losses) < 2 * head:
        return  # too short to judge (smoke runs, tests)
    first = float(np.median(losses[:head]))
    last = float(np.median(losses[-head:]))
    if not np.isfinite(first) or not np.isfinite(last):
        raise LivenessError(
            f"{phase}: non-finite loss (first-median {first}, last-median "
            f"{last}) — training diverged")
    if first <= floor:
        return  # started converged (warm resume); nothing to prove
    if last > (1.0 - min_drop) * first:
        hot = ""
        if nan_fracs is not None:
            nf = [float(x) for x in nan_fracs]
            if nf and float(np.mean(nf)) > NAN_FRAC_WARN:
                hot = (f" — zero_nans zeroed {np.mean(nf):.0%} of gradient "
                       f"leaves on average: the updates were silently "
                       f"discarded (round-4 NaN-gradient class; check the "
                       f"rotation-math VJPs, core/tmath.py)")
        raise LivenessError(
            f"{phase}: loss did not drop ({first:.4g} -> {last:.4g}, "
            f"needed -{min_drop:.0%}) over {len(losses)} samples{hot}")
