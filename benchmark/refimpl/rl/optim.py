"""The optax chains of the AR trainer (as the JAX package's), in torch:
``zero_nans`` (optional), ``clip_by_global_norm`` (optional) and
``adam``, over a list of parameters.

Unlike ``torch.optim.Adam``, which skips a parameter whose ``.grad`` is
None, the chain steps every parameter as optax steps every leaf: a missing
gradient is a zero gradient, which still moves the parameter through
Adam's momentum. The chain also has one step count, as optax's. The
update follows optax: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g²,
p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).
"""

from __future__ import annotations

import torch


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class AdamChain:
    """[zero_nans] -> [clip_by_global_norm(max_norm)] -> adam(lr) over
    `params`."""

    def __init__(self, params, lr: float, max_norm: float | None = None,
                 zero_nans: bool = False, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.max_norm, self.zero_nans = lr, max_norm, zero_nans
        self.b1, self.b2, self.eps = b1, b2, eps
        self.reset()

    def reset(self) -> None:
        """Fresh state (optax's ``init``); the moments are allocated at the
        first step."""
        self.count = 0
        self.mu = self.nu = None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (None counts as 0)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.zero_nans:
            grads = [torch.where(torch.isnan(g), torch.zeros_like(g), g)
                     for g in grads]
        if self.max_norm is not None:
            norm = global_norm(grads)
            keep = norm < self.max_norm
            grads = [torch.where(keep, g, (g / norm) * self.max_norm)
                     for g in grads]
        if self.mu is None:
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            p.sub_(self.lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps)))
