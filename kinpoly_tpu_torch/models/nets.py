"""Core networks (port of ``kinpoly_tpu/models/nets.py``): MLP, value, and
the multiplicative compositional (MCP) policy of UHC.

Layer names follow the flax modules so that ``models/weights.py`` maps a
flax parameter tree onto these state dicts one to one.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

_ACT = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
        "gelu": nn.functional.gelu}


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int],
                 activation: str = "relu"):
        super().__init__()
        dims = (in_dim,) + tuple(hidden)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))
        self.act = _ACT[activation]

    def forward(self, x):
        for layer in self.layers:
            x = self.act(layer(x))
        return x


class Value(nn.Module):
    """MLP + scalar head."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (512, 256),
                 activation: str = "relu"):
        super().__init__()
        self.mlp = MLP(in_dim, hidden, activation)
        self.head = nn.Linear(tuple(hidden)[-1], 1)

    def forward(self, x):
        return self.head(self.mlp(x))[..., 0]


class PrimitiveBank(nn.Module):
    """All P primitive MLPs as one batched contraction per layer: weights
    stacked (P, in, out), named w_{out}_{in} / b_{out}_{in} as in flax."""

    def __init__(self, in_dim: int, num_primitive: int, hidden: Sequence[int],
                 action_dim: int, activation: str = "relu"):
        super().__init__()
        self.act = _ACT[activation]
        self.shapes = []
        d = in_dim
        for out in tuple(hidden) + (action_dim,):
            self.register_parameter(
                f"w_{out}_{d}", nn.Parameter(torch.zeros(num_primitive, d, out)))
            self.register_parameter(
                f"b_{out}_{d}", nn.Parameter(torch.zeros(num_primitive, out)))
            self.shapes.append((out, d))
            d = out
        self.num_primitive = num_primitive

    def forward(self, x):
        h = x[..., None, :].expand(x.shape[:-1] + (self.num_primitive, x.shape[-1]))
        for i, (out, d) in enumerate(self.shapes):
            w = getattr(self, f"w_{out}_{d}")
            b = getattr(self, f"b_{out}_{d}")
            h = torch.einsum("...pi,pio->...po", h, w) + b
            if i < len(self.shapes) - 1:
                h = self.act(h)
        return h                                             # (..., P, A)


class PolicyMCP(nn.Module):
    """P primitive heads mixed by a softmax composer; mean = sum_i w_i mu_i.
    The log-std is fixed (``fix_std``, as UHC trains it)."""

    def __init__(self, in_dim: int, action_dim: int, num_primitive: int = 8,
                 hidden: Sequence[int] = (512, 256),
                 composer_hidden: Sequence[int] = (300, 200),
                 activation: str = "relu", log_std_init: float = -2.3):
        super().__init__()
        self.bank = PrimitiveBank(in_dim, num_primitive, hidden, action_dim,
                                  activation)
        self.composer = MLP(in_dim, composer_hidden, activation)
        self.composer_head = nn.Linear(tuple(composer_hidden)[-1], num_primitive)
        self.log_std_init = log_std_init

    def forward(self, x):
        prims = self.bank(x)
        w = torch.softmax(self.composer_head(self.composer(x)), dim=-1)
        mean = torch.einsum("...p,...pa->...a", w, prims)
        return mean, torch.full_like(mean, self.log_std_init)
