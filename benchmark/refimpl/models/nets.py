"""Core networks (as ``kinpoly_tpu/models/nets.py``): MLP, value, the
diagonal-Gaussian policy, the multiplicative compositional (MCP) policy of
UHC, the diagonal-Gaussian log-density and KL divergence.

Layer names follow the flax modules so that ``models/weights.py`` maps a
flax parameter tree onto these state dicts one to one. Fresh parameters
follow flax's initialisation (``init_flax_``), not torch's.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

# stddev of a unit normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978

_ACT = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
        "gelu": nn.functional.gelu}


def _linear(a: int, b: int) -> nn.Linear:
    """An uninitialised Linear (its values come from a checkpoint or
    ``init_flax_``; torch's own init would draw from the global RNG)."""
    return nn.utils.skip_init(nn.Linear, a, b)


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int],
                 activation: str = "relu"):
        super().__init__()
        dims = (in_dim,) + tuple(hidden)
        self.layers = nn.ModuleList(_linear(a, b) for a, b in zip(dims, dims[1:]))
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
        self.head = _linear(tuple(hidden)[-1], 1)

    def forward(self, x):
        return self.head(self.mlp(x))[..., 0]


class _StdHead(nn.Module):
    """The policies' log-std: fixed at ``log_std_init`` with ``fix_std``,
    else a learnable (action_dim,) parameter ``log_std``."""

    def _init_std(self, action_dim: int, log_std_init: float, fix_std: bool):
        self.log_std_init = log_std_init
        self.fix_std = fix_std
        if not fix_std:
            self.log_std = nn.Parameter(torch.full((action_dim,), log_std_init))

    def _with_std(self, mean: torch.Tensor):
        if self.fix_std:
            return mean, torch.full_like(mean, self.log_std_init)
        return mean, self.log_std.expand(mean.shape)


class PolicyGaussian(_StdHead):
    """MLP -> mean (UHC's ``actor_type: gauss``)."""

    def __init__(self, in_dim: int, action_dim: int,
                 hidden: Sequence[int] = (512, 256), activation: str = "relu",
                 log_std_init: float = -2.3, fix_std: bool = True):
        super().__init__()
        self.mlp = MLP(in_dim, hidden, activation)
        self.head = _linear(tuple(hidden)[-1], action_dim)
        self._init_std(action_dim, log_std_init, fix_std)

    def forward(self, x):
        return self._with_std(self.head(self.mlp(x)))


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


class PolicyMCP(_StdHead):
    """P primitive heads mixed by a softmax composer; mean = sum_i w_i mu_i.
    The log-std is fixed with ``fix_std`` (as uhc.yml trains it), else a
    learnable (action_dim,) parameter ``log_std``."""

    def __init__(self, in_dim: int, action_dim: int, num_primitive: int = 8,
                 hidden: Sequence[int] = (512, 256),
                 composer_hidden: Sequence[int] = (300, 200),
                 activation: str = "relu", log_std_init: float = -2.3,
                 fix_std: bool = True):
        super().__init__()
        self.bank = PrimitiveBank(in_dim, num_primitive, hidden, action_dim,
                                  activation)
        self.composer = MLP(in_dim, composer_hidden, activation)
        self.composer_head = _linear(tuple(composer_hidden)[-1], num_primitive)
        self._init_std(action_dim, log_std_init, fix_std)

    def forward(self, x):
        prims = self.bank(x)
        w = torch.softmax(self.composer_head(self.composer(x)), dim=-1)
        return self._with_std(torch.einsum("...p,...pa->...a", w, prims))


@torch.no_grad()
def init_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh parameters as flax initialises them: every kernel lecun-normal
    (a normal truncated at 2 sigma, variance 1 / fan_in; the primitive
    bank's (P, in, out) weights per primitive, fan_in = in; a GRU's or an
    LSTM's input kernels per gate), their recurrent kernels orthogonal per
    gate,
    every bias 0, ``log_std`` at its initial value. Draws from
    `generator`, which must live on the parameters' device."""
    for m in module.modules():
        if isinstance(m, (nn.GRU, nn.GRUCell, nn.LSTM)):
            gates = 4 if isinstance(m, nn.LSTM) else 3
            for name, w in m.named_parameters():
                if name.startswith("bias"):
                    w.zero_()
                    continue
                for g in w.chunk(gates, dim=0):   # r, z, n or i, f, g, o
                    if name.startswith("weight_ih"):
                        _lecun_normal_(g, g.shape[1], generator)
                    else:
                        nn.init.orthogonal_(g, generator=generator)
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, generator)
            m.bias.zero_()
        elif isinstance(m, PrimitiveBank):
            for out, d in m.shapes:
                _lecun_normal_(getattr(m, f"w_{out}_{d}"), d, generator)
                getattr(m, f"b_{out}_{d}").zero_()
        elif isinstance(m, _StdHead) and not m.fix_std:
            m.log_std.fill_(m.log_std_init)
    return module


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def gaussian_log_prob(x: torch.Tensor, mean: torch.Tensor,
                      log_std: torch.Tensor) -> torch.Tensor:
    """Log-density of a diagonal Gaussian, summed over the last dim."""
    var = torch.exp(2.0 * log_std)
    half_log_2pi = 0.5 * torch.log(torch.tensor(2 * math.pi, dtype=torch.float64)
                                   ).to(dtype=x.dtype, device=x.device)
    lp = -((x - mean) ** 2) / (2 * var) - half_log_2pi - log_std
    return lp.sum(dim=-1)


def gaussian_kl(mean0: torch.Tensor, log_std0: torch.Tensor,
                mean1: torch.Tensor, log_std1: torch.Tensor) -> torch.Tensor:
    """KL(p0 || p1) of two diagonal Gaussians, summed over the last dim."""
    var0, var1 = torch.exp(2 * log_std0), torch.exp(2 * log_std1)
    kl = log_std1 - log_std0 + (var0 + (mean0 - mean1) ** 2) / (2 * var1) - 0.5
    return kl.sum(dim=-1)
