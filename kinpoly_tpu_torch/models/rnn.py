"""Recurrent module with a step mode and a batch mode, GRU or LSTM cells,
optionally bidirectional in batch mode (port of ``kinpoly_tpu/models/
rnn.py``; reference ``kin_poly/models/rnn.py``).

The carry is explicit, as in the JAX module: ``step`` takes and returns it.
A GRU carry is h; an LSTM carry is (c, h), flax's order (torch's is
(h, c)). The cells follow flax's parameterisation, which has one bias
where torch has two: a GRU has no hidden bias on its r and z gates
(``bias_hh``'s first two thirds stay 0), an LSTM has only the hidden-side
bias (``bias_ih`` stays 0); gradient hooks keep those zeros through
training. ``models/weights.rnn_from_jax`` maps a flax tree onto this
module. The backward direction is a second single-direction RNN run over
the reversed time axis, its outputs reversed back.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _zero_grad(g: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(g)


def zero_rz_grad(g: torch.Tensor) -> torch.Tensor:
    """A GRU hidden bias's gradient with its r and z thirds zeroed: flax's
    GRUCell has no such bias, so the torch GRU keeps them at 0."""
    g = g.clone()
    g[: 2 * (g.shape[0] // 3)] = 0.0
    return g


def _cell(cell_type: str, input_dim: int, hidden_dim: int) -> nn.RNNBase:
    """A one-layer, one-direction torch GRU or LSTM with flax's biases. Its
    values come from a checkpoint or ``init_flax_`` (torch's own init would
    draw from the global RNG)."""
    if cell_type not in ("gru", "lstm"):
        raise ValueError(cell_type)
    cls = nn.GRU if cell_type == "gru" else nn.LSTM
    rnn = cls(input_dim, hidden_dim, device="meta").to_empty(device="cpu")
    if cell_type == "gru":
        rnn.bias_hh_l0.register_hook(zero_rz_grad)
    else:
        rnn.bias_ih_l0.register_hook(_zero_grad)
    with torch.no_grad():
        if cell_type == "gru":
            rnn.bias_hh_l0[: 2 * hidden_dim].zero_()
        else:
            rnn.bias_ih_l0.zero_()
    return rnn


class RNN(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, cell_type: str = "gru",
                 bi_dir: bool = False):
        super().__init__()
        self.hidden_dim, self.cell_type, self.bi_dir = hidden_dim, cell_type, bi_dir
        self.cell = _cell(cell_type, input_dim, hidden_dim)
        self.cell_bwd = _cell(cell_type, input_dim, hidden_dim) if bi_dir else None

    def init_carry(self, batch_shape=(), dtype=None, device=None):
        """Zeros: h, or (c, h) for an LSTM."""
        p = self.cell.weight_hh_l0
        z = torch.zeros(tuple(batch_shape) + (self.hidden_dim,),
                        dtype=dtype or p.dtype, device=device or p.device)
        return z if self.cell_type == "gru" else (z, z.clone())

    def _run(self, rnn: nn.RNNBase, carry, xs: torch.Tensor):
        """xs (T, N, in), carry of (N, H) -> (carry, outputs (T, N, H))."""
        if self.cell_type == "gru":
            out, h = rnn(xs, carry[None])
            return h[0], out
        c, h = carry
        out, (h, c) = rnn(xs, (h[None], c[None]))
        return (c[0], h[0]), out

    def scan(self, carry, x: torch.Tensor, time_axis: int = 1):
        """The forward cell from `carry` over `time_axis` of x -> (final
        carry, the outputs of every step)."""
        xs = torch.movedim(x, time_axis, 0)
        T, lead = xs.shape[0], xs.shape[1:-1]
        n = math.prod(lead)
        flat = lambda t: t.reshape(n, self.hidden_dim)
        carry = (flat(carry) if self.cell_type == "gru"
                 else tuple(flat(t) for t in carry))
        carry, out = self._run(self.cell, carry, xs.reshape(T, n, xs.shape[-1]))
        back = lambda t: t.reshape(lead + (self.hidden_dim,))
        carry = (back(carry) if self.cell_type == "gru"
                 else tuple(back(t) for t in carry))
        out = out.reshape((T,) + lead + (self.hidden_dim,))
        return carry, torch.movedim(out, 0, time_axis)

    def step(self, carry, x: torch.Tensor):
        """One step of the forward cell: (carry, x (..., in)) -> (carry,
        h (..., hidden))."""
        carry, out = self.scan(carry, x[None], time_axis=0)
        return carry, out[0]

    def forward(self, x: torch.Tensor, time_axis: int = 1) -> torch.Tensor:
        """Batch mode over `time_axis` of x from a zero carry: the outputs of
        every step (forward and backward concatenated with ``bi_dir``)."""
        xs = torch.movedim(x, time_axis, 0)
        T, lead = xs.shape[0], xs.shape[1:-1]
        n = math.prod(lead)
        xs = xs.reshape(T, n, xs.shape[-1])
        carry0 = self.init_carry((n,), x.dtype, x.device)
        _, out = self._run(self.cell, carry0, xs)
        if self.bi_dir:
            _, out_b = self._run(self.cell_bwd, carry0, xs.flip(0))
            out = torch.cat([out, out_b.flip(0)], dim=-1)
        out = out.reshape((T,) + lead + (out.shape[-1],))
        return torch.movedim(out, 0, time_axis)
