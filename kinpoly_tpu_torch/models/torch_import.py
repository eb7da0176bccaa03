"""Load the reference's torch state dicts (``uhc/khrylib`` layouts) into the
port's own modules (port of ``kinpoly_tpu/models/torch_import.py``, which
maps them onto flax trees): each function returns a state dict of the port
module named in its docstring, so trained reference weights (UHC
PolicyGaussian or PolicyMCP with its Value, a GRU) evaluate here directly.

- A reference ``MLP`` (``affine_layers.{i}``) becomes ``nets.MLP``'s
  ``layers.{i}``; a torch Linear keeps its (out, in) layout.
- A reference ``PolicyMCP``'s primitives (``primitives.{p}.net.`` and
  ``.head``) are stacked in primitive order into ``nets.PrimitiveBank``'s
  (P, in, out) weights; its composer (``composer.net.``, ``composer.head``)
  becomes ``composer`` and ``composer_head``.
- A torch GRU's biases fold as the JAX importer folds them: b_hr + b_ir
  and b_hz + b_iz into the input biases, the hidden r and z biases 0,
  b_in and b_hn kept apart. So the cell is flax's, and
  ``weights.trajar_to_jax`` (which refuses a non-zero r or z hidden bias)
  still round-trips it.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return torch.from_numpy(np.array(x, copy=True))


def _lin(sd: dict, prefix: str, dst: str) -> dict:
    out = {f"{dst}.weight": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out[f"{dst}.bias"] = _t(sd[f"{prefix}.bias"])
    return out


def import_mlp(sd: dict, prefix: str, n_layers: int, dst: str = "mlp") -> dict:
    """Reference MLP (uhc/khrylib/models/mlp.py) ``{prefix}affine_layers.{i}``
    -> ``nets.MLP`` entries ``{dst}.layers.{i}``."""
    out = {}
    for i in range(n_layers):
        out.update(_lin(sd, f"{prefix}affine_layers.{i}", f"{dst}.layers.{i}"))
    return out


def import_gru_cell(sd: dict, w_ih_key: str, w_hh_key: str,
                    b_ih_key: str | None = None, b_hh_key: str | None = None,
                    dst: str = "", suffix: str = "") -> dict:
    """Torch GRU weights (gates (r, z, n)) -> a torch GRU cell with flax's
    biases: ``{dst}weight_ih{suffix}`` etc. (suffix "" for ``nn.GRUCell``,
    "_l0" for a one-layer ``nn.GRU`` as in ``rnn.RNN``). Without biases
    in `sd` the biases are 0."""
    w_ih = _t(sd[w_ih_key])
    w_hh = _t(sd[w_hh_key])
    H = w_ih.shape[0] // 3
    b_ih = torch.zeros(3 * H, dtype=w_ih.dtype)
    b_hh = torch.zeros(3 * H, dtype=w_ih.dtype)
    if b_ih_key and b_ih_key in sd:
        bi, bh = _t(sd[b_ih_key]), _t(sd[b_hh_key])
        b_ih[: 2 * H] = bi[: 2 * H] + bh[: 2 * H]
        b_ih[2 * H:] = bi[2 * H:]
        b_hh[2 * H:] = bh[2 * H:]
    return {f"{dst}weight_ih{suffix}": w_ih, f"{dst}weight_hh{suffix}": w_hh,
            f"{dst}bias_ih{suffix}": b_ih, f"{dst}bias_hh{suffix}": b_hh}


def import_policy_gaussian(sd: dict, n_hidden: int = 2) -> dict:
    """Reference PolicyGaussian (``net`` MLP + ``action_mean``) ->
    ``nets.PolicyGaussian`` with a fixed log-std."""
    out = import_mlp(sd, "net.", n_hidden)
    out.update(_lin(sd, "action_mean", "head"))
    return out


def import_value(sd: dict, n_hidden: int = 2) -> dict:
    """Reference Value (``net`` MLP + ``value_head``) -> ``nets.Value``."""
    out = import_mlp(sd, "net.", n_hidden)
    out.update(_lin(sd, "value_head", "head"))
    return out


def import_policy_mcp(sd: dict, num_primitive: int = 8, n_hidden: int = 2,
                      n_comp_hidden: int = 2) -> dict:
    """Reference PolicyMCP (uhc/core/policy_mcp.py; per-primitive MLPs and
    linear heads, a composer MLP and linear head) -> ``nets.PolicyMCP``
    with a fixed log-std: the primitives' layers stacked into the bank's
    (P, in, out) weights ``w_{out}_{in}`` and (P, out) biases."""
    out = {}
    layers = [f"net.affine_layers.{i}" for i in range(n_hidden)] + ["head"]
    for name in layers:
        w = torch.stack([_t(sd[f"primitives.{p}.{name}.weight"]).T
                         for p in range(num_primitive)])        # (P, in, out)
        b = torch.stack([_t(sd[f"primitives.{p}.{name}.bias"])
                         for p in range(num_primitive)])
        d_in, d_out = w.shape[1], w.shape[2]
        out[f"bank.w_{d_out}_{d_in}"] = w.contiguous()
        out[f"bank.b_{d_out}_{d_in}"] = b
    out.update(import_mlp(sd, "composer.net.", n_comp_hidden, "composer"))
    out.update(_lin(sd, "composer.head", "composer_head"))
    return out


@torch.no_grad()
def verify_same_output(module_a, module_b, x, atol: float = 1e-5) -> float:
    """max |a(x) - b(x)| of two torch modules (the first output of each
    where a module returns a tuple); asserts it is below `atol`."""
    x = torch.as_tensor(x)
    ya, yb = module_a(x), module_b(x)
    ya = ya[0] if isinstance(ya, tuple) else ya
    yb = yb[0] if isinstance(yb, tuple) else yb
    err = float((ya - yb).abs().max())
    assert err < atol, err
    return err
