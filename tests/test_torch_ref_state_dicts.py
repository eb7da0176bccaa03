"""Port parity of the reference state-dict loader (kinpoly_tpu_torch.models.
torch_import) against kinpoly_tpu.models.torch_import plus flax, float64 on
the CPU: seeded state dicts in the reference's layouts (uhc/khrylib MLP
``affine_layers``, PolicyGaussian ``action_mean``, Value ``value_head``,
PolicyMCP ``primitives.{p}`` and ``composer``, a torch GRU cell with both
bias vectors) go through both importers; the port's modules and the flax
modules give the same outputs within 1e-10, and so does the reference torch
module the state dict came from.

(tests/test_torch_import.py is the JAX package's own test of its importer.)"""

import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch
from torch import nn

from kinpoly_tpu.models import nets as jnets
from kinpoly_tpu.models import torch_import as jti
from kinpoly_tpu_torch.models import nets as tnets
from kinpoly_tpu_torch.models import torch_import as tti
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.models.rnn import RNN

torch.set_num_threads(1)

TOL = 1e-10
IN, A, HID = 10, 4, (32, 16)


class RefMLP(nn.Module):
    """uhc/khrylib/models/mlp.py."""

    def __init__(self, in_dim, hidden):
        super().__init__()
        self.affine_layers = nn.ModuleList()
        last = in_dim
        for h in hidden:
            self.affine_layers.append(nn.Linear(last, h))
            last = h

    def forward(self, x):
        for layer in self.affine_layers:
            x = torch.relu(layer(x))
        return x


class RefPolicyGaussian(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = RefMLP(IN, HID)
        self.action_mean = nn.Linear(HID[-1], A)

    def forward(self, x):
        return self.action_mean(self.net(x))


class RefValue(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = RefMLP(IN, HID)
        self.value_head = nn.Linear(HID[-1], 1)

    def forward(self, x):
        return self.value_head(self.net(x))[..., 0]


class RefHead(nn.Module):
    def __init__(self, hidden, out):
        super().__init__()
        self.net = RefMLP(IN, hidden)
        self.head = nn.Linear(hidden[-1], out)


class RefPolicyMCP(nn.Module):
    """uhc/core/policy_mcp.py: P primitive MLPs with linear heads, a
    softmax composer, the mean the weighted sum of the primitives'."""

    def __init__(self, P, comp_hidden=(24, 12)):
        super().__init__()
        self.primitives = nn.ModuleList(RefHead(HID, A) for _ in range(P))
        self.composer = RefHead(comp_hidden, P)

    def forward(self, x):
        mus = torch.stack([p.head(p.net(x)) for p in self.primitives], dim=-2)
        w = torch.softmax(self.composer.head(self.composer.net(x)), dim=-1)
        return torch.einsum("...p,...pa->...a", w, mus)


def seeded(module, seed):
    """The module in float64 with every parameter drawn from numpy."""
    rng = np.random.RandomState(seed)
    module = module.double()
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.tensor(rng.randn(*p.shape) * 0.3))
    return module, {k: v.numpy().copy() for k, v in module.state_dict().items()}


def f64(tree):
    import jax
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


def _x(seed, n=7):
    return np.random.RandomState(seed).randn(n, IN)


def test_policy_gaussian_matches_jax_and_reference():
    ref, sd = seeded(RefPolicyGaussian(), 0)
    x = _x(1)
    want, _ = jnets.PolicyGaussian(A, hidden=HID).apply(
        f64(jti.import_policy_gaussian(sd)), jnp.asarray(x))
    port = tnets.PolicyGaussian(IN, A, HID).double()
    port.load_state_dict(tti.import_policy_gaussian(sd))
    got, log_std = port(torch.tensor(x))
    _close(want, got)
    assert torch.all(log_std == -2.3)
    assert tti.verify_same_output(port, ref, torch.tensor(x), atol=TOL) < TOL


def test_value_matches_jax_and_reference():
    ref, sd = seeded(RefValue(), 2)
    x = _x(3)
    want = jnets.Value(hidden=HID).apply(f64(jti.import_value(sd)), jnp.asarray(x))
    port = tnets.Value(IN, HID).double()
    port.load_state_dict(tti.import_value(sd))
    _close(want, port(torch.tensor(x)))
    assert tti.verify_same_output(port, ref, torch.tensor(x), atol=TOL) < TOL


def _flax_mcp_params(tree, P, n_hidden):
    """The JAX importer's per-primitive MLP_{p}/Dense_{p} stacked into the
    flax PolicyMCP's primitive bank (its composer is MLP_P/Dense_P)."""
    p = tree["params"]
    bank = {}
    layers = [(f"MLP_{{}}", f"Dense_{i}") for i in range(n_hidden)] + [("Dense_{}", None)]
    for mlp, dense in layers:
        ks = [p[mlp.format(q)][dense] if dense else p[mlp.format(q)] for q in range(P)]
        w = np.stack([np.asarray(k["kernel"]) for k in ks])
        b = np.stack([np.asarray(k["bias"]) for k in ks])
        bank[f"w_{w.shape[2]}_{w.shape[1]}"] = w
        bank[f"b_{w.shape[2]}_{w.shape[1]}"] = b
    return {"params": {"_PrimitiveBank_0": bank, "MLP_0": p[f"MLP_{P}"],
                       "Dense_0": p[f"Dense_{P}"]}}


@pytest.mark.parametrize("P", [1, 3])
def test_policy_mcp_matches_jax_and_reference(P):
    ref, sd = seeded(RefPolicyMCP(P), 4 + P)
    x = _x(5)
    tree = jti.import_policy_mcp(sd, num_primitive=P)
    flax_mcp = jnets.PolicyMCP(A, num_primitive=P, hidden=HID, composer_hidden=(24, 12))
    want, _ = flax_mcp.apply(f64(_flax_mcp_params(tree, P, 2)), jnp.asarray(x))
    port = tnets.PolicyMCP(IN, A, P, HID, (24, 12)).double()
    port.load_state_dict(tti.import_policy_mcp(sd, num_primitive=P))
    _close(want, port(torch.tensor(x))[0])
    assert tti.verify_same_output(port, ref, torch.tensor(x), atol=TOL) < TOL


def test_gru_cell_matches_jax_and_reference():
    ref, sd = seeded(nn.GRUCell(IN, 6), 9)
    keys = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
    rng = np.random.RandomState(10)
    x, h = rng.randn(5, IN), rng.randn(5, 6)
    want, _ = fnn.GRUCell(features=6).apply(
        {"params": f64(jti.import_gru_cell(sd, *keys))}, jnp.asarray(h), jnp.asarray(x))
    port = nn.GRUCell(IN, 6).double()
    psd = tti.import_gru_cell(sd, *keys)
    port.load_state_dict(psd)
    got = port(torch.tensor(x), torch.tensor(h))
    _close(want, got)
    with torch.no_grad():
        _close(ref(torch.tensor(x), torch.tensor(h)).numpy(), got)
    # flax's layout: no r/z hidden bias, so the flax round trip accepts it
    assert torch.all(psd["bias_hh"][:12] == 0)
    weights._flax_gru({f"g.{k}": v for k, v in psd.items()}, "g")
    # the same weights as the one-layer GRU of rnn.RNN
    rnn = RNN(IN, 6, "gru").double()
    rnn.load_state_dict(tti.import_gru_cell(sd, *keys, dst="cell.", suffix="_l0"))
    _, out = rnn.step(torch.tensor(h), torch.tensor(x))
    _close(want, out)


def test_gru_cell_without_biases_and_verify_refuses_a_difference():
    ref, sd = seeded(nn.GRUCell(IN, 6, bias=False), 11)
    port = nn.GRUCell(IN, 6).double()
    port.load_state_dict(tti.import_gru_cell(sd, "weight_ih", "weight_hh"))
    x = torch.tensor(_x(12, 3))
    assert tti.verify_same_output(port, ref, x, atol=TOL) < TOL
    with torch.no_grad():
        port.bias_ih[12] += 1.0       # the n gate (h = 0 hides r)
    with pytest.raises(AssertionError):
        tti.verify_same_output(port, ref, x, atol=TOL)
