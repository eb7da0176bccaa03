"""Port parity of the recurrent module (kinpoly_tpu_torch.models.rnn.RNN)
against kinpoly_tpu.models.rnn.RNN, float64 on the CPU: GRU and LSTM cells,
batch mode over either time axis, one and two directions, step mode with
and without leading dims, with flax-initialised weights carried across by
``weights.rnn_from_jax``. Tolerance 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.models.rnn import RNN as JRNN
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.models.rnn import RNN

torch.set_num_threads(1)

TOL = 1e-10
IN, H = 6, 5


def f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def _pair(cell, bi_dir, seed=0):
    jnet = JRNN(H, cell, bi_dir=bi_dir)
    x = jnp.ones((2, 4, IN))
    variables = f64(jnet.init(jax.random.PRNGKey(seed), x))
    tnet = RNN(IN, H, cell, bi_dir=bi_dir).double()
    tnet.load_state_dict(weights.rnn_from_jax(variables))
    return jnet, variables, tnet


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("bi_dir", [False, True])
@pytest.mark.parametrize("time_axis", [0, 1])
def test_batch_mode_matches_jax(cell, bi_dir, time_axis):
    jnet, variables, tnet = _pair(cell, bi_dir)
    x = np.random.RandomState(1).randn(3, 7, IN)
    _close(jnet.apply(variables, jnp.asarray(x), time_axis),
           tnet(torch.tensor(x), time_axis))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_step_mode_matches_jax(cell, lead):
    jnet, variables, tnet = _pair(cell, False, seed=2)
    rng = np.random.RandomState(3)
    x = rng.randn(*lead, IN)
    if cell == "gru":
        carry = rng.randn(*lead, H)
        jc = jnp.asarray(carry)
        tc = torch.tensor(carry)
    else:
        c, h = rng.randn(*lead, H), rng.randn(*lead, H)
        jc = (jnp.asarray(c), jnp.asarray(h))
        tc = (torch.tensor(c), torch.tensor(h))
    (jcarry, jout) = jnet.apply(variables, jc, jnp.asarray(x), method="step")
    (tcarry, tout) = tnet.step(tc, torch.tensor(x))
    _close(jout, tout)
    if cell == "gru":
        _close(jcarry, tcarry)
    else:
        for a, b in zip(jcarry, tcarry):     # (c, h) in both
            _close(a, b)


def test_init_carry_layout():
    jnet, variables, tnet = _pair("lstm", False)
    jc = jnet.apply(variables, (2, 3), jnp.float64, method="init_carry")
    tc = tnet.init_carry((2, 3))
    assert len(jc) == len(tc) == 2
    for a, b in zip(jc, tc):
        _close(a, b)
    assert tuple(_pair("gru", False)[2].init_carry((4,)).shape) == (4, H)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_flax_bias_layout_survives_a_gradient_step(cell):
    """The biases flax does not have (GRU r/z hidden, LSTM input side) get
    no gradient, so an optimiser step keeps them at 0."""
    _, _, tnet = _pair(cell, True)
    x = torch.tensor(np.random.RandomState(4).randn(2, 5, IN))
    tnet(x).square().sum().backward()
    opt = torch.optim.SGD(tnet.parameters(), lr=0.1)
    opt.step()
    for c in (tnet.cell, tnet.cell_bwd):
        if cell == "gru":
            assert torch.all(c.bias_hh_l0[: 2 * H] == 0)
            assert torch.any(c.bias_hh_l0[2 * H:] != 0)
        else:
            assert torch.all(c.bias_ih_l0 == 0)
            assert torch.any(c.bias_hh_l0 != 0)
