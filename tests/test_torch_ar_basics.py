"""Port parity: the pieces of AR training that run no network or physics,
kinpoly_tpu_torch against kinpoly_tpu, float64 on the CPU: the liveness
guards (``grad_nonfinite_fraction`` over a TrajARNet's gradients counted in
flax leaves, ``check_supervised_liveness`` with its raising cases), the
named kinematic-policy configs against their YAMLs and the trainer config
they give, and the optimiser chains against optax on gradients with NaN
and inf entries."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kinpoly_tpu.config import config as jconfig
from kinpoly_tpu.utils import liveness as jlv
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import KinPolyConfig
from kinpoly_tpu_torch.models import traj_ar as tta
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.rl.optim import AdamChain
from kinpoly_tpu_torch.utils import liveness as tlv

torch.set_num_threads(1)

TOL = 1e-12          # the optimiser chain, float64, a few steps
SMALL = dict(rnn_hdim=8, mlp_hsize=(6,))


def _net():
    spec = sp.synthetic_spec(0, with_objects=True)
    net = tta.TrajARNet(spec, sp.spec_tensors(spec, torch.float64, "cpu"),
                        tta.TrajARConfig(**SMALL), as_policy=True)
    gen = torch.Generator().manual_seed(0)
    for p in net.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=p.dtype))
    # flax has no r/z hidden bias: zero, so that the flax writer takes it
    for m in (net.context_gru, net.action_gru):
        for n, p in m.named_parameters():
            if n.startswith("bias_hh"):
                with torch.no_grad():
                    p[: 2 * SMALL["rnn_hdim"]] = 0.0
    return net.double()


@pytest.mark.parametrize("poison", [
    (), (("action_gru.weight_hh", 0, np.nan),),
    (("context_gru.bias_hh_l0", 2 * SMALL["rnn_hdim"], np.inf),
     ("action_fc.bias", 1, -np.inf), ("context_mlp.layers.0.weight", 5, np.nan)),
    (("action_gru.weight_ih", -1, np.nan),)])
def test_grad_nonfinite_fraction(poison):
    """The same gradients as a flax tree (the writer's layout) and as
    torch tensors: the same fraction of leaves with a non-finite value,
    over TrajARNet's 10-leaf GRUs. A None gradient counts as a finite
    leaf."""
    net = _net()
    grads = {n: p.detach().clone() for n, p in net.named_parameters()}
    for name, i, v in poison:
        grads[name].view(-1)[i] = v
    jgrads = jax.tree.map(jnp.asarray, weights.trajar_to_jax(grads))
    n_leaves = len(jax.tree_util.tree_leaves(jgrads))
    assert n_leaves == sum(tlv.n_flax_leaves(n) for n in grads)
    assert n_leaves == 2 * 10 + 2 * (len(SMALL["mlp_hsize"]) * 2 + 2)
    want = float(jlv.grad_nonfinite_fraction(jgrads))
    got = tlv.grad_nonfinite_fraction(list(grads.items()))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, abs=1e-7)
    none = [(n, None if n.startswith("action_mlp") else g)
            for n, g in grads.items()]
    if not any(n.startswith("action_mlp") for n, _, _ in poison):
        assert float(tlv.grad_nonfinite_fraction(none)) == pytest.approx(
            want, abs=1e-7)


@pytest.mark.parametrize("case", [
    dict(losses=[5.0] * 9),                                   # too short
    dict(losses=[10.0] * 5 + [5.0] * 5),                      # dropped
    dict(losses=[0.5] * 10),                                  # converged
    dict(losses=[10.0] * 10),                                 # flat
    dict(losses=[10.0] * 10, nan_fracs=[0.5] * 10),           # flat and hot
    dict(losses=[10.0] * 10, nan_fracs=[0.01] * 10),          # flat, cold
    dict(losses=[10.0] * 5 + [np.nan] * 5),                   # diverged
    dict(losses=[10.0] * 5 + [9.5] * 5, min_drop=0.02, head=3),
])
def test_check_supervised_liveness(case):
    """The same verdict, and the same message when it raises."""
    def run(mod):
        try:
            mod.check_supervised_liveness(phase="train_init/full", **case)
        except mod.LivenessError as e:
            return str(e)
        return None
    want = run(jlv)
    assert run(tlv) == want
    assert tlv.NAN_FRAC_WARN == jlv.NAN_FRAC_WARN


@pytest.mark.parametrize("name", ["kin_poly", "kin_only", "kin_poly_wo_action"])
def test_kin_configs_match_yaml(name):
    """Every field of the named config as the YAML has it (a field the
    YAML lacks at the JAX config's default), the derived configs and the
    trainer config."""
    yml = jconfig.load_yaml(name)
    j, t = jconfig.KinPolyConfig(name, "out"), KinPolyConfig.named(name)
    names = {f.name for f in dataclasses.fields(t)} - {"name"}
    assert set(yml) <= names
    for k in names:
        assert getattr(t, k) == getattr(j, k), k
    for k, v in yml.items():
        assert getattr(t, k) == v, k
    assert t.name == j.id
    assert t.model_dir("out") == j.model_dir
    for a, b in ((t.traj_ar_config(), j.traj_ar_config()),
                 (t.reward_weights(), j.reward_weights())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    jt = dataclasses.asdict(j.train_config())
    tt = dataclasses.asdict(t.train_config())
    assert jt.pop("axis_name") is None
    assert tt == jt


def test_kin_config_unported_and_unknown():
    with pytest.raises(ValueError, match="policy_v 2"):
        KinPolyConfig.named("use_of")
    with pytest.raises(ValueError, match="optical-flow"):
        KinPolyConfig.named("use_of")
    with pytest.raises(ValueError, match="unknown"):
        KinPolyConfig.named("kin_nothing")
    assert KinPolyConfig.named("kin_poly") == KinPolyConfig()


CHAINS = {
    "sup": (dict(lr=5e-4, max_norm=40.0, zero_nans=True),
            lambda: optax.chain(optax.zero_nans(),
                                optax.clip_by_global_norm(40.0),
                                optax.adam(5e-4))),
    "pol": (dict(lr=1e-5, max_norm=40.0),
            lambda: optax.chain(optax.clip_by_global_norm(40.0),
                                optax.adam(1e-5))),
    "val": (dict(lr=3e-4), lambda: optax.adam(3e-4)),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("poison", ["none", "nan", "inf", "missing"])
def test_adam_chain_matches_optax(chain, poison):
    """Four steps of the port's chain and optax's on the same gradients:
    large ones (the clip acts), small ones, a NaN entry (zero_nans takes
    it where the chain has it), an inf entry (left in place; the clip's
    scale then makes NaN) and a missing gradient (a zero leaf that Adam's
    momentum still moves)."""
    kw, make = CHAINS[chain]
    rng = np.random.RandomState(1)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    p0 = [rng.normal(size=s) for s in shapes]
    tparams = [torch.tensor(x, requires_grad=True) for x in p0]
    opt = AdamChain(tparams, **kw)
    jparams = [jnp.asarray(x) for x in p0]
    jopt = make()
    state = jopt.init(jparams)
    for step in range(4):
        scale = 30.0 if step % 2 == 0 else 0.01
        gs = [rng.normal(size=s) * scale for s in shapes]
        if step == 2 and poison == "nan":
            gs[0][1, 2] = np.nan
        if step == 2 and poison == "inf":
            gs[1][3] = np.inf
        missing = poison == "missing" and step >= 1
        if missing:
            gs[2] = np.zeros(shapes[2])
        for p, g in zip(tparams, gs):
            p.grad = torch.tensor(g)
        if missing:
            tparams[2].grad = None
        opt.step()
        u, state = jopt.update([jnp.asarray(g) for g in gs], state, jparams)
        jparams = optax.apply_updates(jparams, u)
        for a, b in zip(jparams, tparams):
            a, b = np.asarray(a), b.detach().numpy()
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            ok = ~np.isnan(a)
            assert np.abs(a[ok] - b[ok]).max(initial=0.0) <= TOL
    assert opt.count == 4
    opt.reset()
    assert opt.count == 0 and opt.mu is None
