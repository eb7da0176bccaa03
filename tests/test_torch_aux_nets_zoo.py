"""Port parity of the auxiliary model zoo (kinpoly_tpu_torch.models.aux_nets)
against kinpoly_tpu.models.aux_nets, float64 on the CPU, with flax-
initialised weights carried across by ``weights.<net>_from_jax``: every
net's forward pass; with ``train=True`` the BatchNorm nets' outputs and
their updated statistics; ``categorical_log_prob`` exactly and
``categorical_sample`` by its frequencies; ``SpaceNet``'s sampled z by its
moments. Tolerance 1e-10. The BatchNorm scales, biases and statistics are
seeded away from flax's (1, 0, 0, 1) so that they count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.models import aux_nets as jax_nets
from kinpoly_tpu_torch.models import aux_nets, weights

torch.set_num_threads(1)

TOL = 1e-10


def f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def seeded_bn(variables, seed=0):
    """BatchNorm scale/bias and running mean/var drawn from a seed."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        key = path[-1].key
        if key == "var":
            return rng.uniform(0.5, 1.5, x.shape)
        if key == "mean" or (key in ("scale", "bias") and
                             any("BatchNorm" in str(p.key) for p in path)):
            return (1.0 if key == "scale" else 0.0) + 0.2 * rng.randn(*x.shape)
        return x
    return jax.tree_util.tree_map_with_path(draw, variables)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


def _torch_stats(net):
    """running_mean / running_var of every BatchNorm in module order."""
    out = []
    for m in net.modules():
        if isinstance(m, aux_nets.BatchNorm):
            out.append((m.running_mean.detach().numpy(), m.running_var.detach().numpy()))
    return out


def _flax_stats(variables):
    """(mean, var) per BatchNorm in flax's module order (depth-first by
    creation, as the torch module order)."""
    out = []

    def walk(d):
        names = sorted(d, key=lambda k: (k.rsplit("_", 1)[0], int(k.rsplit("_", 1)[1]))
                       if k.rsplit("_", 1)[-1].isdigit() else (k, 0))
        for k in names:
            v = d[k]
            if "mean" in v:
                out.append((np.asarray(v["mean"]), np.asarray(v["var"])))
            else:
                walk(v)
    walk(variables["batch_stats"])
    return out


# (name, flax module, port module, converter, input shape, apply kwargs)
def _cases():
    return {
        "dw_block": (jax_nets.DWBlock(12, 2), aux_nets.DWBlock(8, 12, 2),
                     weights.dw_block_from_jax, (2, 9, 9, 8)),
        "mobile_net": (jax_nets.MobileNet(10), aux_nets.MobileNet(3, 10),
                       weights.mobile_net_from_jax, (2, 16, 16, 3)),
        "resnet18": (jax_nets.ResNet18(10), aux_nets.ResNet18(3, 10),
                     weights.resnet18_from_jax, (2, 64, 64, 3)),
        "video_reg_net": (jax_nets.VideoRegNet(7, cnn_fdim=16, hidden=12),
                          aux_nets.VideoRegNet(3, 7, cnn_fdim=16, hidden=12),
                          weights.video_reg_net_from_jax, (2, 3, 16, 16, 3)),
    }


def _run_port(name, tnet, x, train):
    if name == "dw_block":      # channels-first inside the encoders
        return tnet(x.permute(0, 3, 1, 2), train).permute(0, 2, 3, 1)
    return tnet(x, train)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["dw_block", "mobile_net", "resnet18", "video_reg_net"])
def test_batchnorm_nets_match_jax(name, train):
    jnet, tnet, conv, shape = _cases()[name]
    x = np.random.RandomState(1).randn(*shape)
    variables = seeded_bn(f64(jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x))))
    tnet = tnet.double()
    tnet.load_state_dict(conv(variables))
    if train:
        want, upd = jax.jit(lambda v, x: jnet.apply(v, x, train=True,
                                                    mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    else:
        want = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    _close(want, _run_port(name, tnet, torch.tensor(x), train))
    if train:
        got_stats = _torch_stats(tnet)
        want_stats = _flax_stats(upd)
        assert len(got_stats) == len(want_stats) > 0
        for (gm, gv), (wm, wv) in zip(got_stats, want_stats):
            np.testing.assert_allclose(gm, wm, rtol=0, atol=TOL)
            np.testing.assert_allclose(gv, wv, rtol=0, atol=TOL)


def _plain_cases():
    return {
        "simple_cnn": (jax_nets.SimpleCNN(9), aux_nets.SimpleCNN(3, 9),
                       weights.simple_cnn_from_jax, (2, 13, 13, 3), {}),
        "tcn": (jax_nets.TCN(channels=(8, 6, 5), kernel=3, out_dim=4),
                aux_nets.TCN(7, channels=(8, 6, 5), kernel=3, out_dim=4),
                weights.tcn_from_jax, (2, 11, 7), {}),
        "erd_net": (jax_nets.ERDNet(5, hidden=12), aux_nets.ERDNet(7, 5, hidden=12),
                    weights.erd_net_from_jax, (2, 6, 7), {}),
        "erd_net_time0": (jax_nets.ERDNet(5, hidden=12), aux_nets.ERDNet(7, 5, hidden=12),
                          weights.erd_net_from_jax, (6, 2, 7), {"time_axis": 0}),
        "cmlp": (jax_nets.CMLP(5, window=4, hidden=(16, 8)),
                 aux_nets.CMLP(7, 5, window=4, hidden=(16, 8)),
                 weights.cmlp_from_jax, (2, 6, 7), {}),
        "discriminator": (jax_nets.Discriminator(hidden=(16, 8)),
                          aux_nets.Discriminator(7, hidden=(16, 8)),
                          weights.discriminator_from_jax, (3, 5, 7), {}),
        "video_state_net": (jax_nets.VideoStateNet(6, hidden=10),
                            aux_nets.VideoStateNet(7, 6, hidden=10),
                            weights.video_state_net_from_jax, (2, 5, 7), {}),
        "video_forecast_net": (jax_nets.VideoForecastNet(6, hidden=10, horizon=4),
                               aux_nets.VideoForecastNet(7, 6, hidden=10, horizon=4),
                               weights.video_forecast_net_from_jax, (2, 5, 7), {}),
        "policy_discrete": (jax_nets.PolicyDiscrete(4, hidden=(16, 8)),
                            aux_nets.PolicyDiscrete(7, 4, hidden=(16, 8)),
                            weights.policy_discrete_from_jax, (5, 7), {}),
    }


@pytest.mark.parametrize("name", sorted(_plain_cases()))
def test_plain_nets_match_jax(name):
    jnet, tnet, conv, shape, kw = _plain_cases()[name]
    x = np.random.RandomState(2).randn(*shape)
    variables = f64(jax.jit(lambda k, x: jnet.init(k, x, **kw))(
        jax.random.PRNGKey(3), jnp.asarray(x)))
    tnet = tnet.double()
    tnet.load_state_dict(conv(variables))
    want = jax.jit(lambda v, x: jnet.apply(v, x, **kw))(variables, jnp.asarray(x))
    _close(want, tnet(torch.tensor(x), **kw))


def test_space_net_matches_jax():
    jnet = jax_nets.SpaceNet(latent_dim=8)
    tnet = aux_nets.SpaceNet(latent_dim=8, voxel_num=16).double()
    vox = (np.random.RandomState(4).rand(2, 16, 16, 16, 1) < 0.3).astype(np.float64)
    variables = f64(jax.jit(jnet.init)(jax.random.PRNGKey(5), jnp.asarray(vox)))
    # flax's zero biases would hide a misplaced bias: seed them
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.1 * np.random.RandomState(len(str(p))).randn(*x.shape)
        if p[-1].key == "bias" else x, variables)
    tnet.load_state_dict(weights.space_net_from_jax(variables))
    want = jax.jit(jnet.apply)(variables, jnp.asarray(vox))
    got = tnet(torch.tensor(vox))
    for a, b in zip(want, got):
        _close(a, b)


def test_space_net_draw_has_the_moments_of_its_gaussian():
    tnet = aux_nets.SpaceNet(latent_dim=8, voxel_num=8).double()
    aux_nets.init_flax_(tnet, torch.Generator().manual_seed(0))
    vox = torch.tensor((np.random.RandomState(6).rand(4096, 8, 8, 8, 1) < 0.3)
                       .astype(np.float64))
    with torch.no_grad():
        _, mu, logvar = tnet(vox)
        tnet.dec_in.register_forward_hook(lambda m, i, o: zs.append(i[0]))
        zs = []
        tnet(vox, generator=torch.Generator().manual_seed(1))
        assert torch.equal(tnet(vox)[1], mu)          # no generator: z = mu
    eps = ((zs[0] - mu) / torch.exp(0.5 * logvar)).numpy()
    assert abs(eps.mean()) < 0.01
    assert abs(eps.std() - 1.0) < 0.01


def test_categorical_log_prob_exact_and_sample_frequencies():
    rng = np.random.RandomState(7)
    logits = rng.randn(3, 5)
    action = rng.randint(0, 5, (3,))
    want = jax_nets.categorical_log_prob(jnp.asarray(action), jnp.asarray(logits))
    got = aux_nets.categorical_log_prob(torch.tensor(action), torch.tensor(logits))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())

    n = 200_000
    draws = aux_nets.categorical_sample(
        torch.Generator().manual_seed(8), torch.tensor(logits)[:, None].expand(3, n, 5))
    freq = np.stack([np.bincount(d, minlength=5) / n for d in draws.numpy()])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    # a binomial frequency's standard deviation is at most 0.5 / sqrt(n)
    assert np.abs(freq - probs).max() < 5 * 0.5 / np.sqrt(n)
    jdraws = np.asarray(jax_nets.categorical_sample(
        jax.random.PRNGKey(9), jnp.broadcast_to(jnp.asarray(logits)[:, None], (3, n, 5))))
    jfreq = np.stack([np.bincount(d, minlength=5) / n for d in jdraws])
    assert np.abs(freq - jfreq).max() < 10 * 0.5 / np.sqrt(n)


def test_init_flax_fills_every_parameter():
    g = torch.Generator().manual_seed(0)
    for net in (aux_nets.MobileNet(3, 8), aux_nets.TCN(4), aux_nets.ERDNet(4, 3, 8),
                aux_nets.SpaceNet(8), aux_nets.VideoForecastNet(4, 3, 8, 2)):
        aux_nets.init_flax_(net, g)
        for name, p in net.named_parameters():
            assert torch.isfinite(p).all(), name
            if name.endswith("weight") or "weight_" in name:
                assert p.abs().max() > 0, name
