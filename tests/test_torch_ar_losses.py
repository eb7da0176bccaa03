"""Port parity: the kinematic policy's training side, kinpoly_tpu_torch
against kinpoly_tpu, float64 on the CPU, at small widths with fresh flax
parameters carried over by ``weights.trajar_from_jax``: the three
supervised losses with their gradients (``jax.grad``), TrajARNet's training
forward (scheduled sampling at gt_rate 0 and 1), the full-AR loss's
parameter gradient read back through the flax writer
(``weights.trajar_to_jax``), the observation noise's statistics, the step
GRU's re-run over a rollout with episode resets, the per-step BC loss and
its gradient, and the dead-PPO property (a mean-action rollout gives the
surrogate a zero gradient, a sampled one does not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.models import nets as jnets
from kinpoly_tpu.models import policy_ar as jpa
from kinpoly_tpu.models import traj_ar as jta
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.models import nets as tnets
from kinpoly_tpu_torch.models import policy_ar as tpa
from kinpoly_tpu_torch.models import traj_ar as tta
from kinpoly_tpu_torch.models import weights

from test_torch_objects import jax_spec
from test_torch_traj_ar import jclip, tclip, wild_clips

torch.set_num_threads(1)

TOL = 1e-9           # float64 losses, rollouts and gradients at small widths
SMALL = dict(rnn_hdim=16, mlp_hsize=(24, 12), add_noise=False)


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    scale = max(1.0, float(np.abs(a).max()))
    assert err <= tol * scale, (err, scale)


def _close_tree(jtree, sd_grads):
    """A flax gradient tree against the port's gradients written as one."""
    ttree = weights.trajar_to_jax(sd_grads)
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = dict(jax.tree_util.tree_leaves_with_path(ttree))
    assert len(jl) == len(tl)
    for path, x in jl:
        _close(x, tl[path])


@pytest.fixture(scope="module")
def setup():
    spec = sp.synthetic_spec(0, with_objects=True)
    jspec = jax_spec(spec)
    st = sp.spec_tensors(spec, torch.float64, "cpu")
    clip = wild_clips(spec, 3, 8)
    jcfg, tcfg = jta.TrajARConfig(**SMALL), tta.TrajARConfig(**SMALL)
    jp = jpa.PolicyAR(jspec, jcfg)
    params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax.jit(jp.init_params)(jax.random.PRNGKey(0),
                                                  jclip(clip)))
    tp = tpa.PolicyAR(spec, st, tcfg)
    tp.net.load_state_dict(weights.trajar_from_jax(params))
    tp.net.double()
    return dict(spec=spec, jspec=jspec, st=st, clip=clip, jcfg=jcfg,
                tcfg=tcfg, jp=jp, tp=tp, params=params)


def _grads(net):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
            for n, p in net.named_parameters()}


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_iden_loss():
    rng = np.random.RandomState(0)
    a, b = _quats(rng, (7,)), _quats(rng, (7,))
    a[0] = b[0]                                   # an exact match
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta = torch.tensor(a, requires_grad=True)
    _close(jta._quat_iden_loss(ja, jb), tta._quat_iden_loss(ta, torch.tensor(b)))
    g = jax.grad(lambda x: jta._quat_iden_loss(x, jb).sum())(ja)
    tta._quat_iden_loss(ta, torch.tensor(b)).sum().backward()
    _close(g, ta.grad)


def test_compute_loss(setup):
    """The full-rollout loss of perturbed features: value, every term, and
    its gradient with respect to each feature."""
    s = setup
    rng = np.random.RandomState(1)
    c = s["clip"]
    B, T = c.qpos.shape[:2]
    feats = dict(qpos=c.qpos + rng.normal(0, 0.05, c.qpos.shape),
                 qvel=c.qvel + rng.normal(0, 0.3, c.qvel.shape),
                 pred_wbpos=c.wbpos + rng.normal(0, 0.02, c.wbpos.shape),
                 obj_2_head=np.concatenate(
                     [rng.normal(size=(B, T, 3)), _quats(rng, (B, T))], -1))
    feats["qpos"][..., 3:7] = _quats(rng, (B, T))

    def jloss(f):
        return jta.compute_loss(s["jcfg"], f, jclip(c))
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    (lj, ij), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jf)
    tf = {k: torch.tensor(v, requires_grad=True) for k, v in feats.items()}
    lt, it = tta.compute_loss(s["tcfg"], tf, tclip(c))
    lt.backward()
    _close(lj, lt)
    assert sorted(ij) == sorted(it)
    for k in ij:
        _close(ij[k], it[k])
    for k in gj:
        _close(gj[k], tf[k].grad)


@pytest.mark.parametrize("fn", ["lite", "lite_per_frame", "init"])
def test_compute_loss_lite_and_init(setup, fn):
    """Per-frame qpos supervision (through FK) and the initial-state loss,
    which takes velocities and ignores them: value, terms and the gradient
    with respect to the predicted qpos."""
    s = setup
    rng = np.random.RandomState(2)
    gt = s["clip"].qpos[:, :4]
    pred = gt + rng.normal(0, 0.05, gt.shape)
    pred[..., 3:7] = _quats(rng, gt.shape[:2])
    qv = rng.normal(size=gt.shape[:-1] + (75,))

    def jf(p):
        if fn == "init":
            return jta.compute_loss_init(s["jspec"], s["jcfg"], p,
                                         jnp.asarray(gt), jnp.asarray(qv),
                                         jnp.asarray(qv) * 2)
        loss, info = jta.compute_loss_lite(s["jspec"], s["jcfg"], p,
                                           jnp.asarray(gt),
                                           reduce_mean=fn == "lite")
        return loss.sum(), (info, loss)

    def tf(p):
        if fn == "init":
            return tta.compute_loss_init(s["st"], s["tcfg"], p,
                                         torch.tensor(gt), torch.tensor(qv),
                                         torch.tensor(qv) * 2)
        loss, info = tta.compute_loss_lite(s["st"], s["tcfg"], p,
                                           torch.tensor(gt),
                                           reduce_mean=fn == "lite")
        return loss.sum(), (info, loss)

    (lj, auxj), gj = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    lt, auxt = tf(tp)
    lt.backward()
    _close(lj, lt)
    _close(gj, tp.grad)
    infoj, infot = (auxj, auxt) if fn == "init" else (auxj[0], auxt[0])
    for k in infoj:
        _close(infoj[k], infot[k])
    if fn == "lite_per_frame":
        _close(auxj[1], auxt[1])


@pytest.mark.parametrize("gt_rate", [0.0, 1.0])
def test_training_forward(setup, gt_rate):
    """TrajARNet in training (train=True, the config's noise off) at
    gt_rate 0 (open loop) and 1 (every state the data's): every feature
    and the actions."""
    s = setup
    fj = jax.jit(lambda p, c: s["jp"].net.apply(
        p, c, gt_rate, jax.random.PRNGKey(3), True))(s["params"],
                                                     jclip(s["clip"]))
    with torch.no_grad():
        ft = s["tp"].net(tclip(s["clip"]), gt_rate,
                         torch.Generator().manual_seed(3), train=True)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        _close(fj[k], ft[k])
    if gt_rate == 1.0:
        _close(s["clip"].qpos, ft["qpos"])


def test_full_ar_loss_parameter_gradient(setup):
    """The warm start's full-AR loss (open loop, gt_rate 0): its value and
    its gradient over every parameter, the port's written as a flax tree;
    the r and z hidden-bias gradients are exactly 0."""
    s = setup
    gt_rate = 0.0

    def jloss(p):
        feats = s["jp"].net.apply(p, jclip(s["clip"]), gt_rate,
                                  jax.random.PRNGKey(4), True)
        return jta.compute_loss(s["jcfg"], feats, jclip(s["clip"]))[0]

    lj, gj = jax.jit(jax.value_and_grad(jloss))(s["params"])
    net = s["tp"].net
    net.zero_grad()
    batch = tclip(s["clip"])
    lt = tta.compute_loss(s["tcfg"], net(batch, gt_rate, None, train=True),
                          batch)[0]
    lt.backward()
    _close(lj, lt)
    grads = _grads(net)
    H = SMALL["rnn_hdim"]
    for n in ("context_gru.bias_hh_l0", "action_gru.bias_hh"):
        assert bool((grads[n][:2 * H] == 0).all())
        assert float(grads[n][2 * H:].abs().max()) > 0
    _close_tree(gj, grads)


def test_observation_noise(setup):
    """With a generator, ``ar_obs`` adds N(0, noise_std²) to the target
    head rotation, position, angular and linear velocity and the
    object-to-head pose, and to nothing else; the training forward with
    the config's add_noise draws it, the same for the same seed."""
    s = setup
    spec, st = s["spec"], s["st"]
    cfg = tta.TrajARConfig(**{**SMALL, "add_noise": True, "noise_std": 0.02})
    rng = np.random.RandomState(5)
    n = 20000
    c = s["clip"]
    idx = rng.randint(0, c.qpos.shape[0], n), rng.randint(0, c.qpos.shape[1], n)
    args = [torch.tensor(x[idx]) for x in (
        c.qpos, c.qvel, c.head_pose, c.head_vels, c.obj_pose,
        c.obj_head_relative_poses, c.action_one_hot)]
    clean = tta.ar_obs(spec, st, cfg, *args, as_policy=True)[0]
    noisy = tta.ar_obs(spec, st, cfg, *args, as_policy=True,
                       noise=torch.Generator().manual_seed(0))[0]
    d = (noisy - clean).numpy()
    # layout: qpos_local[2:] 74 | diff head pos 3 | diff head rot 4 |
    # pred obj-rel-head 7 | head angvel 3 | head linvel 3 | obj-rel-head 7 | 4
    direct = slice(88, 101)
    assert np.abs(d[:, :74]).max() == 0 and np.abs(d[:, 81:88]).max() == 0
    assert np.abs(d[:, 101:]).max() == 0
    std = d[:, direct].std(axis=0)
    assert np.all(np.abs(std / 0.02 - 1) < 0.03), std
    assert np.all(np.abs(d[:, direct].mean(axis=0)) < 4 * 0.02 / np.sqrt(n))
    # the head position and rotation noise reaches the diff terms
    assert np.abs(d[:, 74:81]).min(axis=0).max() > 0
    net = tta.TrajARNet(spec, st, cfg, as_policy=True)
    net.load_state_dict(s["tp"].net.state_dict())
    net.double()
    batch = tclip(c)
    with torch.no_grad():
        a = net(batch, 0.0, torch.Generator().manual_seed(1), train=True)
        b = net(batch, 0.0, torch.Generator().manual_seed(1), train=True)
        e = net(batch, 0.0, torch.Generator().manual_seed(1), train=False)
    assert torch.equal(a["qpos"], b["qpos"])
    assert not torch.equal(a["qpos"], e["qpos"])
    _close(e["qpos"], s["tp"].net(batch)["qpos"])


def _rollout_grid(setup, T=6, N=3, seed=6):
    rng = np.random.RandomState(seed)
    d = tta.obs_dim(setup["tcfg"], True)
    obs = rng.normal(size=(T, N, d))
    masks = np.ones((T, N))
    masks[1, 0] = masks[3, 2] = masks[4, 0] = 0.0
    prev = np.concatenate([np.ones((1, N)), masks[:-1]])
    c = setup["clip"]
    curr = c.qpos[:, :T].transpose(1, 0, 2)[:, :N]
    gt = c.qpos[:, 1:T + 1].transpose(1, 0, 2)[:, :N]
    return obs, prev, curr, gt


def test_action_means_over_time(setup):
    """The step GRU re-run over a (T, N) grid whose carry resets where the
    previous step ended an episode, against the JAX scan."""
    s = setup
    obs, prev, _, _ = _rollout_grid(s)
    mj = jax.jit(s["jp"].action_means_over_time)(
        s["params"], jnp.asarray(obs), jnp.asarray(prev))
    with torch.no_grad():
        mt = s["tp"].action_means_over_time(torch.tensor(obs),
                                            torch.tensor(prev))
    _close(mj, mt)
    # a reset really restarts the carry: env 0 at step 2 (prev mask 0)
    # equals a fresh GRU step on that observation
    with torch.no_grad():
        fresh = s["tp"].action_mean(s["tp"].init_carry(1, mt),
                                    torch.tensor(obs[2, :1]))[1]
    _close(fresh.numpy(), mt[2, :1])


def test_step_update_loss(setup):
    """The per-step BC loss (with and without valid masks) and its
    gradient over every parameter."""
    s = setup
    obs, prev, curr, gt = _rollout_grid(s)
    valid = (np.random.RandomState(7).uniform(size=prev.shape) > 0.3) * 1.0
    for mv in (None, valid):
        def jloss(p):
            return s["jp"].step_update_loss(
                p, jnp.asarray(obs), jnp.asarray(prev), jnp.asarray(curr),
                jnp.asarray(gt),
                masks_valid=None if mv is None else jnp.asarray(mv))
        (lj, ij), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            s["params"])
        net = s["tp"].net
        net.zero_grad()
        lt, it = s["tp"].step_update_loss(
            torch.tensor(obs), torch.tensor(prev), torch.tensor(curr),
            torch.tensor(gt), masks_valid=None if mv is None else torch.tensor(mv))
        lt.backward()
        _close(lj, lt)
        for k in ij:
            _close(ij[k], it[k])
        grads = _grads(net)
        assert float(grads["context_gru.weight_ih_l0"].abs().max()) == 0.0
        _close_tree(gj, grads)


def test_flax_writer_round_trip(setup):
    """trajar_to_jax inverts trajar_from_jax leaf for leaf, and refuses a
    non-zero r or z hidden bias."""
    s = setup
    back = weights.trajar_to_jax(s["tp"].net.state_dict())
    jl = jax.tree_util.tree_leaves_with_path(s["params"])
    tl = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(jl) == len(tl)
    for path, x in jl:
        np.testing.assert_array_equal(np.asarray(x), tl[path])
    sd = {k: v.clone() for k, v in s["tp"].net.state_dict().items()}
    sd["action_gru.bias_hh"][0] = 1e-3
    with pytest.raises(ValueError, match="hidden bias"):
        weights.trajar_to_jax(sd)


def test_dead_ppo_iff_mean_action(setup):
    """The surrogate's gradient over a re-run is exactly zero when the
    rollout's actions are the means (d log p / d mean = 0 at a = mean),
    and not when they are samples of the Gaussian."""
    s = setup
    tp = s["tp"]
    obs, prev, _, _ = _rollout_grid(s)
    obs, prev = torch.tensor(obs), torch.tensor(prev)
    T, N = prev.shape
    adv = torch.tensor(np.random.RandomState(8).normal(size=T * N))
    with torch.no_grad():
        means = tp.action_means_over_time(obs, prev).reshape(T * N, -1)
    log_std = torch.full_like(means, tp.log_std)

    def grad_norm(actions):
        tp.net.zero_grad()
        m = tp.action_means_over_time(obs, prev).reshape(T * N, -1)
        ratio = torch.exp(tnets.gaussian_log_prob(actions, m, log_std)
                          - tnets.gaussian_log_prob(actions, means, log_std))
        surr = -torch.mean(torch.minimum(ratio * adv,
                                         torch.clamp(ratio, 0.8, 1.2) * adv))
        surr.backward()
        return sum(float(p.grad.abs().sum()) for p in tp.net.parameters()
                   if p.grad is not None)

    assert grad_norm(means) == 0.0
    noise = torch.exp(log_std) * torch.randn(
        means.shape, generator=torch.Generator().manual_seed(9),
        dtype=means.dtype)
    assert grad_norm(means + noise) > 0.0
    # the JAX density the port's log-prob stands for
    _close(jnets.gaussian_log_prob(jnp.asarray(means + noise),
                                   jnp.asarray(means), jnp.asarray(log_std)),
           tnets.gaussian_log_prob(means + noise, means, log_std))
