"""Port parity: the kinematic policy under the use_of config,
kinpoly_tpu_torch against kinpoly_tpu, float64 on the CPU: TrajARNet with
the optical-flow features and the step context (``use_of``,
``use_context``: the context input and features, init_states, ar_obs as a
policy, obs_dim, the open-loop and the training rollout and its loss),
policy_v 2's residual head ``ActionDeltaNet`` and ``PolicyAR(policy_v=2)``
(action_mean, the re-run over a rollout with episode starts, the step-BC
loss and its gradient over {"arnet", "delta"}, init_context), the delta's
weights both ways and the liveness count over both trees
(``test_torch_use_of_iter0.py`` holds the tracked warm start at full
width).

Small widths use fresh flax parameters carried over by ``weights``; the
flow features are the wild bank's own."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.config import config as jconfig
from kinpoly_tpu.models import policy_ar as jpa
from kinpoly_tpu.models import traj_ar as jta
from kinpoly_tpu.utils import liveness as jlv
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import KinPolyConfig
from kinpoly_tpu_torch.data import statear as tsa
from kinpoly_tpu_torch.data.banks import read_bank
from kinpoly_tpu_torch.models import policy_ar as tpa
from kinpoly_tpu_torch.models import traj_ar as tta
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.utils import liveness as tlv

from test_torch_objects import jax_spec

torch.set_num_threads(1)

TOL = 1e-9           # float64 kinematics and small nets
ROOT = os.path.join(os.path.dirname(__file__), "..")
WILD_OF = os.path.join(ROOT, "data_bank", "wild_takes_r5_of.pkl")
SMALL = dict(rnn_hdim=16, mlp_hsize=(24, 12), add_noise=False)


def configs(**over):
    """use_of.yml's TrajAR config in both packages, `over` applied."""
    j = jconfig.KinPolyConfig("use_of").traj_ar_config()
    t = KinPolyConfig.named("use_of").traj_ar_config()
    return (type(j)(**{**j.__dict__, **over}),
            type(t)(**{**t.__dict__, **over}))


def of_clips(spec, n_takes, n_frames):
    """The first takes of the wild flow-feature bank in float64, cut to
    n_frames, with their `of` (numpy ClipData)."""
    raw = list(read_bank(WILD_OF).items())[:n_takes]
    takes = []
    for _, t in raw:
        take = tsa.derive_features(
            spec, t["qpos"][:n_frames].astype(np.float64),
            t["obj_pose"][:n_frames], t["action"],
            obj2_pose=t.get("table_pose"))
        take["of"] = t["of"][:n_frames].astype(np.float64)
        takes.append(take)
    ds = tsa.StateARDataset(takes, fr_num=n_frames)
    c = tsa.stack_clips([ds.whole_take(i, use_of=True)
                         for i in range(len(takes))])
    return type(c)(*(x.astype(np.float64) if x is not None
                     and x.dtype == np.float32 else x for x in c))


def jclip(c):
    return jta.ClipData(*(None if x is None else jnp.asarray(x) for x in c))


def tclip(c):
    return tsa.clip_tensors(c, torch.float64, "cpu")


def f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(a).max(initial=0.0))), err


@pytest.fixture(scope="module")
def nets():
    """Fresh flax PolicyAR(policy_v=2) params at small widths (the delta's
    output kernel given values), the same in the port, on 3 wild takes of
    9 frames."""
    spec = sp.synthetic_spec(0, with_objects=True)
    jspec, st = jax_spec(spec), sp.spec_tensors(spec, torch.float64, "cpu")
    jc, tc = configs(**SMALL)
    clip = of_clips(spec, 3, 9)
    jp = jpa.PolicyAR(jspec, jc, policy_v=2)
    params = f64(jp.init_params(jax.random.PRNGKey(0), jclip(clip)))
    fc = params["delta"]["params"]["fc"]
    assert not fc["kernel"].any()                 # zero-initialised
    fc["kernel"] = np.random.RandomState(5).normal(0, 0.05, fc["kernel"].shape)
    fc["bias"] = np.random.RandomState(6).normal(0, 0.05, fc["bias"].shape)
    tp = tpa.PolicyAR(spec, st, tc, policy_v=2).to(dtype=torch.float64)
    tp.net.load_state_dict(weights.trajar_from_jax(params["arnet"]))
    tp.delta_net.load_state_dict(weights.delta_from_jax(params["delta"]))
    return dict(spec=spec, jspec=jspec, st=st, jc=jc, tc=tc, clip=clip,
                jp=jp, tp=tp, params=params)


def test_dims(nets):
    """Context input 512 + 13 + 4; policy observation with the step
    context and the flow features; the delta's input and carry."""
    jc, tc, tp = nets["jc"], nets["tc"], nets["tp"]
    assert tc.context_dim == jc.context_dim == 529
    d = tta.obs_dim(tc, True)
    assert d == jta.obs_dim(jc, True) == 74 + 7 + 16 + 20 + 4 + 512
    assert tta.obs_dim(tc, False) == jta.obs_dim(jc, False) == d - 4 - 512
    assert tp.net.context_gru.input_size == 529
    assert tp.delta_net.rnn.input_size == d + 76
    assert tp.action_dim == nets["jp"].action_dim == 76
    assert tp.carry_dim == nets["jp"].carry_dim == 512


def test_context_and_init_states(nets):
    jp, tp, clip = nets["jp"], nets["tp"], nets["clip"]
    ap = nets["params"]["arnet"]
    _close(jp.net.apply(ap, jclip(clip), method=jta.TrajARNet.context_input),
           tp.net.context_input(tclip(clip)))
    _close(jp.net.apply(ap, jclip(clip), method=jta.TrajARNet.context_features),
           tp.net.context_features(tclip(clip)))
    for x, y in zip(jp.net.apply(ap, jclip(clip),
                                 method=jta.TrajARNet.init_states),
                    tp.net.init_states(tclip(clip))):
        _close(x, y)


def test_ar_obs_with_flow_and_context(nets):
    spec, jspec, st, clip = nets["spec"], nets["jspec"], nets["st"], nets["clip"]
    rng = np.random.RandomState(3)
    q = clip.qpos[:, 2] + rng.normal(0, 0.05, (3, 76))
    qv = rng.normal(size=(3, 75))
    ctx = rng.normal(size=(3, SMALL["rnn_hdim"]))
    t = 4
    args = (q, qv, clip.head_pose[:, t], clip.head_vels[:, t],
            clip.obj_pose[:, t], clip.obj_head_relative_poses[:, t],
            clip.action_one_hot[:, t], clip.of[:, t], ctx)
    for as_policy in (False, True):
        oj, fj = jta.ar_obs(jspec, nets["jc"], *map(jnp.asarray, args),
                            as_policy=as_policy)
        ot, ft = tta.ar_obs(spec, st, nets["tc"], *map(torch.tensor, args),
                            as_policy=as_policy)
        _close(oj, ot)
        assert ot.shape[-1] == tta.obs_dim(nets["tc"], as_policy)
        for k in fj:
            _close(fj[k], ft[k])
    _close(ot[:, :SMALL["rnn_hdim"]], ctx, 0)
    _close(ot[:, -512:], clip.of[:, t], 0)


@pytest.mark.parametrize("train", [False, True])
def test_rollout_and_loss(nets, train):
    """The open-loop rollout (gt_rate 0) and the training one at gt_rate 1
    (every step from the data; the config's noise off): every feature,
    the actions, and in training the full-rollout loss."""
    jp, tp, clip = nets["jp"], nets["tp"], nets["clip"]
    gt_rate = 1.0 if train else 0.0
    fj = jp.net.apply(nets["params"]["arnet"], jclip(clip), gt_rate,
                      jax.random.PRNGKey(2), train)
    ft = tp.net(tclip(clip), gt_rate, train=train)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        _close(fj[k], ft[k])
    if train:
        lj, ij = jta.compute_loss(nets["jc"], fj, jclip(clip))
        lt, it = tta.compute_loss(nets["tc"], ft, tclip(clip))
        _close(lj, lt)
        for k in ij:
            _close(ij[k], it[k])


def test_action_delta_net(nets):
    """One step of the residual head: the new carry and the action, which
    is the observation's last 76 entries plus the delta."""
    rng = np.random.RandomState(4)
    d = nets["tp"].delta_net.rnn.input_size
    h, obs = rng.normal(size=(3, 512)), rng.normal(size=(3, d))
    dp = nets["params"]["delta"]
    cj, aj = nets["jp"].delta_net.apply(dp, jnp.asarray(h), jnp.asarray(obs))
    ct, at = nets["tp"].action_mean(torch.tensor(h), torch.tensor(obs))
    _close(cj, ct)
    _close(aj, at)
    zero = tpa.ActionDeltaNet(d).double().init_flax_(torch.Generator().manual_seed(0))
    _, a0 = zero(torch.tensor(h), torch.tensor(obs))
    _close(obs[:, -76:], a0, 0)                   # zero-initialised head


@pytest.fixture(scope="module")
def trajectory(nets):
    """A (T, N) rollout record: observations ending in plausible poses,
    episode starts inside it, sim and ground-truth poses."""
    rng = np.random.RandomState(11)
    T, N = 5, 3
    d = nets["tp"].delta_net.rnn.input_size
    obs = rng.normal(0, 0.5, (T, N, d))
    q = nets["clip"].qpos
    obs[..., -76:] = q[:, :T].transpose(1, 0, 2) + rng.normal(0, 0.01, (T, N, 76))
    masks = np.ones((T, N))
    masks[1, 0] = masks[3, 2] = 0.0
    prev = np.concatenate([np.ones((1, N)), masks[:-1]])
    gt = q[:, 1:T + 1].transpose(1, 0, 2)
    return obs, prev, q[:, :T].transpose(1, 0, 2), gt


def test_action_means_over_time(nets, trajectory):
    obs, prev, _, _ = trajectory
    mj = nets["jp"].action_means_over_time(nets["params"], jnp.asarray(obs),
                                           jnp.asarray(prev))
    with torch.no_grad():
        mt = nets["tp"].action_means_over_time(torch.tensor(obs),
                                               torch.tensor(prev))
    _close(mj, mt)
    # the carry restarts where an episode ended: the env restarted there
    with torch.no_grad():
        c = nets["tp"].init_carry(3, torch.tensor(obs[0]))
        for t in range(2):
            c, a = nets["tp"].action_mean(c, torch.tensor(obs[t]))
    _close(a[1:], mt[1, 1:])


def test_step_update_loss_and_gradient(nets, trajectory):
    """The step-BC loss (the means are the next qpos) and its gradient:
    zero over the arnet, the delta's equal in both packages, the r and z
    hidden bias rows of its GRU zero."""
    obs, prev, curr, gt = trajectory
    jp, tp = nets["jp"], nets["tp"]

    def jloss(p):
        return jp.step_update_loss(p, jnp.asarray(obs), jnp.asarray(prev),
                                   jnp.asarray(curr), jnp.asarray(gt))[0]

    lj, gj = jax.value_and_grad(jloss)(nets["params"])
    for p in tp.parameters():
        p.grad = None
    lt, _ = tp.step_update_loss(torch.tensor(obs), torch.tensor(prev),
                                torch.tensor(curr), torch.tensor(gt))
    lt.backward()
    _close(lj, lt)
    assert not any(np.any(x) for x in jax.tree.leaves(gj["arnet"]))
    assert all(p.grad is None for p in tp.net.parameters())
    sd = {n: p.grad for n, p in tp.delta_net.named_parameters()}
    tree = weights.delta_to_jax(sd)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(gj["delta"]),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        _close(a, b)
    assert not tp.delta_net.rnn.bias_hh.grad[:2 * 512].any()


def test_init_context(nets):
    jp, tp, clip = nets["jp"], nets["tp"], nets["clip"]
    cj = jp.init_context(nets["params"], jclip(clip))
    ct = tp.init_context(tclip(clip))
    for k in ("ar_qpos", "ar_qvel", "ar_wbpos", "ar_wbquat", "ar_bquat",
              "init_qpos", "init_qvel", "context_feat"):
        _close(cj[k], ct[k])


def test_delta_weights_both_ways(nets):
    """flax -> port -> flax is the identity, leaf for leaf."""
    back = weights.delta_to_jax(nets["tp"].delta_net.state_dict())
    jl = jax.tree_util.tree_leaves_with_path(nets["params"]["delta"])
    tl = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(jl) == len(tl) == 10 + 2 * 2 + 2
    for path, x in jl:
        np.testing.assert_array_equal(x, tl[path])
    ptree = weights.policy_ar_params(nets["tp"])
    assert sorted(ptree) == ["arnet", "delta"]


@pytest.mark.parametrize("poison", [(), (("rnn.weight_hh", 3, np.nan),),
                                    (("fc.bias", 0, np.inf),
                                     ("action_gru.bias_ih", 1, np.nan))])
def test_grad_nonfinite_fraction_over_both_trees(nets, poison):
    """The fraction of flax leaves over {"arnet", "delta"}: the delta's
    GRU counts 10 leaves."""
    tp = nets["tp"]
    grads = {n: p.detach().clone() for n, p in tp.named_parameters()}
    for name, i, v in poison:
        grads[name].view(-1)[i] = v
    arnet = {n: grads[n] for n, _ in tp.net.named_parameters()}
    delta = {n: grads[n] for n, _ in tp.delta_net.named_parameters()}
    tree = {"arnet": weights.trajar_to_jax(arnet),
            "delta": weights.delta_to_jax(delta)}
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert n_leaves == sum(tlv.n_flax_leaves(n) for n in grads)
    assert sum(tlv.n_flax_leaves(n) for n in delta) == 16
    want = float(jlv.grad_nonfinite_fraction(jax.tree.map(jnp.asarray, tree)))
    got = float(tlv.grad_nonfinite_fraction(list(grads.items())))
    assert got == pytest.approx(want, abs=1e-7)
    assert (want > 0) == bool(poison)
