"""Port parity: the kinematic policy network and its helpers (step_ar,
clamp_qpos, ar_obs, the Gaussian time filter, TrajARNet's open-loop
rollout, PolicyAR.init_context and the step action) of kinpoly_tpu_torch
against kinpoly_tpu, float64 on the CPU: small widths with fresh flax
parameters carried over by ``weights.trajar_from_jax``, and once at
kin_poly.yml's full widths with the trained ``iter_0800.p`` loaded into
both packages, on two wild takes."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.models import policy_ar as jpa
from kinpoly_tpu.models import traj_ar as jta
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.data import statear as tsa
from kinpoly_tpu_torch.models import policy_ar as tpa
from kinpoly_tpu_torch.models import traj_ar as tta
from kinpoly_tpu_torch.models import weights

from test_torch_objects import jax_spec

torch.set_num_threads(1)

TOL = 1e-9           # float64 kinematics and small nets
NET_TOL = 1e-6       # network outputs at full width (1024-wide GRUs)
ROOT = os.path.join(os.path.dirname(__file__), "..")
WILD = os.path.join(ROOT, "data_bank", "wild_takes_r5.pkl")
AR_CKPT = os.path.join(ROOT, "results_r5", "statear", "kin_poly", "models",
                       "iter_0800.p")
SMALL = dict(rnn_hdim=32, mlp_hsize=(48, 24))


@pytest.fixture(scope="module")
def specs():
    spec = sp.synthetic_spec(0, with_objects=True)
    return spec, jax_spec(spec), sp.spec_tensors(spec, torch.float64, "cpu")


def wild_clips(spec, n_takes, n_frames):
    """The first takes of the wild bank, derived in float64 by the port and
    cut to n_frames (numpy ClipData, both packages take it as is)."""
    from kinpoly_tpu_torch.data.banks import read_bank
    raw = list(read_bank(WILD).items())[:n_takes]
    takes = [tsa.derive_features(spec, t["qpos"][:n_frames].astype(np.float64),
                                 t["obj_pose"][:n_frames], t["action"],
                                 obj2_pose=t.get("table_pose")) for _, t in raw]
    ds = tsa.StateARDataset(takes, fr_num=n_frames)
    return tsa.stack_clips([ds.whole_take(i) for i in range(len(takes))])


def jclip(c):
    return jta.ClipData(*(None if x is None else jnp.asarray(x) for x in c))


def tclip(c):
    return tsa.clip_tensors(c, torch.float64, "cpu")


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


@pytest.mark.parametrize("variant", ["has_z", "pose_delta"])
def test_step_ar(variant):
    cfg = dict(has_z=dict(), pose_delta=dict(pose_delta=True))[variant]
    jc, tc = jta.TrajARConfig(**cfg), tta.TrajARConfig(**cfg)
    rng = np.random.RandomState(0)
    q = rng.normal(size=(5, 76))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=-1, keepdims=True)
    a = rng.normal(size=(5, jc.action_dim))
    _close(jta.step_ar(jnp.asarray(q), jnp.asarray(a), jc),
           tta.step_ar(torch.tensor(q), torch.tensor(a), tc))
    qv = rng.normal(size=(5, 75))
    for x, y in zip(jta.step_ar_with_vel(jnp.asarray(q), jnp.asarray(qv),
                                         jnp.asarray(a), jc),
                    tta.step_ar_with_vel(torch.tensor(q), torch.tensor(qv),
                                         torch.tensor(a), tc)):
        _close(x, y)


def test_clamp_qpos(specs):
    spec, jspec, _ = specs
    rng = np.random.RandomState(1)
    prev = rng.normal(size=(6, 76))
    q = prev + rng.normal(0, 2.0, (6, 76))
    q[0, 4] = np.nan
    q[1, 10] = np.inf
    q[2, :3] = [np.nan, 5.0, -5.0]
    lo, hi = (torch.tensor(spec.jnt_range[:, i]) for i in (0, 1))
    out = tta.clamp_qpos(lo, hi, torch.tensor(prev), torch.tensor(q))
    _close(jta.clamp_qpos(jspec, jnp.asarray(prev), jnp.asarray(q)), out)
    assert bool(torch.isfinite(out).all())


def test_gaussian_filter1d_time():
    x = np.random.RandomState(2).normal(size=(2, 13, 5))
    _close(jpa.gaussian_filter1d_time(jnp.asarray(x)),
           tpa.gaussian_filter1d_time(torch.tensor(x)))


@pytest.mark.parametrize("as_policy", [False, True])
def test_ar_obs(specs, as_policy):
    spec, jspec, st = specs
    cfg = tta.TrajARConfig()
    c = wild_clips(spec, 3, 6)
    rng = np.random.RandomState(3)
    q = c.qpos[:, 2] + rng.normal(0, 0.05, (3, 76))
    qv = rng.normal(size=(3, 75))
    t = 4
    args = (q, qv, c.head_pose[:, t], c.head_vels[:, t], c.obj_pose[:, t],
            c.obj_head_relative_poses[:, t], c.action_one_hot[:, t])
    oj, fj = jta.ar_obs(jspec, jta.TrajARConfig(), *map(jnp.asarray, args),
                        as_policy=as_policy)
    ot, ft = tta.ar_obs(spec, st, cfg, *map(torch.tensor, args),
                        as_policy=as_policy)
    _close(oj, ot)
    assert ot.shape[-1] == tta.obs_dim(cfg, as_policy) == jta.obs_dim(
        jta.TrajARConfig(), as_policy)
    for k in fj:
        _close(fj[k], ft[k])


@pytest.fixture(scope="module")
def small_nets(specs):
    """Fresh flax TrajARNet params at small widths, in both packages."""
    spec, jspec, st = specs
    clip = wild_clips(spec, 2, 9)
    jnet = jta.TrajARNet(spec=jspec, cfg=jta.TrajARConfig(**SMALL),
                         as_policy=True)
    params = jnet.init(jax.random.PRNGKey(0), jclip(clip), 0.0,
                       jax.random.PRNGKey(1))
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
    tnet = tta.TrajARNet(spec, st, tta.TrajARConfig(**SMALL), as_policy=True)
    tnet.load_state_dict(weights.trajar_from_jax(params))
    return clip, jnet, params, tnet.double()


def test_trajar_context_and_init_states(small_nets):
    clip, jnet, params, tnet = small_nets
    for x, y in zip(jnet.apply(params, jclip(clip),
                               method=jta.TrajARNet.init_states),
                    tnet.init_states(tclip(clip))):
        _close(x, y)


def test_trajar_action_step(small_nets):
    clip, jnet, params, tnet = small_nets
    rng = np.random.RandomState(4)
    h = rng.normal(size=(2, SMALL["rnn_hdim"]))
    s = rng.normal(size=(2, tta.obs_dim(tta.TrajARConfig(), True)))
    cj, aj = jnet.apply(params, jnp.asarray(h), jnp.asarray(s),
                        method=jta.TrajARNet.action)
    with torch.no_grad():
        ct, at = tnet.action(torch.tensor(h), torch.tensor(s))
    _close(cj, ct)
    _close(aj, at)


def test_trajar_rollout(small_nets):
    """The open-loop rollout (gt_rate 0, no noise): every feature, the
    actions and the shifted qvel."""
    clip, jnet, params, tnet = small_nets
    fj = jnet.apply(params, jclip(clip), 0.0, jax.random.PRNGKey(2), False)
    with torch.no_grad():
        ft = tnet(tclip(clip))
    assert sorted(fj) == sorted(ft)
    for k in fj:
        _close(fj[k], ft[k])


def test_init_context_small(specs, small_nets):
    spec, jspec, st = specs
    clip, _, params, tnet = small_nets
    jp = jpa.PolicyAR(jspec, jta.TrajARConfig(**SMALL))
    tp = tpa.PolicyAR(spec, st, tta.TrajARConfig(**SMALL))
    tp.net.load_state_dict(tnet.state_dict())
    tp.net.double()
    cj = jp.init_context(params, jclip(clip))
    ct = tp.init_context(tclip(clip))
    for k in ("ar_qpos", "ar_qvel", "ar_wbpos", "ar_wbquat", "ar_bquat",
              "init_qpos", "init_qvel"):
        _close(cj[k], ct[k])
    assert ct["context_feat"] is None


def test_init_context_iter_0800_full_width(specs):
    """The trained checkpoint at full width (GRUs 17->1024 and 105->1024,
    MLPs (1024, 512, 256)) loaded by the JAX package's pickle and by the
    port's restricted reader: init_context on two wild takes."""
    spec, jspec, st = specs
    with open(AR_CKPT, "rb") as f:
        blob = pickle.load(f)
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), blob["params"])
    ck = weights.load_ar_checkpoint(AR_CKPT)
    assert ck["epoch"] == blob["epoch"] == 800
    assert ck["cc"] is not None and len(ck["freq"]) == len(blob["freq"])
    clip = wild_clips(spec, 2, 24)
    jp = jpa.PolicyAR(jspec, jta.TrajARConfig())
    tp = tpa.PolicyAR(spec, st, tta.TrajARConfig())
    tp.net.load_state_dict(ck["policy"])
    tp.net.double()
    cj = jp.init_context(params, jclip(clip))
    ct = tp.init_context(tclip(clip))
    for k in ("ar_qpos", "ar_qvel", "ar_wbpos", "ar_wbquat", "ar_bquat",
              "init_qpos", "init_qvel"):
        _close(cj[k], ct[k], NET_TOL)
