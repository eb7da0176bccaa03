"""Port parity: the AR (kinematic-policy) env in evaluation mode, and the
per-action success rules, kinpoly_tpu_torch against kinpoly_tpu, float64
on the CPU: the context build, reset, two env steps (the frozen UHC
controller iter_13000.p in the loop, five movable objects, compaction
(16, 8)), the observation, the dynamic_supervision_v1 reward and its six
components, convert_obj_qpos, ar_fail_safe and action_success.

The takes are the first frames of one wild take per action; the AR net is
TrajARNet at small widths with fresh flax parameters.
``test_torch_rollout_ar.py`` imports ``build_envs``."""

import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.config import config as jconfig
from kinpoly_tpu.config import defaults as jdefaults
from kinpoly_tpu.envs import humanoid_ar as jhar
from kinpoly_tpu.metrics import pose_metrics as jpm
from kinpoly_tpu.models import nets as jnets
from kinpoly_tpu.models import policy_ar as jpa
from kinpoly_tpu.models import traj_ar as jta
from kinpoly_tpu.physics import engine as jeng
from kinpoly_tpu.rl import agent_ar as jaa
from kinpoly_tpu.rl import running_norm as jrn
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import (KinPolyConfig, UHCConfig,
                                               uhc_control_params)
from kinpoly_tpu_torch.data import statear as tsa
from kinpoly_tpu_torch.data.banks import read_bank
from kinpoly_tpu_torch.envs.humanoid_ar import HumanoidAREnv
from kinpoly_tpu_torch.metrics import pose_metrics as tpm
from kinpoly_tpu_torch.models import traj_ar as tta
from kinpoly_tpu_torch.models import weights
from kinpoly_tpu_torch.physics import engine as teng
from kinpoly_tpu_torch.physics import fk as tfk
from kinpoly_tpu_torch.rl.agent_ar import AgentAR, load_uhc

from test_torch_objects import jax_spec

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results/motion_im/uhc/models/iter_13000.p")
WILD = os.path.join(ROOT, "data_bank", "wild_takes_r5.pkl")
TAKES = ("wild-sit-00", "wild-push-00", "wild-avoid-00", "wild-step-00")
SMALL = dict(rnn_hdim=32, mlp_hsize=(48, 24))
TOL = 1e-9           # the context: float64 kinematics and a small net
STATE_TOL = 1e-7     # physics state, as tests/test_torch_engine.py
OBS_TOL = 1e-6       # observation, reward, controller action


def build_envs(body_diff_thresh: float = 10.0, n_frames: int = 10,
               mode: str = "test", reward_id: str = "dynamic_supervision_v1",
               body_diff_gt_thresh: float = 12.0, cc_log_std: float = -2.3,
               small: dict = SMALL):
    """Both packages' AR env over one wild take per action (n_frames each),
    each with the context its own agent builds from the same small AR net:
    a namespace of the JAX and port env, policy, params and context. In
    mode "train" the envs run the ground-truth termination at
    `body_diff_gt_thresh` and sample the controller's actions at
    `cc_log_std`."""
    spec = sp.synthetic_spec(0, with_objects=True)
    jspec = jax_spec(spec)
    kw = dict(movable_objects=True, compact_k=(16, 8))
    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec),
                          solver="ltdl", with_objects=True, **kw)
    tm = teng.build_model(spec, uhc_control_params(spec), device="cpu",
                          dtype=torch.float64, with_objects=True, **kw)
    bank = read_bank(WILD)
    takes = [dict(tsa.derive_features(
        spec, bank[k]["qpos"][:n_frames].astype(np.float64),
        bank[k]["obj_pose"][:n_frames], bank[k]["action"],
        obj2_pose=(bank[k]["table_pose"][:n_frames]
                   if "table_pose" in bank[k] else None)), name=k)
        for k in TAKES]
    ds = tsa.StateARDataset(takes, fr_num=n_frames)
    clip = tsa.stack_clips([ds.whole_take(i) for i in range(len(takes))])
    # every float field in float64 (obj_pose14 gives float32): the JAX
    # control step's scan carries the object state in its own dtype
    clip = type(clip)(*(x.astype(np.float64) if x is not None
                        and x.dtype == np.float32 else x for x in clip))
    jclip = jta.ClipData(*(None if x is None else jnp.asarray(x) for x in clip))

    # fresh flax parameters, carried into the port
    jcfg, tcfg = jta.TrajARConfig(**small), tta.TrajARConfig(**small)
    jp = jpa.PolicyAR(jspec, jcfg)
    with open(CKPT, "rb") as f:
        blob = pickle.load(f)
    jrw = jconfig.KinPolyConfig("kin_poly").reward_weights()
    trw = KinPolyConfig().reward_weights()
    jrw = type(jrw)(**{**jrw.__dict__, "reward_id": reward_id})
    trw = type(trw)(**{**trw.__dict__, "reward_id": reward_id})
    jenv = jhar.HumanoidAREnv(
        jm, jcfg, jconfig.UHCConfig("uhc", "results").env_config(),
        jrw, context=None,
        cc_policy_apply=jnets.PolicyMCP(action_dim=75,
                                        log_std_init=cc_log_std).apply,
        cc_policy_params=jax.tree.map(lambda x: np.asarray(x, np.float64),
                                      blob["policy_params"]),
        cc_norm=jrn.RunningNorm(*blob["norm"]), mode=mode, wild=mode == "test",
        body_diff_thresh=body_diff_thresh,
        body_diff_gt_thresh=body_diff_gt_thresh)
    cc_policy, cc_norm = load_uhc(CKPT, "cpu", torch.float64)
    cc_policy.log_std_init = cc_log_std
    tenv = HumanoidAREnv(tm, tcfg, UHCConfig().env_config(), trw, None,
                         cc_policy, cc_norm, mode=mode,
                         body_diff_thresh=body_diff_thresh,
                         body_diff_gt_thresh=body_diff_gt_thresh)
    agent = AgentAR(tenv, ds)
    params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jp.init_params(jax.random.PRNGKey(0), jclip))
    agent.policy.net.load_state_dict(weights.trajar_from_jax(params))
    tenv.ctx = agent.build_context(tsa.clip_tensors(clip, torch.float64, "cpu"),
                                   fix_height=True)
    jctx = jaa.AgentAR._build_context(
        types.SimpleNamespace(policy=jp, env=jenv), params, jclip, True)
    jenv.ctx = jctx
    return types.SimpleNamespace(spec=spec, jspec=jspec, jm=jm, tm=tm,
                                 jenv=jenv, tenv=tenv, jp=jp, tp=agent.policy,
                                 params=params, jctx=jctx, tctx=tenv.ctx,
                                 clip=clip, n=len(takes), ds=ds, takes=takes)


@pytest.fixture(scope="module")
def ar():
    """build_envs, its reset of one env per take in both packages, and two
    env steps from there under the port policy's mean actions."""
    e = build_envs()
    keys = jax.random.split(jax.random.PRNGKey(3), e.n)
    js, jobs = jax.jit(jax.vmap(lambda k, i: e.jenv.reset(k, i)))(
        keys, jnp.arange(e.n, dtype=jnp.int32))
    ts, tobs = e.tenv.reset(torch.arange(e.n))
    e.reset_out = ((js, jobs), (ts, tobs))
    jstep = jax.jit(jax.vmap(e.jenv.step))
    e.steps = []
    with torch.no_grad():
        for _ in range(2):
            a = e.tp.action_mean(e.tp.init_carry(e.n, tobs), tobs)[1]
            jout = jstep(js, jnp.asarray(a.numpy()))
            tout = e.tenv.step(ts, a)
            e.steps.append((jout, tout))
            js, ts, tobs = jout[0], tout[0], tout[1]
    return e


def _close(a, b, tol):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == bool or b.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b)
        return
    err = float(np.abs(a - b).max())
    assert err <= tol, err


def _state(js, ts):
    for f in ("qpos", "qvel", "obj_qpos", "obj_qvel"):
        _close(getattr(js.sim, f), getattr(ts.sim, f), STATE_TOL)
    for f in ("prev_bquat", "prev_hpos", "target_qpos"):
        _close(getattr(js, f), getattr(ts, f), STATE_TOL)
    for f in ("cur_t", "clip_idx", "done", "fail"):
        _close(getattr(js, f), getattr(ts, f), 0)


def test_build_context(ar):
    for f in ar.jctx._fields:
        a, b = getattr(ar.jctx, f), getattr(ar.tctx, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _close(a, b, TOL)


def test_reset(ar):
    (js, jobs), (ts, tobs) = ar.reset_out
    _state(js, ts)
    _close(jobs, tobs, OBS_TOL)
    # the action's object at its context pose, the others parked
    np.testing.assert_array_equal(ts.sim.obj_qpos[1, 1].numpy(),
                                  ar.clip.obj_pose[1, 0, :7])


@pytest.mark.parametrize("k", [0, 1])
def test_step(ar, k):
    """Step k + 1: state, observation, reward and its six components,
    termination, the controller's action and observation."""
    (js, jobs, jr, jd, jinfo), (ts, tobs, tr, td, tinfo) = ar.steps[k]
    _state(js, ts)
    _close(jobs, tobs, OBS_TOL)
    _close(jr, tr, OBS_TOL)
    _close(jinfo["reward_info"], tinfo.reward_info, OBS_TOL)
    assert tinfo.reward_info.shape == (ar.n, 6)
    _close(jd, td, 0)
    for f in ("fail", "end"):
        _close(jinfo[f], getattr(tinfo, f), 0)
    _close(jinfo["percent"], tinfo.percent, OBS_TOL)
    _close(jinfo["cc_action"], tinfo.cc_action, OBS_TOL)
    _close(jinfo["cc_state"], tinfo.cc_state, OBS_TOL)
    assert float(tr.min()) > 0.0


def test_convert_obj_qpos(ar):
    rng = np.random.RandomState(1)
    oh = np.eye(4)[[0, 1, 2, 3, 1]]
    oh[4] = 0.0                                       # no action
    pose = rng.normal(size=(5, 14))
    for p in (pose, pose[:, :7]):
        _close(jax.vmap(ar.jenv.convert_obj_qpos)(jnp.asarray(oh), jnp.asarray(p)),
               ar.tenv.convert_obj_qpos(torch.tensor(oh), torch.tensor(p)), 0)


def test_ar_fail_safe(ar):
    (js, _, _, _, _), (ts, _, _, _, _) = ar.steps[0]
    jf = jax.vmap(ar.jenv.ar_fail_safe)(js)
    tf = ar.tenv.ar_fail_safe(ts)
    _state(jf, tf)
    _close(jf.sim_fk.xpos, tf.sim_fk.xpos, STATE_TOL)
    _close(tf.sim.qpos, ar.tctx.ar_qpos[:, 2], 0)


def _success_cases(e):
    """(action, qpos (T, 76), obj (T, 5, 7), head pred, head gt) per case:
    for every action one that succeeds and one that fails."""
    spec, T = e.spec, 8
    q0, _ = sp.standing_pose(spec)
    qpos = np.repeat(q0[None], T, 0)
    obj = np.zeros((T, 5, 7))
    obj[..., 0] = (np.arange(5) + 1) * 100.0
    obj[..., 1] = 100.0
    obj[..., 3] = 1.0
    res = tfk.fk(e.tm.st, torch.tensor(qpos[:1]))
    world = teng._cand_world(e.tm, res)[0].numpy()
    body = e.tm.cand_body.numpy()

    def lowest(b):
        w = world[body == b]
        return w[w[:, 2].argmin()]

    head = tfk.fk(e.tm.st, torch.tensor(qpos)).xpos[:, spec.body_index("Head")]
    head = head.numpy()

    def place(i, pos, slide=0.0):
        o = obj.copy()
        o[:, i, :3] = pos
        o[:, i, 0] += np.linspace(0.0, slide, T)
        return o

    pelvis, toe = lowest(0), lowest(spec.body_index("L_Toe"))
    raised = qpos.copy()
    raised[4:, 2] += 0.15
    return [
        ("push", qpos, place(1, [1.0, 0.0, 0.22], 0.2), head, head),
        ("push", qpos, place(1, [1.0, 0.0, 0.22], 0.05), head, head),
        # the seat top 3 mm above the pelvis' lowest vertex
        ("sit", qpos, place(0, pelvis + [0, 0, 0.003 - 0.02]), head, head),
        ("sit", qpos, obj, head, head),
        ("avoid", qpos, obj, head, head),
        ("avoid", qpos, place(3, [pelvis[0], pelvis[1] + 0.2, 0.69]), head, head),
        ("avoid", qpos, obj, head, head + [0.6, 0.0, 0.0]),
        # the step's top face 2 mm above the toe's lowest vertex
        ("step", raised, place(4, toe + [0, 0, 0.002 + 0.03]), head, head),
        ("step", qpos, place(4, toe + [0, 0, 0.002 + 0.03]), head, head),
        ("None", qpos, obj, head, head),
    ]


@pytest.mark.parametrize("action", ["push", "sit", "avoid", "step", "None"])
def test_action_success(ar, action):
    results = []
    for a, q, o, hp, hg in _success_cases(ar):
        if a != action:
            continue
        for fs in (False, True):
            sj = jpm.action_success(
                ar.jspec, ar.jm.scene, jnp.asarray(q), jnp.asarray(o), a,
                head_pose_pred=jnp.asarray(hp), head_pose_gt=jnp.asarray(hg),
                fail_safe_used=fs, verts=ar.jm.cand_verts,
                vert_body=ar.jm.cand_body)
            st = tpm.action_success(
                ar.tm, torch.tensor(q), torch.tensor(o), a,
                head_pose_pred=torch.tensor(hp), head_pose_gt=torch.tensor(hg),
                fail_safe_used=fs)
            assert sj == st
            results.append(st)
    assert True in results and (action == "None" or results.count(True) < len(results))
    assert list(tpm.action_object_indices(ar.spec)) == list(
        jpm.action_object_indices(ar.jspec))
