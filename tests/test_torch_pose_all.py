"""Port parity of the per-action success rules and of ``eval_pose_all``
against kinpoly_tpu.metrics.pose_metrics, on the CPU: the four success
building blocks on seeded signals; ``action_success`` at the model's
contact candidates and at its default vertices
(``select_contact_vertices(spec, default_k=4)``, without the extra foot
candidates); and ``eval_pose_all`` on coverage records the test writes as
``eval_ar_policy`` writes them, against JAX ``evaluate_pair`` and
``action_success`` on the same records (float64, and the script's
float32 drive)."""

import os
import pickle
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.config import defaults as jdefaults
from kinpoly_tpu.metrics import pose_metrics as jpm
from kinpoly_tpu.physics import engine as jeng
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.config.defaults import KinPolyConfig, uhc_control_params
from kinpoly_tpu_torch.metrics import pose_metrics as tpm
from kinpoly_tpu_torch.physics import contact as tct
from kinpoly_tpu_torch.physics import engine as teng
from kinpoly_tpu_torch.physics import fk as tfk
from kinpoly_tpu_torch.scripts import eval_pose_all

from test_torch_env_ar import _success_cases
from test_torch_objects import jax_spec
from test_torch_pose_metrics import _trajectories

torch.set_num_threads(1)

RTOL = 1e-8          # float64 metrics, as tests/test_torch_pose_metrics.py
F32_RTOL = 1e-4      # the script's float32 drive against float64


@pytest.fixture(scope="module")
def scene():
    spec = sp.synthetic_spec(0, with_objects=True)
    jspec = jax_spec(spec)
    jm = jeng.build_model(jspec, jdefaults.uhc_control_params(jspec),
                          with_objects=True)
    tm = teng.build_model(spec, uhc_control_params(spec), device="cpu",
                          dtype=torch.float64, with_objects=True)
    return types.SimpleNamespace(spec=spec, jspec=jspec, jm=jm, tm=tm)


def test_success_push_and_avoid_match_jax():
    rng = np.random.RandomState(0)
    for move in (0.0, 0.05, 0.2):
        seq = np.tile(rng.normal(0, 1, 7), (9, 1))
        seq[-1, :3] += rng.normal(0, 1, 3) / np.sqrt(3) * move
        assert bool(tpm.success_push(torch.tensor(seq))) == bool(
            jpm.success_push(jnp.asarray(seq)))
    for dist, drift in ((0.02, 0.1), (-0.01, 0.1), (0.02, 0.7), (0.0, 0.0)):
        hp = rng.normal(0, 1, (6, 7))
        hg = hp.copy()
        hg[-1, 0] += drift
        got = tpm.success_avoid(torch.tensor(hp), torch.tensor(hg), dist)
        assert bool(got) == bool(jpm.success_avoid(
            jnp.asarray(hp), jnp.asarray(hg), jnp.asarray(dist)))


@pytest.mark.parametrize("seed", range(6))
def test_success_sit_and_step_match_jax(seed):
    rng = np.random.RandomState(seed)
    frames = rng.rand(40) < 0.6
    for contact in (frames, np.zeros(40, bool), np.ones(40, bool),
                    np.r_[np.ones(4, bool), np.zeros(3, bool), np.ones(5, bool)],
                    np.r_[np.zeros(6, bool), np.ones(4, bool)]):
        for k in (1, 4, 5, 9):
            assert bool(tpm.success_sit(torch.tensor(contact), k)) == bool(
                jpm.success_sit(jnp.asarray(contact), k)), (contact, k)
    z = 0.9 + rng.uniform(-0.05, 0.2, 30)
    for foot in (rng.rand(30) < 0.1, np.zeros(30, bool)):
        for base in (0.9, 0.95, 1.2):
            assert bool(tpm.success_step(torch.tensor(foot), torch.tensor(z),
                                         base)) == bool(jpm.success_step(
                jnp.asarray(foot), jnp.asarray(z), base))


@pytest.mark.parametrize("verts", ["model", "default"])
@pytest.mark.parametrize("action", ["push", "sit", "avoid", "step", "None"])
def test_action_success_matches_jax(scene, action, verts):
    """At the model's candidates (as eval_ar_policy passes them) and, with
    no vertices given, at select_contact_vertices(spec, default_k=4) on
    both sides."""
    kw_j = kw_t = {}
    if verts == "model":
        kw_j = dict(verts=scene.jm.cand_verts, vert_body=scene.jm.cand_body)
        kw_t = dict(verts=scene.tm.cand_verts, vert_body=scene.tm.cand_body)
    seen = []
    for a, q, o, hp, hg in _success_cases(scene):
        if a != action:
            continue
        for fs in (False, True):
            sj = jpm.action_success(
                scene.jspec, scene.jm.scene, jnp.asarray(q), jnp.asarray(o), a,
                head_pose_pred=jnp.asarray(hp), head_pose_gt=jnp.asarray(hg),
                fail_safe_used=fs, **kw_j)
            st = tpm.action_success(
                scene.tm, torch.tensor(q), torch.tensor(o), a,
                head_pose_pred=torch.tensor(hp), head_pose_gt=torch.tensor(hg),
                fail_safe_used=fs, **kw_t)
            assert sj == st
            seen.append(st)
    assert True in seen or verts == "default"


def test_default_vertices_leave_out_the_foot_candidates(scene):
    """The default vertex set is four per body: the feet carry fewer
    candidates than the model's."""
    verts, body = tct.select_contact_vertices(scene.spec, default_k=4)
    for name, k in tct.FOOT_BODIES.items():
        b = scene.spec.body_index(name)
        assert (body == b).sum() <= 4 < int((scene.tm.cand_body == b).sum()) <= k


def test_action_success_defaults_to_the_k4_vertices_as_jax(scene):
    """A step placed under a foot candidate of the model that the default
    vertex set lacks: touched at the model's candidates, not at the
    defaults, on both sides."""
    tm, T = scene.tm, 8
    q0, _ = sp.standing_pose(scene.spec)
    qpos = np.repeat(q0[None], T, 0)
    qpos[4:, 2] += 0.15                                   # the pelvis rises
    world = teng._cand_world(tm, tfk.fk(tm.st, torch.tensor(q0[None])))[0].numpy()
    body = tm.cand_body.numpy()
    obj = np.zeros((T, 5, 7))
    obj[..., 0] = (np.arange(5) + 1) * 100.0
    obj[..., 1] = 100.0
    obj[..., 3] = 1.0
    model_kw_t = dict(verts=tm.cand_verts, vert_body=tm.cand_body)
    model_kw_j = dict(verts=scene.jm.cand_verts, vert_body=scene.jm.cand_body)
    for i in np.nonzero(np.isin(body, tpm._STEP_BODIES))[0]:
        # the step's top face 4 mm under vertex i, its edge 1 mm beyond it,
        # the box reaching away from the rest of the foot
        p = world[i]
        d = p[:2] - world[body == body[i], :2].mean(0)
        o = obj.copy()
        o[:, 4, :2] = p[:2] + d / np.linalg.norm(d) * (0.4 - 0.001)
        o[:, 4, 2] = p[2] - 0.004 + 0.03
        q, ot = torch.tensor(qpos), torch.tensor(o)
        if (tpm.action_success(tm, q, ot, "step", **model_kw_t)
                and not tpm.action_success(tm, q, ot, "step")):
            break
    else:
        pytest.fail("no step placement tells the vertex sets apart")
    qj, oj = jnp.asarray(qpos), jnp.asarray(o)
    assert jpm.action_success(scene.jspec, scene.jm.scene, qj, oj, "step",
                              **model_kw_j)
    assert not jpm.action_success(scene.jspec, scene.jm.scene, qj, oj, "step")


def _records(spec, tm):
    """Five coverage records as eval_ar_policy writes them: success
    recorded (avoid), success from the action and the object poses (push
    moved, sit with a fail-safe, step at the default vertices), and none
    (tracked percent)."""
    cases = {}
    for a, q, o, _, _ in _success_cases(types.SimpleNamespace(spec=spec, tm=tm)):
        cases.setdefault(a, (q, o))         # each action's succeeding case
    recs = []
    for i, (action, extra) in enumerate([
            ("push", dict(fail_safe=False)), ("sit", dict(fail_safe=True)),
            ("avoid", dict(fail_safe=False, succ=True)),
            ("step", dict(fail_safe=False)), (None, dict(percent=0.5))]):
        pred, gt = _trajectories(spec, seed=i, T=8)
        rec = dict(pred=pred, gt=gt, percent=extra.pop("percent", 1.0), **extra)
        if action is not None:
            q, o = cases[action]
            rec.update(pred=q + (pred - gt) * 0.1, action=action, obj_pose=o)
        recs.append(rec)
    return recs


def _jax_row(scene, rec):
    pred, gt = np.asarray(rec["pred"]), np.asarray(rec["gt"])
    m = {k: float(v) for k, v in jpm.evaluate_pair(
        scene.jspec, jnp.asarray(pred), jnp.asarray(gt),
        cand=(scene.jm.cand_verts, scene.jm.cand_body)).items()}
    m["percent"] = float(rec.get("percent", 1.0))
    if "succ" in rec:
        m["succ"] = float(rec["succ"])
    elif "action" in rec:
        m["succ"] = float(jpm.action_success(
            scene.jspec, scene.jm.scene, jnp.asarray(pred),
            jnp.asarray(rec["obj_pose"]), rec["action"],
            fail_safe_used=bool(rec.get("fail_safe"))))
    else:
        m["succ"] = float(m["percent"] >= 1.0)
    return m


def test_eval_pose_all_matches_jax(scene, tmp_path, capsys):
    cfg = KinPolyConfig.named("kin_poly")
    res_dir = os.path.join(cfg.out_dir(str(tmp_path)), "results")
    os.makedirs(res_dir)
    recs = _records(scene.spec, scene.tm)
    for i, rec in enumerate(recs):
        with open(os.path.join(res_dir, f"0800_wild_take{i}_coverage_full.pkl"),
                  "wb") as f:
            pickle.dump(rec, f)
    files = eval_pose_all.record_files(cfg, str(tmp_path), 800, wild=True)
    assert len(files) == len(recs)
    want = [_jax_row(scene, r) for r in recs]
    assert [w["succ"] for w in want] == [1.0, 0.0, 1.0, want[3]["succ"], 0.0]
    rows, per_action, mean = eval_pose_all.table(scene.tm, files)
    for got, w in zip(rows, want):
        assert list(got) == list(w)
        for k in w:
            np.testing.assert_allclose(got[k], w[k], rtol=RTOL, atol=1e-12,
                                       err_msg=k)
    assert per_action == {"push": [1.0], "sit": [0.0], "avoid": [1.0],
                          "step": [want[3]["succ"]], "None": [0.0]}
    # the script itself, float32 on the CPU: its log lines and mean row
    got_mean = eval_pose_all.main(["--iter", "800", "--wild", "--out",
                                   str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(re.findall(r"0800_wild_take\d_coverage_full.pkl  root_dist:", out)) == 5
    assert "succ[push]: 1.000 (1 takes)" in out
    assert re.search(r"--kin_poly \| 800 \| kin_poly \| wild\? True", out)
    want_mean = {k: np.mean([w[k] for w in want]) for k in want[0]}
    assert list(got_mean) == list(want_mean)
    for k, v in want_mean.items():
        np.testing.assert_allclose(got_mean[k], v, rtol=F32_RTOL, atol=1e-6,
                                   err_msg=k)
    assert eval_pose_all.main(["--iter", "801", "--out", str(tmp_path),
                               "--device", "cpu"]) is None
