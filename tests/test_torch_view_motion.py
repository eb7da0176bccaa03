"""Port parity of the HTML motion viewer (kinpoly_tpu_torch.utils.
html_viewer) and the ``view_motion`` CLI against the JAX package's, on the
CPU, with the synthetic humanoid and its objects:

- ``_joints`` (float32 FK whatever the input) within 1e-5; ``_edges`` and
  ``_object_boxes`` equal; the template identical
- ``export_html``: the embedded JSON's joints (float32 FK rounded to 4
  decimals) at most one rounding step (1e-4) apart, every other field
  equal, and the page text outside the payload identical
- ``view_motion.main`` from ``--bank data_bank/action_takes.pkl --take``
  a push take (with its ``table_pose``) and from ``--result`` on records
  the test writes in the port's format (one object pose per frame, and
  every object slot), against ``scripts/view_motion.py`` run on the same
  files with the synthetic humanoid in place of the reference XML
"""

import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from kinpoly_tpu.anim import mjcf as jmjcf
from kinpoly_tpu.utils import html_viewer as jhv
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.data.banks import read_bank
from kinpoly_tpu_torch.scripts import view_motion
from kinpoly_tpu_torch.utils import html_viewer as thv

from test_torch_objects import jax_spec

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(ROOT, "data_bank", "action_takes.pkl")
JOINT_TOL = 1e-5         # float32 FK, both packages
PAYLOAD_STEPS = 1        # joints rounded to 4 decimals: one step (1e-4) apart


@pytest.fixture(scope="module")
def specs():
    spec = sp.synthetic_spec(with_objects=True)
    return spec, jax_spec(spec)


def payload(html: str) -> dict:
    """The viewer's data object, checking that the page around it is the
    template's."""
    head, tail = thv._TEMPLATE.split("__DATA__")
    assert html.startswith(head) and html.endswith(tail)
    return json.loads(html[len(head):len(html) - len(tail)])


def same_payload(pj: dict, pt: dict) -> None:
    assert sorted(pt) == sorted(pj)
    for k in pj:
        if k != "seqs":
            assert pt[k] == pj[k], k
    assert len(pt["seqs"]) == len(pj["seqs"])
    for sj, st in zip(pj["seqs"], pt["seqs"]):
        assert (st["label"], st["color"]) == (sj["label"], sj["color"])
        a, b = np.asarray(sj["joints"]), np.asarray(st["joints"])
        assert a.shape == b.shape
        assert int(np.rint(np.abs(a - b) * 1e4).max()) <= PAYLOAD_STEPS


def _takes():
    bank = read_bank(BANK)
    return bank, next(k for k, v in bank.items() if v.get("action") == "push"
                      and "table_pose" in v)


def test_viewer_pieces_match_jax(specs):
    spec, jspec = specs
    bank, name = _takes()
    q = np.asarray(bank[name]["qpos"], np.float64)[:40]
    jj = jhv._joints(jspec, q)
    jt = thv._joints(spec, q, device="cpu")
    assert jt.dtype == np.float32 and jt.shape == jj.shape == (40, 24, 3)
    assert float(np.abs(jt - jj).max()) < JOINT_TOL
    assert thv._edges(spec) == jhv._edges(jspec)
    assert thv._object_boxes(spec) == jhv._object_boxes(jspec)
    assert thv._TEMPLATE == jhv._TEMPLATE
    assert thv.COLORS == jhv.COLORS


@pytest.mark.parametrize("with_objects", [False, True])
def test_export_html_matches_jax(specs, tmp_path, with_objects):
    spec, jspec = specs
    bank, name = _takes()
    take = bank[name]
    rng = np.random.RandomState(0)
    seqs = {"pred": np.asarray(take["qpos"])[:50],
            "gt": np.asarray(take["qpos"])[:45] + rng.normal(0, 0.01, (45, 76))}
    obj = rng.normal(0, 1, (50, len(spec.objects), 7)) if with_objects else None
    oj = jhv.export_html(jspec, seqs, str(tmp_path / "j.html"), obj_seq=obj,
                         fps=25, title="t")
    ot = thv.export_html(spec, seqs, str(tmp_path / "t.html"), obj_seq=obj,
                         fps=25, title="t", device="cpu")
    assert ot == str(tmp_path / "t.html") and oj == str(tmp_path / "j.html")
    pj, pt = (payload(open(p).read()) for p in (oj, ot))
    same_payload(pj, pt)
    assert (pt["obj_seq"] is not None) == with_objects
    assert len(pt["objects"]) == (5 if with_objects else 0)


@pytest.fixture(scope="module")
def jax_view_motion(specs):
    """scripts/view_motion.py's main(argv) with the synthetic humanoid in
    place of the reference XML."""
    mod_spec = importlib.util.spec_from_file_location(
        "jax_view_motion", os.path.join(ROOT, "scripts", "view_motion.py"))
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    jspec = specs[1]

    def run(argv):
        saved_argv, saved_parse = sys.argv, jmjcf.parse_humanoid
        sys.argv = ["view_motion.py"] + argv
        jmjcf.parse_humanoid = lambda path: jspec
        try:
            mod.main()
        finally:
            sys.argv, jmjcf.parse_humanoid = saved_argv, saved_parse
    return run


def test_view_motion_bank_matches_jax(tmp_path, jax_view_motion):
    _, name = _takes()
    jax_view_motion(["--bank", BANK, "--take", name, "--out", str(tmp_path / "j.html")])
    out = view_motion.main(["--bank", BANK, "--take", name, "--out",
                            str(tmp_path / "t.html"), "--device", "cpu"])
    assert out == str(tmp_path / "t.html")
    pj, pt = (payload(open(tmp_path / f).read()) for f in ("j.html", "t.html"))
    same_payload(pj, pt)
    obj = np.asarray(pt["obj_seq"])
    assert obj.shape[1:] == (5, 7)
    assert np.all(obj[:, [0, 3, 4], 0] >= 100)       # chair, Can, step parked
    assert np.all(np.abs(obj[:, [1, 2], 0]) < 20)    # the box and the table
    assert pt["title"] == name


@pytest.mark.parametrize("obj_kind", ["active", "all_slots", "none"])
def test_view_motion_result_matches_jax(specs, tmp_path, jax_view_motion, obj_kind):
    spec = specs[0]
    bank, name = _takes()
    take = bank[name]
    T = 30
    rng = np.random.RandomState(1)
    rec = dict(pred=np.asarray(take["qpos"][1:T + 1], np.float32),
               gt=np.asarray(take["qpos"][1:T + 1], np.float32),
               percent=1.0, fail_safe=False, action="push", succ=True)
    rec["pred"][:, 7:] += rng.normal(0, 0.05, (T, 69)).astype(np.float32)
    if obj_kind == "active":
        rec["obj_pose"] = np.asarray(take["obj_pose"][:T], np.float32)
    elif obj_kind == "all_slots":
        rec["obj_pose"] = rng.normal(0, 1, (T, len(spec.objects), 7)).astype(np.float32)
    path = str(tmp_path / "0800_take0_coverage_full.pkl")
    with open(path, "wb") as f:
        pickle.dump(rec, f)
    jax_view_motion(["--result", path, "--out", str(tmp_path / "j.html")])
    out = view_motion.main(["--result", path, "--device", "cpu"])
    assert out == str(tmp_path / "0800_take0_coverage_full.html")
    pj, pt = payload(open(tmp_path / "j.html").read()), payload(open(out).read())
    same_payload(pj, pt)
    assert [s["label"] for s in pt["seqs"]] == ["pred", "gt"]
    assert (pt["obj_seq"] is None) == (obj_kind == "none")
