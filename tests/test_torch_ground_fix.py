"""Port parity of the grounding grid search (kinpoly_tpu_torch.data.
ground_fix) against kinpoly_tpu.data.ground_fix, float64 on the CPU, on the
synthetic humanoid: ``ground_legs``, ``ground_arms`` and ``max_root_lift``
on the first two takes of data_bank/clips24.pkl (whose frames sink into
the synthetic floor) and on a seeded lying clip whose legs and arms
interpolate through the floor. The delta tracks and the fixed qpos agree
within 1e-10; the ties of the symmetric grid go to the negative delta, as
numpy's argmin breaks them."""

import os

import numpy as np
import pytest
import torch

from kinpoly_tpu.data import ground_fix as jgf
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.data import ground_fix as tgf
from kinpoly_tpu_torch.data.banks import load_takes

from test_torch_objects import jax_spec

torch.set_num_threads(1)

TOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(device="cpu", dtype=torch.float64)


def lying_clip(spec, T: int = 30, seed: int = 0) -> np.ndarray:
    """Supine, the root 0.12 m over the floor, hips and shoulders swinging
    through their ranges so that feet and hands pass under the floor."""
    rng = np.random.RandomState(seed)
    q = np.zeros((T, spec.nq))
    q[:, 2] = 0.12
    q[:, 3] = 1.0                                   # SMPL rest frame: y up -> lying
    names = list(spec.body_names)
    s = np.sin(np.linspace(0, 2 * np.pi, T))
    for side, sign in (("L", 1.0), ("R", -1.0)):
        hip = 7 + 3 * (names.index(f"{side}_Hip") - 1)
        sh = 7 + 3 * (names.index(f"{side}_Shoulder") - 1)
        q[:, hip + 2] = 0.9 * s
        q[:, sh + 1] = sign * 1.2 * s
    q[:, 7:] += rng.uniform(-0.05, 0.05, (T, 69))
    return q


@pytest.fixture(scope="module")
def clips():
    spec = sp.synthetic_spec(0)
    takes = load_takes(os.path.join(ROOT, "data_bank", "clips24.pkl"))
    qs = {k: np.asarray(v, np.float64) for k, v in list(takes.items())[:2]}
    qs["lying"] = lying_clip(spec)
    return spec, jax_spec(spec), qs


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err < tol, err


@pytest.mark.parametrize("which", ["legs", "arms"])
@pytest.mark.parametrize("take", [0, 1, 2])
def test_grounding_matches_jax(clips, which, take):
    spec, jspec, qs = clips
    q = list(qs.values())[take]
    fj = getattr(jgf, f"ground_{which}")
    ft = getattr(tgf, f"ground_{which}")
    qj, dj = fj(jspec, q)
    qt, dt = ft(spec, q, **F64)
    _close(dj, dt)
    _close(qj, qt)
    assert qt.dtype == q.dtype


@pytest.mark.parametrize("take", [0, 1, 2])
def test_max_root_lift_matches_jax(clips, take):
    spec, jspec, qs = clips
    q = list(qs.values())[take]
    lj = jgf.max_root_lift(jspec, q)
    lt = tgf.max_root_lift(spec, q, **F64)
    assert abs(lj - lt) < TOL
    assert lt > 0.0                     # every clip here sinks somewhere


def test_grounding_lifts_and_breaks_ties_low(clips):
    """On the lying clip, in every frame that some delta grounds, the legs'
    search picks the smallest |delta| that grounds it, the first (negative)
    one of a symmetric pair."""
    spec, _, qs = clips
    q = qs["lying"]
    slots = tgf.leg_slots(spec)
    deltas, minz = tgf.grid_min_z(spec, q, slots, tgf.LEG_BODIES, 1.2, 49, **F64)
    pick = tgf.pick_deltas(deltas, minz, 0.005)
    ok = minz >= 0.005
    assert ok.any(axis=0).any()
    # within the grounded frames the pick is the smallest |delta| that grounds
    for t in np.nonzero(ok.any(axis=0))[0]:
        best = np.min(np.abs(deltas[ok[:, t]]))
        assert abs(deltas[pick[t]]) == best
        assert pick[t] == np.nonzero(ok[:, t] & (np.abs(deltas) == best))[0][0]
    # -0.5 and +0.5 both ground the frame, 0 does not
    np.testing.assert_array_equal(
        tgf.pick_deltas(np.array([-0.5, 0.0, 0.5]), np.array([[1.0], [-1.0], [1.0]]), 0.5),
        [0])
