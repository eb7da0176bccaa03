"""Port parity: the object half of the contact model (scene, signed
distances, humanoid-object and object-floor contacts, planned and not, the
object side of the contact Jacobian, the split-row contact system with the
movable objects' terms) of kinpoly_tpu_torch against kinpoly_tpu, float64
on the CPU, on the synthetic humanoid's five objects.

Also the home of ``jax_spec``, which the other object and AR parity tests
import: the synthetic spec handed to the JAX package field by field."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinpoly_tpu.anim import mjcf
from kinpoly_tpu.physics import contact as jct
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.physics import contact as tct

torch.set_num_threads(1)

TOL = 1e-12          # geometry: closed-form, no accumulation
FORCE_TOL = 1e-9     # PSOR forces, relative to max |f| (float64)
# object names the per-action rules resolve (metrics/pose_metrics.py:197)
NAMES = ("chair", "box", "table", "Can", "step")


def jax_spec(spec):
    """The port's HumanoidSpec as kinpoly_tpu's, objects and geoms rebuilt
    field by field."""
    def fields(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    objects = tuple(
        mjcf.ObjectSpec(**{**fields(o), "geoms": tuple(
            mjcf.Geom(**fields(g)) for g in o.geoms)})
        for o in spec.objects)
    return mjcf.HumanoidSpec(**{**fields(spec), "objects": objects})


def random_obj_qpos(rng, n, n_obj=5, spread=0.3):
    """(n, n_obj, 7) poses near the origin with random orientations."""
    q = rng.normal(size=(n, n_obj, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = rng.uniform(-spread, spread, (n, n_obj, 3))
    pos[..., 2] += 0.4
    return np.concatenate([pos, q], axis=-1)


@pytest.fixture(scope="module")
def scenes():
    spec = sp.synthetic_spec(0, with_objects=True)
    js = jct.scene_from_spec(jax_spec(spec))
    ts = tct.scene_from_spec(spec)
    return spec, js, ts, tct.scene_tensors(ts, torch.float64, "cpu")


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err < tol, err


def test_synthetic_objects():
    spec = sp.synthetic_spec(0, with_objects=True)
    assert tuple(o.name for o in spec.objects) == NAMES
    assert sp.synthetic_spec(0).objects == ()
    for o in spec.objects:
        vol = np.asarray([np.prod(2 * g.size) if g.gtype == "box"
                          else np.pi * g.size[0] ** 2 * 2 * g.size[1]
                          for g in o.geoms])
        m = np.asarray([g.mass for g in o.geoms])
        np.testing.assert_allclose(m, o.mass * vol / vol.sum())
        np.testing.assert_allclose(
            o.com, m @ np.stack([g.pos for g in o.geoms]) / o.mass, atol=1e-15)
        assert np.allclose(o.inertia, o.inertia.T)
        assert np.all(np.linalg.eigvalsh(o.inertia) > 0)
        # each object rests on the floor from the height the AR takes pose
        # it at (tools/gen_action_clips.py)
        lowest = min(g.pos[2] - (g.size[2] if g.gtype == "box" else g.size[1])
                     for g in o.geoms)
        rest = {"chair": 0.38, "box": 0.22, "table": 0.79, "Can": 0.69,
                "step": 0.37}[o.name]
        assert abs(lowest + rest) < 1e-12


def test_scene_from_spec(scenes):
    _, js, ts, _ = scenes
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a, b)
    v_j, o_j = jct.object_floor_verts(js)
    v_t, o_t = tct.object_floor_verts(ts)
    _close(v_j, v_t)
    np.testing.assert_array_equal(o_j, o_t)


@pytest.mark.parametrize("kind", ["box", "cylinder"])
def test_sdf(kind):
    rng = np.random.RandomState(1)
    size = np.asarray([0.3, 0.2, 0.1])
    p = rng.uniform(-0.5, 0.5, (400, 3))
    p[:50] = 0.0                                    # the centre: ties
    p[50:100] *= 0.2                                # inside
    jf, tf = ((jct._sdf_box, tct._sdf_box) if kind == "box"
              else (jct._sdf_cylinder, tct._sdf_cylinder))
    dj, nj = jf(jnp.asarray(p), jnp.asarray(size))
    dt, nt = tf(torch.tensor(p), torch.tensor(size))
    _close(dj, dt)
    _close(nj, nt)
    assert (np.asarray(dj) < 0).any() and (np.asarray(dj) > 0).any()


def test_object_point_distances(scenes):
    _, js, _, tsc = scenes
    rng = np.random.RandomState(2)
    obj = random_obj_qpos(rng, 3)
    pts = rng.uniform(-0.6, 0.6, (3, 40, 3)) + [0, 0, 0.4]
    dj, nj = jct.object_point_distances(js, jnp.asarray(obj), jnp.asarray(pts))
    dt, nt = tct.object_point_distances(tsc, torch.tensor(obj), torch.tensor(pts))
    _close(dj, dt)
    _close(nj, nt)
    assert (np.asarray(dj) < 0).sum() > 10          # points inside geoms


def _cand(spec, rng, n):
    """Candidate verts and bodies of the engine's selection, posed as
    world points around the objects."""
    verts, body = tct.select_contact_vertices(spec, per_body=tct.FOOT_BODIES,
                                              default_k=4)
    world = rng.uniform(-0.5, 0.5, (n, len(verts), 3)) + [0, 0, 0.4]
    return verts, body, world


def _cmp_set(cj, ctt):
    for f in ("pos", "normal", "depth", "friction"):
        _close(getattr(cj, f), getattr(ctt, f))
    for f in ("body", "active", "obj"):
        np.testing.assert_array_equal(np.asarray(getattr(cj, f)),
                                      getattr(ctt, f).numpy())


def test_object_contacts(scenes):
    spec, js, _, tsc = scenes
    rng = np.random.RandomState(3)
    verts, body, world = _cand(spec, rng, 3)
    obj = random_obj_qpos(rng, 3)
    cj = jct.object_contacts(js, jnp.asarray(obj), jnp.asarray(world), body, 8)
    ctt = tct.object_contacts(tsc, torch.tensor(obj), torch.tensor(world),
                              torch.tensor(body), 8)
    _cmp_set(cj, ctt)
    assert np.asarray(cj.active).any()


def test_object_contacts_planned(scenes):
    """The planned form on random FK frames and a plan of (geom, vert)
    pairs with repeats."""
    spec, js, _, tsc = scenes
    rng = np.random.RandomState(4)
    verts, body, _ = _cand(spec, rng, 1)
    n, B = 3, spec.n_bodies
    xpos = rng.uniform(-0.4, 0.4, (n, B, 3)) + [0, 0, 0.4]
    xq = rng.normal(size=(n, B, 4))
    xq /= np.linalg.norm(xq, axis=-1, keepdims=True)
    obj = random_obj_qpos(rng, n)
    G = len(js.gtype)
    plan = rng.randint(0, G * len(verts), (n, 16))
    cj = jct.object_contacts_planned(
        js, jnp.asarray(obj), jnp.asarray(verts), body, jnp.asarray(xpos),
        jnp.asarray(xq), jnp.asarray(plan), 8)
    ctt = tct.object_contacts_planned(
        tsc, torch.tensor(obj), torch.tensor(verts), torch.tensor(body),
        torch.tensor(xpos), torch.tensor(xq), torch.tensor(plan), 8)
    _cmp_set(cj, ctt)


@pytest.mark.parametrize("planned", [False, True])
def test_object_floor_contacts(scenes, planned):
    _, js, ts, _ = scenes
    rng = np.random.RandomState(5)
    fv, fvo = tct.object_floor_verts(ts)
    obj = random_obj_qpos(rng, 3)
    obj[..., 2] = rng.uniform(0.2, 0.8, (3, 5))     # some corners below z = 0
    if planned:
        plan = rng.randint(0, len(fv), (3, 20))
        cj = jct.object_floor_contacts_planned(jnp.asarray(obj), fv, fvo,
                                               jnp.asarray(plan), 10)
        ctt = tct.object_floor_contacts_planned(
            torch.tensor(obj), torch.tensor(fv), torch.tensor(fvo),
            torch.tensor(plan), 10)
    else:
        cj = jct.object_floor_contacts(jnp.asarray(obj), fv, fvo, 10)
        ctt = tct.object_floor_contacts(torch.tensor(obj), torch.tensor(fv),
                                        torch.tensor(fvo), 10)
    _cmp_set(cj, ctt)
    assert np.asarray(cj.active).any()


def test_object_jacobian(scenes):
    spec, js, _, tsc = scenes
    rng = np.random.RandomState(6)
    verts, body, world = _cand(spec, rng, 3)
    obj = random_obj_qpos(rng, 3)
    cj = jct.object_contacts(js, jnp.asarray(obj), jnp.asarray(world), body, 8)
    ctt = tct.object_contacts(tsc, torch.tensor(obj), torch.tensor(world),
                              torch.tensor(body), 8)
    # a floor block (obj -1) in the middle: its rows must be zero
    fj = jct.floor_contacts(None, jnp.asarray(verts), body, jnp.zeros((3, 24, 3)),
                            jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (3, 24, 1)), 2)
    ft = tct.floor_contacts(torch.tensor(verts), torch.tensor(body),
                            torch.zeros(3, 24, 3, dtype=torch.float64),
                            torch.tensor([1.0, 0, 0, 0]).repeat(3, 24, 1).double(), 2)
    cj, ctt = jct.merge_contacts(fj, cj), tct.merge_contacts(ft, ctt)
    com = rng.uniform(-0.3, 0.3, (3, 5, 3))
    Jj, rj = jct.object_jacobian(cj, jnp.asarray(com))
    Jt, rt = tct.object_jacobian(ctt, torch.tensor(com))
    _close(Jj, Jt)
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    assert np.all(np.asarray(Jj)[:, :6] == 0) and np.abs(np.asarray(Jj)).max() > 0.1


def test_contact_system_split_rows_with_object_terms():
    """contact_forces with fewer humanoid rows than blocks (split
    object-floor rows) and the object Delassus block, velocity and smooth
    acceleration terms, against JAX's lax PSOR."""
    rng = np.random.RandomState(7)
    n, K, n_h, nv = 3, 10, 18, 12
    J = rng.normal(size=(n, n_h, nv))
    M = rng.normal(size=(n, nv, nv))
    M = M @ np.swapaxes(M, -1, -2) + nv * np.eye(nv)
    MiJt = np.linalg.solve(M, np.swapaxes(J, -1, -2))
    Jo = rng.normal(size=(n, 3 * K, 6)) * 0.5
    A_extra = Jo @ np.swapaxes(Jo, -1, -2)
    qacc, qvel = rng.normal(size=(n, nv)), rng.normal(size=(n, nv))
    depth = rng.uniform(-0.01, 0.02, (n, K))
    active = depth > 0
    mu = np.tile(np.r_[np.ones(4), np.zeros(2), np.ones(4)], (n, 1))
    row_live = rng.rand(n, 3 * K) > 0.2            # per env (after compaction)
    vel_x, acc_x = rng.normal(size=(n, 3 * K)), rng.normal(size=(n, 3 * K))
    fj = jct.contact_forces(
        *map(jnp.asarray, (J, MiJt, qacc, qvel, depth, active, mu)), 1 / 450,
        iters=20, row_live=jnp.asarray(row_live), A_extra=jnp.asarray(A_extra),
        vel_extra=jnp.asarray(vel_x), acc_smooth_extra=jnp.asarray(acc_x))
    ft = tct.contact_forces(
        *map(torch.tensor, (J, MiJt, qacc, qvel, depth, active, mu)), iters=20,
        row_live=torch.tensor(row_live), A_extra=torch.tensor(A_extra),
        vel_extra=torch.tensor(vel_x), acc_smooth_extra=torch.tensor(acc_x))
    fj = np.asarray(fj)
    assert np.abs(fj).max() > 1e-3
    _close(fj, ft, FORCE_TOL * np.abs(fj).max())
