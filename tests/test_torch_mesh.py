"""Port parity: the data-parallel helpers of
``kinpoly_tpu_torch/parallel/mesh.py`` against
``kinpoly_tpu/parallel/mesh.py`` and JAX's collectives, float64 on the
CPU. The port's side runs in W spawned ranks joined over gloo (one pool
per W for the whole file, ``parallel/ranks.RankPool``); the JAX side on W
of the conftest's 8 virtual CPU devices under ``shard_map``.

- ``shard_batch``: each rank's blocks against the shards JAX places, and
  the whole-tensor rule for leaves whose dim 0 does not divide (or is 0,
  or absent);
- ``psum_`` and ``pmean_`` against ``jax.lax.psum`` / ``pmean``;
- ``pmean_grads_`` against ``pmean`` of the gradients, its None
  gradient kept None, and one ``all_reduce`` for all of them;
- ``replicate_`` leaves rank 0's tensors on every rank;
- strided views go through the collectives unharmed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kinpoly_tpu.parallel import mesh as jmesh
from kinpoly_tpu_torch.parallel.ranks import RankPool

import torch_dp_jobs as jobs

torch.set_num_threads(1)

WORLDS = (2, 4)
TOL = 1e-12          # sums of a few float64 values in another order


@pytest.fixture(scope="module")
def ranks():
    """pool(W): W ranks over gloo on the CPU, started once per W."""
    pools = {}

    def get(w):
        if w not in pools:
            pools[w] = RankPool(w, "gloo", "cpu")
        return pools[w]

    yield get
    for p in pools.values():
        p.close()


def _shard_map(fn, w, in_specs, out_specs):
    return jax.shard_map(fn, mesh=jmesh.make_mesh(w), in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


@pytest.mark.parametrize("w", WORLDS)
def test_shard_batch(ranks, w):
    """The blocks of divisible leaves, whole non-divisible ones, as JAX
    shards and replicates them."""
    rng = np.random.RandomState(0)
    tree = dict(env=rng.randn(8, 3), obs=rng.randn(4 * w, 2, 2),
                odd=rng.randn(4 * w + 1, 2), empty=np.zeros((0, 3)),
                scalar=np.asarray(2.5), key=np.arange(2 * w + 1))
    got = ranks(w).run(jobs.shard_job, {k: torch.tensor(v)
                                        for k, v in tree.items()})
    placed = jmesh.shard_batch(jmesh.make_mesh(w), {
        k: jnp.asarray(v) for k, v in tree.items()})
    devices = list(jmesh.make_mesh(w).devices.flat)
    for k, x in placed.items():
        shards = {s.device: np.asarray(s.data) for s in x.addressable_shards}
        for r in range(w):
            np.testing.assert_array_equal(got[r][k].numpy(),
                                          shards[devices[r]], err_msg=k)
    for k in ("odd", "empty", "scalar", "key"):
        for r in range(w):
            np.testing.assert_array_equal(got[r][k].numpy(), tree[k])
    for r in range(w):
        np.testing.assert_array_equal(got[r]["env"].numpy(),
                                      tree["env"][r * 8 // w:(r + 1) * 8 // w])


@pytest.mark.parametrize("w", WORLDS)
def test_psum_pmean(ranks, w):
    rows = np.random.RandomState(1).randn(w, 6)
    got = ranks(w).run(jobs.collectives_job, rows)
    x = jnp.asarray(rows)
    want_sum = _shard_map(lambda a: jax.lax.psum(a, "dp"), w, P("dp"),
                          P("dp"))(x)
    want_mean = _shard_map(lambda a: jax.lax.pmean(a, "dp"), w, P("dp"),
                           P("dp"))(x)
    for r in range(w):
        s, m, a, b = got[r]
        np.testing.assert_allclose(s, np.asarray(want_sum)[r], rtol=0, atol=TOL)
        np.testing.assert_allclose(m, np.asarray(want_mean)[r], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(a, m, rtol=0, atol=0)
        np.testing.assert_allclose(b, 2 * m[:1], rtol=0, atol=TOL)


@pytest.mark.parametrize("w", WORLDS)
def test_pmean_grads(ranks, w):
    """Two gradients through one buffer and one all_reduce, against JAX's
    pmean of the gradient tree; the None gradient stays None."""
    rng = np.random.RandomState(2)
    grads = [rng.randn(w, 4, 3), rng.randn(w, 5)]
    got = ranks(w).run(jobs.pmean_grads_job, grads)
    tree = {"a": jnp.asarray(grads[0]), "b": jnp.asarray(grads[1])}
    want = _shard_map(lambda t: jax.tree.map(
        lambda g: jax.lax.pmean(g, "dp"), t), w, P("dp"), P("dp"))(tree)
    for r in range(w):
        (ga, gnone, gb), calls = got[r]
        assert calls == 1
        assert gnone is None
        np.testing.assert_allclose(ga, np.asarray(want["a"])[r], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(gb, np.asarray(want["b"])[r], rtol=0,
                                   atol=TOL)
        # bitwise equal across ranks
        np.testing.assert_array_equal(ga, got[0][0][0])
        np.testing.assert_array_equal(gb, got[0][0][2])


@pytest.mark.parametrize("w", WORLDS)
def test_replicate(ranks, w):
    got = ranks(w).run(jobs.replicate_job, 3)
    assert all(g[2] > 0 for g in got)       # the ranks' draws differed
    for sd, t, _, after in got:
        assert after == 0.0
        for k, v in sd.items():
            np.testing.assert_array_equal(v, got[0][0][k])
        for a, b in zip(t, got[0][1]):
            np.testing.assert_array_equal(a, b)
    gen = torch.Generator().manual_seed(3)
    lin = torch.nn.Linear(4, 3).double()
    w0 = torch.randn(lin.weight.shape, generator=gen, dtype=torch.float64)
    np.testing.assert_array_equal(got[0][0]["weight"], w0.numpy())


def test_init_group_refuses_what_it_cannot_place():
    """NCCL takes one card per rank: more ranks than cards raise before
    any rendezvous (the CPU never stands in), as does a rank outside
    the group."""
    from kinpoly_tpu_torch.parallel import mesh

    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one card per rank"):
        mesh.init_group(0, n_cards + 1, "nccl", "file:///nonexistent/store")
    with pytest.raises(ValueError, match="outside a group"):
        mesh.init_group(2, 2, "gloo", "file:///nonexistent/store")
