"""Data parallelism over ``torch.distributed`` (port of
``kinpoly_tpu/parallel/mesh.py``): W ranks each step their own block of
the env batch; parameters and optimiser states are replicated, and the
gradients are averaged across ranks right after each backward pass.

Where JAX has a 1-D ``dp`` mesh and collectives inside ``shard_map``, the
port has one process per rank and a process group. Only ``all_reduce`` and
``broadcast`` are used: gloo runs both on CUDA tensors too, which is how
several ranks share one card (NCCL takes one card per rank).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch import nn


TIMEOUT_S = 600.0       # a collective that waits longer raises


def init_group(rank: int, world_size: int, backend: str, init_method: str):
    """Join the default process group as `rank` of `world_size` (the
    counterpart of ``make_mesh``) and return it. `init_method` is where the
    ranks meet, e.g. ``file:///<dir>/store`` (the same for every rank).
    NCCL places one rank per card and raises when asked for more ranks
    than there are cards; nothing ever moves to the CPU instead."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a group of {world_size}")
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if world_size > n_cards:
            raise ValueError(f"NCCL needs one card per rank: {world_size} "
                             f"ranks, {n_cards} cards")
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.group.WORLD


def _tree_map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tensors(tree) -> list[torch.Tensor]:
    """Every tensor of `tree`: a module's parameters and buffers, tensors,
    and NamedTuples, tuples, lists and dicts of them (None skipped)."""
    out = []

    def visit(x):
        if isinstance(x, nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif x is not None:
            raise TypeError(f"not a module or tensor: {type(x).__name__}")
        return x

    _tree_map(visit, tree)
    return out


def shard_batch(tree, rank: int, world_size: int):
    """The rank's share of `tree`: each tensor (or array) whose dim 0 is
    positive and divides by `world_size` gives its contiguous block of
    rows [r n / W, (r + 1) n / W); any other leaf (scalars, generators'
    seeds, a count that does not divide) stays whole, as JAX replicates
    it."""
    def take(x):
        shape = getattr(x, "shape", ())
        if len(shape) >= 1 and shape[0] > 0 and shape[0] % world_size == 0:
            per = shape[0] // world_size
            return x[rank * per:(rank + 1) * per]
        return x

    return _tree_map(take, tree)


def _in_place(collective, t: torch.Tensor) -> None:
    """`collective(t)` in place; a tensor that is not contiguous goes
    through a contiguous copy (gloo's CUDA path reads and writes it as
    one block)."""
    if t.is_contiguous():
        collective(t.data)
        return
    buf = t.detach().contiguous()
    collective(buf)
    t.data.copy_(buf)


@torch.no_grad()
def replicate_(tree, group=None):
    """Overwrite every tensor of `tree` (modules' parameters and buffers
    included) with rank 0's, in place."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in _tensors(tree):
        _in_place(lambda x: dist.broadcast(x, src, group=group), t)
    return tree


@torch.no_grad()
def psum_(tree, group=None):
    """Sum every tensor of `tree` across the ranks, in place."""
    for t in _tensors(tree):
        _in_place(lambda x: dist.all_reduce(x, dist.ReduceOp.SUM,
                                            group=group), t)
    return tree


@torch.no_grad()
def pmean_(tree, group=None):
    """Average every (floating) tensor of `tree` across the ranks, in
    place: the sum, then a division by the world size, as ``pmean``."""
    w = dist.get_world_size(group)
    for t in _tensors(psum_(tree, group)):
        t.data.div_(w)
    return tree


@torch.no_grad()
def pmean_grads_(params, group=None) -> None:
    """Average the gradients of `params` across the ranks (JAX's ``pmean``
    of a gradient tree): every ``.grad`` that is not None goes into one
    flat buffer, one ``all_reduce`` sums it, a division by the world size
    makes the mean, and the result is copied back. A None gradient stays
    None; every rank runs the same graph, so all agree on which are."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group))
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


@torch.no_grad()
def replica_gap(tree, group=None) -> float:
    """max |x - x on rank 0| over every tensor of `tree` and every rank:
    0.0 when the replicas are bitwise equal (NaNs count as a gap)."""
    gap = None
    for t in _tensors(tree):
        if t.numel() == 0:
            continue
        ref = t.detach().clone()
        replicate_(ref, group)
        d = (t.detach() - ref).abs().max().to(torch.float64)
        d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
        gap = d if gap is None else torch.maximum(gap, d)
    if gap is None:
        return 0.0
    gap = gap.reshape(1)
    dist.all_reduce(gap, dist.ReduceOp.MAX, group=group)
    return float(gap)
