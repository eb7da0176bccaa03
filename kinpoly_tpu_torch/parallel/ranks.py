"""Spawned ranks on one host: a pool of W processes that join one process
group, then run the jobs the parent hands them, each job on every rank at
once.

    with RankPool(2, backend="gloo") as pool:       # on CUDA
        results = pool.run(job, *args)      # [job(rank 0, *args), ...]

A job is a function importable by module and name (the children are
started with ``spawn``: the parent may already hold a CUDA context), called
as ``job(rk, *args)`` with ``rk`` a :class:`Rank`. Arguments and results
travel as ordinary pickles, so every rank gets its own copy of a tensor
(never a view of shared memory). A job that raises on any rank, or a rank
that dies, makes ``run`` raise in the parent, which then ends every rank;
``run`` also raises when a job outlasts its timeout.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
import weakref
from typing import NamedTuple

import torch
import torch.distributed

from kinpoly_tpu_torch import resolve_device
from kinpoly_tpu_torch.parallel import mesh
from kinpoly_tpu_torch.parallel.mesh import TIMEOUT_S     # also a job's limit


class Rank(NamedTuple):
    rank: int
    world_size: int
    group: object           # the process group
    device: torch.device


def _serve(rank: int, world_size: int, backend: str, init_method: str,
           device: str, threads: int, jobs, results) -> None:
    """A rank's loop: join the group, then run jobs until told to stop."""
    try:
        torch.set_num_threads(threads)
        # the ranks share one host: gloo connects them over the loopback
        # device, whatever the host name resolves to
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank if backend == "nccl" else 0)
            torch.cuda.set_device(dev)
        group = mesh.init_group(rank, world_size, backend, init_method)
        rk = Rank(rank, world_size, group, dev)
        results.put((rank, "ready", None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    parent = mp.parent_process()
    while True:
        try:
            blob = jobs.get(timeout=2.0)
        except queue.Empty:
            if parent is not None and not parent.is_alive():
                break           # the parent ended without closing the pool
            continue
        if blob is None:
            break
        try:
            fn, args = pickle.loads(blob)
            out = pickle.dumps(fn(rk, *args))
            results.put((rank, "done", out))
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))
            break
    torch.distributed.destroy_process_group()


_LIVE = weakref.WeakSet()


def kill_all() -> None:
    """Kill the ranks of every pool still open (for a watchdog that is
    about to end the parent with ``os._exit``)."""
    for pool in list(_LIVE):
        for p in pool._procs:
            if p.is_alive():
                p.kill()


class RankPool:
    """`n_ranks` spawned processes in one process group of `backend`
    ("gloo", or "nccl" with one card per rank) on `device` (CUDA unless
    the caller asks for the CPU, as ``resolve_device``; gloo ranks share
    card 0). Each child runs ``torch.set_num_threads(threads)``. The ranks
    meet through a file store in a fresh temporary directory, so no port
    is taken and no network is needed. The processes start at construction; the first job waits
    for them to join."""

    def __init__(self, n_ranks: int, backend: str = "gloo",
                 device=None, threads: int = 1):
        self.n = n_ranks
        device = resolve_device(device).type
        self._dir = tempfile.mkdtemp(prefix="rankpool-")
        init_method = "file://" + os.path.join(self._dir, "store")
        ctx = mp.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(n_ranks)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_serve, daemon=True, args=(
                r, n_ranks, backend, init_method, device, threads,
                self._jobs[r], self._results))
            for r in range(n_ranks)]
        self._ready = self._closed = False
        _LIVE.add(self)
        for p in self._procs:
            p.start()

    def _collect(self, tag: str) -> list:
        got = {}
        deadline = time.monotonic() + TIMEOUT_S
        while len(got) < self.n:
            try:
                rank, status, payload = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if p.exitcode is not None and r not in got]
                if dead:
                    self.close(5.0)
                    raise RuntimeError(f"rank(s) {dead} died during {tag} "
                                       f"(exit codes "
                                       f"{[self._procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    self.close(5.0)
                    raise TimeoutError(f"{tag}: no result from ranks "
                                       f"{sorted(set(range(self.n)) - set(got))} "
                                       f"after {TIMEOUT_S:.0f} s")
                continue
            if status == "error":
                self.close(5.0)
                raise RuntimeError(f"rank {rank} failed in {tag}:\n{payload}")
            got[rank] = payload
        return [got[r] for r in range(self.n)]

    def run(self, fn, *args) -> list:
        """fn(rk, *args) on every rank (after waiting for the ranks to
        join, the first time); the results in rank order."""
        if not self._ready:
            self._collect("start-up")
            self._ready = True
        blob = pickle.dumps((fn, args))
        for q in self._jobs:
            q.put(blob)
        tag = getattr(fn, "__name__", "job")
        return [pickle.loads(b) for b in self._collect(tag)]

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the ranks: ask, wait up to `timeout_s`, then kill."""
        if self._closed:
            return
        self._closed = True
        _LIVE.discard(self)
        for q, p in zip(self._jobs, self._procs):
            if p.is_alive():
                q.put(None)
        deadline = time.monotonic() + timeout_s
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join()
        for q in self._jobs + [self._results]:
            q.close()
            q.cancel_join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
