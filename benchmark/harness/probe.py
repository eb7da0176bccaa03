"""Instruments the harness sets on the program's objects (instance
attributes only; the program's code is not touched) and takes off again:
a recorder of a sample of envs at every env step, a synchronised span
around a call, optimizer-step snapshots, and the profiler's toggles at
fixed control steps."""

from __future__ import annotations

import time

import torch


def _same(x: tuple, items):
    """A tuple of x's type (a NamedTuple or a plain tuple) of `items`."""
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def take(x, idx=None):
    """x[idx] (all of x if idx is None), detached and copied, through
    nested tuples (None leaves stay None)."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return _same(x, (take(y, idx) for y in x))
    return (x if idx is None else x[idx]).detach().clone()


def stack(xs: list):
    """Concatenate nested NamedTuples of tensors along their first dim."""
    x0 = xs[0]
    if x0 is None:
        return None
    if isinstance(x0, tuple):
        return _same(x0, (stack([x[i] for x in xs]) for i in range(len(x0))))
    return torch.cat(xs, dim=0)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Patch:
    """Set attributes on objects and restore them: ``set(obj, name, value)``
    then ``restore()``."""

    def __init__(self):
        self._undo = []

    def set(self, obj, name: str, value) -> None:
        had = name in vars(obj)
        self._undo.append((obj, name, had, vars(obj).get(name)))
        setattr(obj, name, value)

    def restore(self) -> None:
        for obj, name, had, old in reversed(self._undo):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo = []


class Recorder:
    """Wraps a function (``env.step``, ``policy.action_mean``): keeps every
    call's first `n_args` positional arguments and its output, for the
    rows `idx` (all rows if None), as copies on the device."""

    def __init__(self, idx=None, n_args: int = 2):
        self.idx, self.n_args = idx, n_args
        self.calls = []

    def wrap(self, fn):
        def recorded(*a, **kw):
            out = fn(*a, **kw)
            self.calls.append(dict(args=take(a[:self.n_args], self.idx),
                                   out=take(out, self.idx)))
            return out
        return recorded

    def stacked(self):
        """(arguments, output), each call's rows concatenated."""
        return (stack([c["args"] for c in self.calls]),
                stack([c["out"] for c in self.calls]))


class AdamSnapshots:
    """Wraps a ``torch.optim.Adam``'s ``step`` (``attach``): the first
    gradient as the optimizer got it (its first moment after step 1, over
    1 - beta1), and the parameters before step 1 and after step
    `n_change`, as far as step n_change + 1 keeps them. An optimizer that kept no state moved nothing: its first
    gradient reads zero."""

    def __init__(self, n_change: int = 3):
        self.n_change = n_change
        self.count = 0
        self.grad1 = self.before = self.after = None

    def attach(self, opt, patch: "Patch") -> None:
        params = [p for g in opt.param_groups for p in g["params"]]
        beta1 = opt.param_groups[0]["betas"][0]
        moments = lambda: [opt.state[p].get("exp_avg") for p in params]
        self.before = [p.detach().clone() for p in params]
        step = opt.step

        def snapped(*a, **kw):
            out = step(*a, **kw)
            self.count += 1
            if self.count == 1:
                self.grad1 = [torch.zeros_like(p) if m is None
                              else m.detach() / (1 - beta1)
                              for p, m in zip(params, moments())]
            if self.count == self.n_change:
                self.after = [p.detach().clone() for p in params]
            return out
        patch.set(opt, "step", snapped)

    def change(self) -> list:
        return [a - b for a, b in zip(self.after, self.before)]


def timed(fn, device, sink: list):
    """fn wrapped in a synchronised span; appends each call's seconds to
    `sink`."""
    def span(*a, **kw):
        sync(device)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync(device)
        sink.append(time.perf_counter() - t0)
        return out
    return span
