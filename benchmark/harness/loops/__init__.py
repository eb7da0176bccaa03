"""The traffic generators, one per kind of loop a traffic file names
(``"loop"``): each builds the port's entry point from a configuration and a
traffic file, drives it back to back through the window and checks what it
produced against the reference. ``Loop`` holds what they share."""

from __future__ import annotations

import dataclasses

import torch

from harness import faults, probe
from harness.profiling import Stretch


def check_config(cfg, values: dict) -> None:
    """The program's named configuration must hold the file's values."""
    have = dataclasses.asdict(cfg)
    norm = lambda v: list(v) if isinstance(v, tuple) else v
    diff = {k: (norm(have.get(k)), v) for k, v in values.items()
            if norm(have.get(k)) != v}
    if diff:
        raise ValueError(f"the program's config {cfg.name!r} differs from its "
                         f"file (program, file): {diff}")


class Loop:
    """A cell's loop: its configuration and traffic, the seed, the device,
    the precision ("tf32" is the control) and a planted fault; the counts
    of units attempted and failed; the patches it sets on the program."""

    def __init__(self, cell, seed: int, device: str = "cuda",
                 precision: str = "float32", fault: str | None = None):
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.device, self.precision = seed, device, precision
        self.fault, self.fault_patch = fault, None
        self.attempted = self.failed = 0
        self.patch = probe.Patch()
        self.program = None

    def built(self, agent) -> None:
        """After set-up has built the agent: plant the fault, and with the
        control switch TF32 on."""
        if self.fault:
            self.fault_patch = faults.plant(self.fault, agent)
        if self.precision == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        if self.fault_patch is not None:
            self.fault_patch.restore()
        self.program = None
        if self.device == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def profile_unit(self, run, agent, unit: str, first: int, n: int,
                     rollout=None) -> None:
        """Profile one unit (the agent's method `unit`) in two stretches:
        control steps [first, first + n) of its rollout, started and
        stopped at env-step calls, and what follows the rollout's return
        (the updates) to the unit's end. `rollout` replaces the agent's
        rollout call (a timed span of it)."""
        p, stretch, calls = self.patch, Stretch(run.profile), [0]
        step, rollout = agent.env.step, rollout or agent._rollout
        method = getattr(agent, unit)

        def toggled(*a, **kw):
            if calls[0] == first:
                stretch.start()
            elif calls[0] == first + n:
                stretch.stop("rollout", n)
            calls[0] += 1
            return step(*a, **kw)

        def rollout_then_update(*a, **kw):
            out = rollout(*a, **kw)
            stretch.start()
            return out

        def unit_then_stop(*a, **kw):
            out = method(*a, **kw)
            stretch.stop("update", 0)
            return out
        p.set(agent.env, "step", toggled)
        p.set(agent, "_rollout", rollout_then_update)
        p.set(agent, unit, unit_then_stop)
