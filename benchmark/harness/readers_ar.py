"""Arithmetic of the kinematic-policy cell's metric readers, over a run's
``span_profiling.SpanSummary`` and counters. Each returns None where the
run holds nothing to read (no profiled stretch, or a program without the
span or counter), so that the metric is left out of the result line."""

from __future__ import annotations


def _steps(run) -> int:
    prof = run.profile
    return 0 if prof is None else prof.steps.get("rollout", 0)


def rollout_ms_per_step(run) -> float | None:
    """Busy milliseconds of the profiled rollout stretch per control step."""
    n = _steps(run)
    return 1e3 * run.profile.busy_tag["rollout"] / n if n else None


def context_ms(run) -> float | None:
    """Busy milliseconds of the profiled context build."""
    s = run.counters.get("context_busy_s")
    return None if s is None else 1e3 * s


def update_ms(run) -> float | None:
    """Busy milliseconds of the profiled updates: the ``update`` tag's
    busy time without the context build's."""
    s = run.counters.get("context_busy_s")
    if run.profile is None or s is None:
        return None
    return 1e3 * (run.profile.busy_tag.get("update", 0.0) - s)


def group_ms_per_step(run, group: str) -> float | None:
    """Busy milliseconds per control step of the device activities the
    rollout stretch gave to span group `group`."""
    n = _steps(run)
    s = getattr(run.profile, "group_s", {}).get(("rollout", group)) if n else None
    return None if not s else 1e3 * s / n


def count_per_step(run, name: str) -> float | None:
    """The port's host counter `name` per control step of the rollout
    stretch."""
    n = _steps(run)
    c = getattr(run.profile, "counts", {}).get(("rollout", name)) if n else None
    return None if not c else c / n
