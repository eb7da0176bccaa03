"""Arithmetic the metric readers in ``metrics/`` share. Each returns None
where the run holds nothing to read, so that the metric is left out of
the result line; no share of a roofline or a peak is ever given as 0 for
want of a reading."""

from __future__ import annotations

from harness import counts


def steady_seconds(run) -> float | None:
    """Mean seconds of the window's units that no profiler ran in."""
    us = run.steady_units()
    return sum(u.t1 - u.t0 for u in us) / len(us) if us else None


def span_ms_per_step(run, part: str) -> float | None:
    """A synchronised span's milliseconds per control step, over the
    units no profiler ran in."""
    us = [u for u in run.steady_units() if part in u.parts and u.steps]
    if not us:
        return None
    return 1e3 * sum(u.parts[part] for u in us) / sum(u.steps for u in us)


def share_outside(run, part: str) -> float | None:
    """Percent of the steady units' time outside the span `part`."""
    us = [u for u in run.steady_units() if part in u.parts]
    if not us:
        return None
    total = sum(u.t1 - u.t0 for u in us)
    return 100.0 * (total - sum(u.parts[part] for u in us)) / total


def device_idle(run) -> float | None:
    prof = run.profile
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)


def device_s_per_unit(run) -> float | None:
    """Seconds in which the device ran an activity, per unit: the busy
    time of the profiled control steps over their number, times the
    unit's control steps, plus the busy time of the profiled update."""
    prof = run.profile
    if (prof is None or not prof.steps.get("rollout")
            or prof.busy_tag.get("rollout", 0) <= 0
            or prof.busy_tag.get("update", 0) <= 0):
        return None
    per_step = prof.busy_tag["rollout"] / prof.steps["rollout"]
    return per_step * run.counters["steps"] + prof.busy_tag["update"]


def ops_per_step(run, tag: str = "rollout") -> float | None:
    prof = run.profile
    if prof is None or not prof.steps.get(tag):
        return None
    return prof.activities[tag] / prof.steps[tag]


def mfu(run) -> float | None:
    """The FLOPs one unit's algorithm needs, over the steady units' mean
    time and the float32 peak, in percent."""
    t = steady_seconds(run)
    f = run.counters.get("flop_per_unit")
    if not t or not f:
        return None
    return 100.0 * f / t / counts.F32_FLOP_PER_S


def _kernel_s(run, tag: str, marker: str) -> float:
    return sum(s for (t, name), s in run.profile.kernel_s.items()
               if t == tag and marker in name)


def roofline(run, kernel: str, tag: str = "rollout") -> float | None:
    """Sum of the launches' bounds over the kernel's profiled device time,
    in percent. `kernel` is the launch counter's name stem:
    ``ltdl_factor``, ``ltdl_solve`` (every right-hand-side width summed)
    or ``pgs_solve``."""
    prof = run.profile
    if prof is None:
        return None
    n_env = run.counters["n_envs"]
    bound = 0.0
    for (t, name), c in prof.launches.items():
        if t != tag or not name.startswith(kernel):
            continue
        if kernel == "ltdl_factor":
            b = counts.ltdl_factor(n_env, counts.DEPTH)
        elif kernel == "ltdl_solve":
            nr = int(name.split("R=")[1].rstrip("]"))
            b = counts.ltdl_solve(n_env, counts.DEPTH, nr)
        else:
            b = counts.pgs_solve(n_env, run.counters["contact_blocks"],
                                 run.counters["contact_iters"])
        bound += c * counts.bound_s(*b)
    marker = {"ltdl_factor": "ltdl_factor", "ltdl_solve": "ltdl_solve",
              "pgs_solve": "pgs_kernel"}[kernel]
    t = _kernel_s(run, tag, marker)
    if bound <= 0 or t <= 0:
        return None
    return 100.0 * bound / t
