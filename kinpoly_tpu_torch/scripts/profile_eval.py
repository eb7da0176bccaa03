"""Where the time of UHC evaluation or training, or of the AR evaluation
or training, goes on the card: torch.profiler over a few control steps of
an evaluation loop, or over one training iteration or epoch.

    python -m kinpoly_tpu_torch.scripts.profile_eval --steps 3 \\
        [--data data_bank/clips24.pkl] [--trace eval_trace.json]
    python -m kinpoly_tpu_torch.scripts.profile_eval --train \\
        [--cfg uhc | --cfg my_explicit.yml] [--data data_bank/clips24.pkl] \\
        [--n-envs 1024] [--steps 8]
    python -m kinpoly_tpu_torch.scripts.profile_eval --ar --steps 5 \\
        [--cfg use_of] [--data BANK] [--ar-iter N --out DIR]
    python -m kinpoly_tpu_torch.scripts.profile_eval --ar-train \
        [--cfg use_of] [--data BANK] [--ar-iter N --out DIR] \
        [--n-envs 320] [--steps 32]

Evaluation: one env per take, ``--steps`` control steps. ``--train``: one
``train_epoch`` of ``--n-envs`` envs x ``--steps`` control steps (rollout,
norm, GAE, PPO update) after one warm-up iteration; both under the UHC
config ``--cfg`` (a name or a YAML path; uhc by default). ``--ar``: the AR
evaluation of ``eval_ar_policy`` under the named config ``--cfg``
(checkpoint ``--ar-iter`` under ``--out``, the UHC controller
``--uhc-checkpoint``, one env per take of the config's wild bank by
default), ``--steps`` control steps after a 2-step warm-up.
``--ar-train``: composite epochs of ``train_ar_policy`` with the joint
controller (the config's widths, ``--n-envs`` envs x ``--steps`` control
steps: kin_poly 320 x 32 by default, the benchmark cell
``kin_poly.train.e320x32``'s 10,240-sample epoch, use_of its config's;
on its training bank from checkpoint ``--ar-iter``, which is read and not
written): after a warm-up epoch of 4 control steps, one of ``--steps``
control steps timed per phase (context,
rollout, PPO, BC, controller) with its peak memory, then one of 8 under
the profiler. The defaults of ``AR_DEFAULTS`` per config: kin_poly
``iter_0800.p`` under ``results_r5`` on ``wild_takes_r5.pkl`` and
``ar_train_56.pkl``; use_of ``iter_0000.p`` under ``results_r4`` on
``wild_takes_r5_of.pkl`` and ``action_takes_of.pkl``.

Prints the host wall time per control step, the device's busy share
(union of kernel intervals over the profiled wall time), the trace's busy
and idle ms, device activities, host-device synchronisations and the
port's host counters (``profiling.COUNTS``: ``fk``, FK calls) and kernel
launches (``native.LAUNCHES``; ``fk_tree`` and ``fk_tree[frames]``
together equal ``fk`` on the card) per control step, the kernels and
operators with the most device time, and a table of the port's spans
(``utils/profiling.py``, on while profiling; their layers in
``GROUPS``): per control step, each span's calls and, of the work it did
itself (not in a span nested in it), its device ms (the busy
union of the activities launched while it was the innermost span open),
the device's idle ms while it was innermost on the host, its activities
and host-device syncs; then the same summed by layer. The profiler's
user annotations (the spans, ``Optimizer.step#...``) are left out of the
busy union, the activity count and the operator table; an annotation
not in ``GROUPS`` is no span. ``--trace`` writes a Chrome trace that
carries the spans. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import time
from collections import Counter

import torch
from torch.autograd.profiler_util import EventList
from torch.profiler import ProfilerActivity, profile

from kinpoly_tpu_torch import native
from kinpoly_tpu_torch.config.defaults import UHCConfig
from kinpoly_tpu_torch.scripts.eval_uhc import build_agent, get_takes
from kinpoly_tpu_torch.scripts.train_uhc import build_trainer
from kinpoly_tpu_torch.utils import profiling

AR_PROFILE_STEPS = 8
# per named config: (evaluation bank, training bank, checkpoint, output root)
AR_DEFAULTS = {
    "kin_poly": ("data_bank/wild_takes_r5.pkl", "data_bank/ar_train_56.pkl",
                 800, "results_r5"),
    "use_of": ("data_bank/wild_takes_r5_of.pkl",
               "data_bank/action_takes_of.pkl", 0, "results_r4"),
}
# per named config: the AR training epoch's (envs, control steps) by
# default, where it is not the config's own
AR_TRAIN_SHAPE = {"kin_poly": (320, 32)}
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaMemcpy", "cudaMemcpyAsync", "cudaEventSynchronize")


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


# The port's spans (``utils/profiling.py``) and the layer each belongs to.
# The profiler's other user annotations (``Optimizer.step#Adam.step``)
# are no spans: what runs inside them goes to the span around them.
GROUPS = {
    "uhc.train_epoch": "loop", "uhc.rollout": "loop", "uhc.host_fetch": "loop",
    "uhc.policy": "policy",
    "env.step": "env", "env.observe": "env", "env.reward": "env",
    "env.reset": "env",
    "physics.fk": "fk",
    "physics.dof_frames": "dynamics", "physics.bias_force": "dynamics",
    "physics.crba": "dynamics", "physics.substep": "dynamics",
    "physics.control_step": "dynamics",
    "physics.contact_plan": "contacts", "physics.contacts": "contacts",
    "physics.factor": "solve", "physics.solve": "solve", "physics.pgs": "solve",
    "uhc.update": "ppo", "ppo.update": "ppo",
    "optim.step": "optim",
    "ar.context": "ar", "ar.rollout": "ar", "ar.ppo": "ar", "ar.bc": "ar",
    "ar.kin_policy": "kin_policy",
    # the frozen controller's step in the env, and the joint-controller
    # phase of the update (the agent's ``_phase("controller")``)
    "ar.controller": "controller",
    "physics.objects": "objects",
}
NO_SPAN = "(no span)"


class _Innermost:
    """The innermost of (nested) host spans open at each moment."""

    def __init__(self, spans: list):
        marks = sorted([(e.time_range.start, 1, -e.time_range.end, i)
                        for i, e in enumerate(spans)]
                       + [(e.time_range.end, 0, 0, i)
                          for i, e in enumerate(spans)])
        self.starts, self.names, open_ = [], [], []
        for t, is_start, _, i in marks:
            if is_start:
                open_.append(i)
            else:
                open_.remove(i)
            self.starts.append(t)
            self.names.append(spans[open_[-1]].name if open_ else NO_SPAN)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.names[i] if i >= 0 else NO_SPAN

    def split(self, a: float, b: float) -> Counter:
        """Length of [a, b] under each innermost span."""
        lo = bisect.bisect_right(self.starts, a)
        hi = bisect.bisect_left(self.starts, b)
        cuts = [a, *self.starts[lo:hi], b]
        out = Counter()
        for x, y in zip(cuts, cuts[1:]):
            out[self.at(x)] += y - x
        return out


def _gaps(intervals: list[tuple[float, float]], t0: float, t1: float):
    """The stretches of [t0, t1] that no interval covers."""
    end = t0
    for a, b in sorted(intervals):
        if a > end:
            yield end, a
        end = max(end, b)
    if t1 > end:
        yield end, t1


def device_activities(events) -> list:
    """The trace's device activities: its CUDA-typed events but the user
    annotations, whose device twins span the idle time inside them."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def span_table(events, steps: int) -> list:
    """Rows (span, calls, device ms, idle ms, activities, syncs), each per
    control step, by device ms: what ran, and how long the device waited,
    while each span was the innermost one open. A device activity goes to
    the span open when the runtime call that launched it (same correlation
    id) started; autograd's device threads launch the backward's kernels
    while the caller waits in its span. Each idle gap of the trace (from
    its first event to its last device activity) is split by overlap among
    the spans innermost on the host during it."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    spans = [e for e in cpu if e.is_user_annotation and e.name in GROUPS]
    inner = _Innermost(spans)
    runtime = {e.id: e for e in cpu if e.name.startswith("cu")}
    iv, acts, syncs, idle = {}, Counter(), Counter(), Counter()
    kernels = device_activities(events)
    for k in kernels:
        call = runtime.get(k.id)
        name = inner.at((call or k).time_range.start)
        iv.setdefault(name, []).append((k.time_range.start, k.time_range.end))
        acts[name] += 1
    for e in cpu:
        if e.name in _SYNC_CALLS:
            syncs[inner.at(e.time_range.start)] += 1
    if kernels:
        every = [x for xs in iv.values() for x in xs]
        t0 = min(e.time_range.start for e in events)
        for a, b in _gaps(every, t0, max(b for _, b in every)):
            idle.update(inner.split(a, b))
    calls = Counter(e.name for e in spans)
    rows = [(name, calls[name] / steps,
             _busy_us(iv.get(name, [])) / 1e3 / steps, idle[name] / 1e3 / steps,
             acts[name] / steps, syncs[name] / steps)
            for name in set(calls) | set(acts) | set(syncs) | set(idle)]
    return sorted(rows, key=lambda r: -r[2])


def group_table(rows: list) -> list:
    """`span_table`'s rows summed by layer (``GROUPS``; "none" outside
    every span): (group, device ms, idle ms, activities, syncs)."""
    sums = {}
    for name, _, *cols in rows:
        g = GROUPS.get(name, "none")
        sums[g] = [a + b for a, b in zip(sums.get(g, [0.0] * 4), cols)]
    return sorted(((g, *cols) for g, cols in sums.items()),
                  key=lambda r: -r[1])


def profiled(fn, steps: int, what: str, trace: str | None = None) -> None:
    """Run fn() once under the profiler, with the port's spans on, and
    print where its time went, per control step of its `steps`."""
    torch.cuda.synchronize()
    counts = Counter(profiling.COUNTS)
    launches = Counter(native.LAUNCHES)
    profiling.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        profiling.enable(False)
    counts = profiling.COUNTS - counts
    launches = native.LAUNCHES - launches
    events = prof.events()
    kernels = device_activities(events)
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in events))
    syncs = {n: sum(1 for e in events if e.name == n) for n in _SYNC_CALLS}
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"{what}: {wall:.3f} s, {wall / steps * 1e3:.1f} ms per control step "
          f"(host wall, profiler on), device busy {busy / 1e6 / wall:.1%}, "
          f"{len(kernels) / steps:.0f} device activities per step")
    print(f"trace per control step: busy {busy / 1e3 / steps:.3f} ms, idle "
          f"{(span_us - busy) / 1e3 / steps:.3f} ms (first event to last "
          f"device activity)")
    print("host-device syncs per step: " + ", ".join(
        f"{n} {c / steps:.1f}" for n, c in syncs.items() if c))
    print("counters per step: " + ", ".join(
        f"{n} {c / steps:.1f}" for n, c in sorted(counts.items())))
    print("kernel launches per step: " + ", ".join(
        f"{n} {c / steps:.1f}" for n, c in sorted(launches.items())))
    ops = EventList([a for a in prof.key_averages()
                     if not a.is_user_annotation], use_device="cuda")
    key = "self_device_time_total" if hasattr(
        ops[0], "self_device_time_total") else "self_cuda_time_total"
    print(ops.table(sort_by=key, row_limit=25))
    rows = span_table(events, steps)
    print(f"{'span':<24} {'calls':>8} {'device ms':>10} {'idle ms':>10} "
          f"{'activities':>11} {'syncs':>6}   (per control step, own work)")
    for name, n, ms, idle, a, sy in rows:
        print(f"{name:<24} {n:>8.1f} {ms:>10.3f} {idle:>10.3f} {a:>11.1f} "
              f"{sy:>6.1f}")
    print(f"{'group':<24} {'':>8} {'device ms':>10} {'idle ms':>10} "
          f"{'activities':>11} {'syncs':>6}   (the spans above by layer)")
    for g, ms, idle, a, sy in group_table(rows):
        print(f"{g:<24} {'':>8} {ms:>10.3f} {idle:>10.3f} {a:>11.1f} "
              f"{sy:>6.1f}")
    if trace:
        prof.export_chrome_trace(trace)


def profile_ar_train(args) -> None:
    """A warm-up epoch of 4 control steps; one epoch at `--steps` (32)
    timed per phase; one epoch of AR_PROFILE_STEPS under the profiler
    (a whole epoch's ~5 million device activities overwhelm it)."""
    import dataclasses
    import os

    from kinpoly_tpu_torch.anim.spec import synthetic_spec
    from kinpoly_tpu_torch.config.defaults import KinPolyConfig
    from kinpoly_tpu_torch.rl import rollout_ar as roa
    from kinpoly_tpu_torch.scripts import train_ar_policy as tap

    cfg = KinPolyConfig.named(args.cfg)
    n_envs, steps = AR_TRAIN_SHAPE.get(args.cfg,
                                       (cfg.n_envs, cfg.rollout_steps))
    n_envs, steps = args.n_envs or n_envs, args.steps or steps
    tc = dataclasses.replace(cfg.train_config(), joint_controller=True,
                             n_envs=n_envs, rollout_steps=steps)
    takes = tap.get_takes(synthetic_spec(with_objects=True),
                          args.data or AR_DEFAULTS[args.cfg][1])
    agent = tap.build_agent(takes, cfg, tc, "cuda",
                            uhc_checkpoint=args.uhc_checkpoint)
    agent.load_checkpoint(os.path.join(cfg.model_dir(args.out),
                                       f"iter_{args.ar_iter:04d}.p"))
    full = agent._rollout
    agent._rollout = roa.make_ar_rollout(agent.env, agent.policy, 4)
    agent.optimize_policy()                                     # warm-up
    agent._rollout = full
    torch.cuda.reset_peak_memory_stats()
    agent.time_phases, agent.phase_s = True, {}
    m = agent.optimize_policy()
    ph = agent.phase_s
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"one AR training epoch, {n_envs} envs x {steps} control steps: "
          f"{m['T_iter']:.2f} s; context {ph['context']:.3f} s, rollout "
          f"{ph['rollout']:.2f} s ({ph['rollout'] / steps * 1e3:.1f} ms per "
          f"control step), " + ", ".join(
              f"{k} {ph[k]:.3f} s" for k in ("ppo", "bc", "controller")
              if k in ph) + f"; peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    agent.time_phases = False
    agent._rollout = roa.make_ar_rollout(agent.env, agent.policy,
                                         AR_PROFILE_STEPS)
    profiled(agent.optimize_policy, AR_PROFILE_STEPS,
             f"one AR training epoch, {n_envs} envs x {AR_PROFILE_STEPS} "
             f"control steps", args.trace)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", action="store_true",
                   help="profile one training iteration instead")
    p.add_argument("--iter", type=int, default=13000,
                   help="checkpoint of the evaluation")
    p.add_argument("--data", default=None,
                   help="expert bank (data_bank/*.pkl); default: seeded clips")
    p.add_argument("--clips", type=int, default=None)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--n-envs", type=int, default=None,
                   help="training envs (UHC 1024, AR kin_poly 320)")
    p.add_argument("--steps", type=int, default=None,
                   help="control steps (evaluation 3, training 8)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default=None, help="write a chrome trace here")
    p.add_argument("--ar", action="store_true",
                   help="profile the AR evaluation instead")
    p.add_argument("--cfg", default=None,
                   help="the AR phases' named config (kin_poly, use_of); "
                        "else a UHC config name or YAML path (uhc)")
    p.add_argument("--ar-iter", type=int, default=None)
    p.add_argument("--out", default=None,
                   help="output root of the AR checkpoint")
    p.add_argument("--uhc-checkpoint",
                   default="results/motion_im/uhc/models/iter_13000.p")
    p.add_argument("--ar-train", action="store_true",
                   help="time and profile AR training epochs instead")
    args = p.parse_args(argv)
    if args.ar or args.ar_train:
        args.cfg = args.cfg or "kin_poly"
        if args.cfg not in AR_DEFAULTS:
            p.error(f"--cfg {args.cfg!r}: the AR phases take "
                    f"{sorted(AR_DEFAULTS)}")
        _, _, ar_iter, out = AR_DEFAULTS[args.cfg]
        args.ar_iter = ar_iter if args.ar_iter is None else args.ar_iter
        args.out = args.out or out
    else:
        args.cfg = args.cfg or "uhc"

    if args.ar_train:
        profile_ar_train(args)
        return

    if args.ar:
        from kinpoly_tpu_torch.anim.spec import synthetic_spec
        from kinpoly_tpu_torch.config.defaults import KinPolyConfig
        from kinpoly_tpu_torch.scripts import eval_ar_policy as ear

        steps = args.steps or 3
        takes = ear.get_takes(synthetic_spec(with_objects=True),
                              args.data or AR_DEFAULTS[args.cfg][0],
                              args.clips, args.frames)
        ev = ear.build_eval(takes, args.ar_iter, "cuda",
                            uhc_checkpoint=args.uhc_checkpoint,
                            out_root=args.out,
                            cfg=KinPolyConfig.named(args.cfg))
        ear.rollout(ev, 2)                                      # warm-up
        profiled(lambda: ear.rollout(ev, steps), steps,
                 f"AR evaluation, {ev.n_takes} envs x {steps} control steps",
                 args.trace)
        return
    takes = get_takes(args.data, args.clips, args.frames, args.seed)
    if args.train:
        steps = args.steps or 8
        cfg = UHCConfig.load(args.cfg)
        n_envs = args.n_envs or 1024
        agent = build_trainer(takes, cfg, n_envs, steps, device="cuda")
        agent.train_epoch(adaptive=cfg.adaptive_params(0))      # warm-up
        profiled(lambda: agent.train_epoch(adaptive=cfg.adaptive_params(1)),
                 steps, f"one training iteration, {n_envs} envs x {steps} "
                 f"control steps", args.trace)
    else:
        steps = args.steps or 3
        agent = build_agent(args.iter, takes, "cuda", cfg_name=args.cfg)
        agent.eval_coverage(max_steps=2)                        # warm-up
        profiled(lambda: agent.eval_coverage(max_steps=steps), steps,
                 f"evaluation, {len(takes)} envs x {steps} control steps",
                 args.trace)


if __name__ == "__main__":
    main()
