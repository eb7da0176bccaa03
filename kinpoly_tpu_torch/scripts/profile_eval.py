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
        [--n-envs 64] [--steps 156]

Evaluation: one env per take, ``--steps`` control steps. ``--train``: one
``train_epoch`` of ``--n-envs`` envs x ``--steps`` control steps (rollout,
norm, GAE, PPO update) after one warm-up iteration; both under the UHC
config ``--cfg`` (a name or a YAML path; uhc by default). ``--ar``: the AR
evaluation of ``eval_ar_policy`` under the named config ``--cfg``
(checkpoint ``--ar-iter`` under ``--out``, the UHC controller
``--uhc-checkpoint``, one env per take of the config's wild bank by
default), ``--steps`` control steps after a 2-step warm-up.
``--ar-train``: composite epochs of ``train_ar_policy`` with the joint
controller (the config's widths, ``--n-envs`` envs, 64 by default, on
its training bank from checkpoint ``--ar-iter``, which is read and not
written): after a warm-up epoch of 4 control steps, one of ``--steps``
control steps (the config's rollout_steps) timed per phase (context,
rollout, PPO, BC, controller) with its peak memory, then one of 8 under
the profiler. The defaults of ``AR_DEFAULTS`` per config: kin_poly
``iter_0800.p`` under ``results_r5`` on ``wild_takes_r5.pkl`` and
``ar_train_56.pkl``; use_of ``iter_0000.p`` under ``results_r4`` on
``wild_takes_r5_of.pkl`` and ``action_takes_of.pkl``.

Prints the host wall time per control step, the device's busy share
(union of kernel intervals over the profiled wall time), device activities
and host-device synchronisations per control step, and the kernels and
operators with the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from kinpoly_tpu_torch.config.defaults import UHCConfig
from kinpoly_tpu_torch.scripts.eval_uhc import build_agent, get_takes
from kinpoly_tpu_torch.scripts.train_uhc import build_trainer

AR_PROFILE_STEPS = 8
# per named config: (evaluation bank, training bank, checkpoint, output root)
AR_DEFAULTS = {
    "kin_poly": ("data_bank/wild_takes_r5.pkl", "data_bank/ar_train_56.pkl",
                 800, "results_r5"),
    "use_of": ("data_bank/wild_takes_r5_of.pkl",
               "data_bank/action_takes_of.pkl", 0, "results_r4"),
}
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaMemcpy", "cudaMemcpyAsync", "cudaEventSynchronize")


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profiled(fn, steps: int, what: str, trace: str | None = None) -> None:
    """Run fn() once under the profiler and print where its time went,
    per control step of its `steps`."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    syncs = {n: sum(1 for e in events if e.name == n) for n in _SYNC_CALLS}
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"{what}: {wall:.3f} s, {wall / steps * 1e3:.1f} ms per control step "
          f"(host wall, profiler on), device busy {busy / 1e6 / wall:.1%}, "
          f"{len(kernels) / steps:.0f} device activities per step")
    print("host-device syncs per step: " + ", ".join(
        f"{n} {c / steps:.1f}" for n, c in syncs.items() if c))
    key = "self_device_time_total" if hasattr(
        prof.key_averages()[0], "self_device_time_total") else "self_cuda_time_total"
    print(prof.key_averages().table(sort_by=key, row_limit=25))
    if trace:
        prof.export_chrome_trace(trace)


def profile_ar_train(args) -> None:
    """A warm-up epoch of 4 control steps; one epoch at `--steps` (156)
    timed per phase; one epoch of AR_PROFILE_STEPS under the profiler
    (a whole epoch's ~5 million device activities overwhelm it)."""
    import dataclasses
    import os

    from kinpoly_tpu_torch.anim.spec import synthetic_spec
    from kinpoly_tpu_torch.config.defaults import KinPolyConfig
    from kinpoly_tpu_torch.rl import rollout_ar as roa
    from kinpoly_tpu_torch.scripts import train_ar_policy as tap

    cfg = KinPolyConfig.named(args.cfg)
    steps = args.steps or cfg.rollout_steps
    n_envs = args.n_envs or cfg.n_envs
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
                   help="training envs (UHC 1024, AR kin_poly.yml's 64)")
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
