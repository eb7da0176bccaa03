"""Kinematic-policy training: ``AgentAR.optimize_policy`` back to back.

Set-up builds the trainer as ``train_ar_policy`` does (``build_agent``:
the AR env in mode "train" on the synthetic humanoid with its five
movable objects, LTDL with K1-K3, active-set compaction (16, 8), the
frozen UHC controller of the traffic's checkpoint) at the traffic's envs
x control steps, with the kinematic policy and value net initialised from
the seed (``train_ar_policy --skip-init``), and runs the first epoch with
the harness's recorders on: the epoch's windows and the context built
from them; a sample of envs drawn from the seed at every env step, with
the controller's raw observation and the generator's state before the
step (the controller's noise is drawn inside it); the trajectory; and of
each optimiser chain its first loss and gradient and its change after
three steps. That epoch warms every shape the window uses. The window
then runs epochs back to back, starting none after ``--seconds``; in the
traffic's ``check.iteration`` the same envs are recorded again, with that
epoch's context. Once the window has closed, the traffic's
``trace.epochs`` more epochs run with control steps [first_step,
first_step + steps) of their rollouts profiled (``rollout``), the last of
them also its context build (tagged ``update``, its busy seconds also
kept as the counter ``context_busy_s``) and its updates (``update``); so
the device time per unit covers the whole epoch, its rollout's per step
averaged over the profiled epochs. In a traced run the port's spans are
on in those epochs alone.
"""

from __future__ import annotations

import dataclasses
import math
import time
import traceback

import torch

from harness import faults_ar, gaps, loops, probe
from harness.record import Unit
from harness.span_profiling import SpanStretch, SpanSummary
from harness.spec import BENCH_DIR

ROOT = BENCH_DIR.parent


class ChainSnapshots:
    """Wraps an ``AdamChain``'s ``step``: at the first step the gradient
    as the chain gets it and the parameters before it, and the parameters
    after step `n_change`."""

    def __init__(self, n_change: int = 3):
        self.n_change, self.count = n_change, 0
        self.grad1 = self.before = self.after = None

    def attach(self, chain, patch: probe.Patch) -> None:
        step = chain.step

        def snapped(*a, **kw):
            self.count += 1
            if self.count == 1:
                self.before = [p.detach().clone() for p in chain.params]
                self.grad1 = [torch.zeros_like(p) if p.grad is None
                              else p.grad.detach().clone()
                              for p in chain.params]
            out = step(*a, **kw)
            if self.count == self.n_change:
                self.after = [p.detach().clone() for p in chain.params]
            return out
        patch.set(chain, "step", snapped)

    def change(self) -> list:
        return [a - b for a, b in zip(self.after, self.before)]


def reached(prog: ChainSnapshots, ref: ChainSnapshots):
    """The two snapshots cut to the leaves whose first gradient in the
    reference is not zero: the policy chains step TrajARNet's context net
    too, which neither PPO nor the step BC reaches, and whose zero leaves
    would set the median leaf that every leaf's gap is scaled by."""
    keep = [bool(torch.any(g != 0)) for g in ref.grad1]
    out = []
    for snap in (prog, ref):
        cut = ChainSnapshots(snap.n_change)
        cut.grad1, cut.before, cut.after = (
            [x for x, k in zip(xs, keep) if k]
            for xs in (snap.grad1, snap.before, snap.after))
        out.append(cut)
    return out


class Loop(loops.Loop):
    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from kinpoly_tpu_torch import native
        from kinpoly_tpu_torch.anim.spec import synthetic_spec
        from kinpoly_tpu_torch.config.defaults import KinPolyConfig
        from kinpoly_tpu_torch.scripts import train_ar_policy as tap

        tr = self.traffic
        cfg = KinPolyConfig.named(self.config["name"])
        loops.check_config(cfg, self.config["values"])
        for k in ("n_envs", "rollout_steps"):
            if self.config[k] != tr[k]:
                raise ValueError(f"traffic {k} {tr[k]} is not the "
                                 f"configuration's {self.config[k]}")
        # the seed feeds the window sampler, the nets' initialisation and
        # the generator of every draw (actions, the controller's noise)
        cfg = dataclasses.replace(cfg, seed=self.seed)
        tc = dataclasses.replace(cfg.train_config(), n_envs=tr["n_envs"],
                                 rollout_steps=tr["rollout_steps"])
        if self.device == "cuda":
            native.build()
        takes = tap.get_takes(synthetic_spec(with_objects=True),
                              str(ROOT / tr["bank"]))
        # "float64" runs the program in double precision (the CPU parity
        # tests); the configuration's precision is float32
        dtype = torch.float64 if self.precision == "float64" else torch.float32
        agent = tap.build_agent(takes, cfg, tc, self.device, dtype=dtype,
                                uhc_checkpoint=str(ROOT / tr["checkpoint"]))
        self.init = {k: {n: v.detach().clone() for n, v in
                         m.state_dict().items()}
                     for k, m in (("policy", agent.policy.net),
                                  ("value", agent.value))}
        self.built(agent)
        self.program = agent
        self.steps, self.n_envs = tr["rollout_steps"], tr["n_envs"]
        self.window_rec = None
        self._first_epoch()

    def built(self, agent) -> None:
        if self.fault:
            self.fault_patch = faults_ar.plant(self.fault, agent)
        if self.precision == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True

    def _record_steps(self, whole_context: bool = False) -> dict:
        """Until the patch is restored, record the env step's rows of the
        checked envs (drawn from the seed), the controller's raw
        observation of those rows, the generator's state before each step
        and the epoch's context (its checked rows, or with `whole_context`
        all of it and the windows it was built from)."""
        from kinpoly_tpu_torch.envs import humanoid_ar

        agent, p = self.program, self.patch
        g = torch.Generator().manual_seed(self.seed)
        n = min(self.traffic["check"]["envs"], self.n_envs)
        idx = torch.randperm(self.n_envs, generator=g)[:n].sort().values
        idx_d = idx.to(self.device)
        rec = dict(idx=idx, steps=probe.Recorder(idx_d),
                   cc_obs=probe.Recorder(idx_d, n_args=0), gen=[])
        step = rec["steps"].wrap(agent.env.step)

        def recorded_step(*a, **kw):
            rec["gen"].append(agent.generator.get_state())
            return step(*a, **kw)
        p.set(agent.env, "step", recorded_step)
        p.set(humanoid_ar, "full_obs",
              rec["cc_obs"].wrap(humanoid_ar.full_obs))
        build = agent.build_context

        def recorded_build(batch, *a, **kw):
            ctx = build(batch, *a, **kw)
            rec["ctx"] = probe.take(ctx, None if whole_context else idx_d)
            if whole_context:
                rec["batch"] = probe.take(batch)
            return ctx
        p.set(agent, "build_context", recorded_build)
        return rec

    def _first_epoch(self) -> None:
        """The first epoch, recorded for the check."""
        agent, p = self.program, self.patch
        rec = self._record_steps(whole_context=True)
        captured = {}
        rollout = agent._rollout

        def recorded_rollout(*a, **kw):
            carry, traj = rollout(*a, **kw)
            captured.update(traj=traj._asdict(), last_obs=carry.obs)
            return carry, traj
        p.set(agent, "_rollout", recorded_rollout)
        snaps = {}
        for name in ("val_opt", "pol_opt", "sup_opt"):
            snaps[name] = ChainSnapshots()
            snaps[name].attach(getattr(agent, name), p)
        losses = {}
        backward = agent._backward

        def recorded_backward(loss, opt, *a, **kw):
            losses.setdefault(id(opt), loss.detach().clone())
            return backward(loss, opt, *a, **kw)
        p.set(agent, "_backward", recorded_backward)
        out = agent.optimize_policy()
        p.restore()
        self.first = dict(rec=rec, out=out, snaps=snaps, **captured,
                          losses={k: losses.get(id(getattr(agent, k)))
                                  for k in snaps})

    # -- window ------------------------------------------------------------

    def window(self, run, seconds: float, profile: bool = True) -> None:
        sizes = self.config["sizes"]
        run.counters.update(n_envs=self.n_envs, steps=self.steps,
                            contact_blocks=sizes["contact_blocks"],
                            contact_iters=sizes["contact_iters"])
        run.window_t0 = t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            if i == self.traffic["check"]["iteration"]:
                self.window_rec = self._record_steps()
            if not self._unit(run, profiled=False):
                return
            i += 1
        if profile:
            self._profiled_epochs(run)

    def _unit(self, run, profiled: bool) -> bool:
        """One epoch through ``optimize_policy``, counted; False if it
        failed."""
        ts = time.perf_counter()
        try:
            m = self.program.optimize_policy()
            ok = all(math.isfinite(m[k]) for k in
                     ("reward_mean", "ppo_loss", "value_loss", "bc_loss"))
        except Exception:          # a failed unit, counted
            traceback.print_exc()
            ok, m = False, None
        te = time.perf_counter()
        self.patch.restore()
        self.attempted += 1
        self.failed += 0 if ok else 1
        run.units.append(Unit(ts, te, work=self.steps * self.n_envs,
                              steps=self.steps, profiled=profiled))
        return m is not None

    def _profiled_epochs(self, run) -> None:
        """The traffic's ``trace.epochs`` epochs with control steps
        [first_step, first_step + steps) profiled (``rollout``), the last
        one also with its context build and its updates (``update``): the
        rollout's device time per step varies ~0.5% from epoch to epoch,
        and 32 times a few steps' reading would carry it whole. In a
        traced run with the port's spans on and the host's operators
        recorded."""
        from kinpoly_tpu_torch.utils import profiling

        tr = self.traffic["trace"]
        run.profile = SpanSummary()
        stretch = SpanStretch(run.profile, host=run.trace)
        profiling.enable(run.trace)
        try:
            for k in range(tr["epochs"]):
                self._profile_steps(stretch, tr["first_step"], tr["steps"])
                if k == tr["epochs"] - 1:
                    self._profile_context_and_update(run, stretch)
                self._unit(run, profiled=True)
        finally:
            profiling.enable(False)

    def _profile_steps(self, stretch: SpanStretch, first: int, n: int) -> None:
        """Until the patch is restored, profile env-step calls [first,
        first + n) (and what runs between them) as one stretch."""
        agent, calls = self.program, [0]
        step = agent.env.step

        def toggled(*a, **kw):
            if calls[0] == first:
                stretch.start()
            elif calls[0] == first + n:
                stretch.stop("rollout", n)
            calls[0] += 1
            return step(*a, **kw)
        self.patch.set(agent.env, "step", toggled)

    def _profile_context_and_update(self, run, stretch: SpanStretch) -> None:
        """Until the patch is restored, profile the epoch's context build
        (its busy seconds also as the counter ``context_busy_s``) and what
        follows the rollout, both tagged ``update``."""
        agent = self.program
        rollout, method = agent._rollout, agent.optimize_policy

        def context_then_rollout(*a, **kw):
            run.counters["context_busy_s"] = stretch.stop("update", 0)
            out = rollout(*a, **kw)
            stretch.start()
            return out

        def epoch(*a, **kw):
            stretch.start()
            out = method(*a, **kw)
            stretch.stop("update", 0)
            return out
        self.patch.set(agent, "_rollout", context_then_rollout)
        self.patch.set(agent, "optimize_policy", epoch)

    # -- check ---------------------------------------------------------------

    def check(self) -> list:
        """(name, value, limit) of every number compared: the first
        epoch's context (``ref_ar.Reference.context_numbers``); one env
        step of each recorded env and control step, of the first epoch and
        of the window's checked one together (``step_numbers``); and on
        the first epoch the policy's log-probability of every action taken
        (the step GRU re-run over the trajectory), the first PPO epoch's
        value and policy losses, the first step-BC loss (from the
        parameters the program started its step BC from), and each
        chain's first gradient and its change after three steps."""
        from harness import ref_ar
        f = self.first
        ref = ref_ar.Reference(self.config, self.traffic, ROOT, self.device)
        policy, value = ref.nets(self.init)
        out = ref.context_numbers(policy, f["rec"]["batch"], f["rec"]["ctx"])
        out += ref.step_numbers([r for r in (f["rec"], self.window_rec)
                                 if r and r["steps"].calls], self.n_envs)
        traj = ref_ar.to_ref(f["traj"], self.device)
        out.append(("policy_logp", ref.logp_gap(policy, traj,
                                                f["traj"]["log_probs"])))
        snaps = {}

        def attach(name, chain):
            snaps[name] = ChainSnapshots()
            snaps[name].attach(chain, probe.Patch())
        ppo = ref.ppo(policy, value, traj,
                      ref_ar.to_ref(f["last_obs"], self.device), attach)
        bc = ref.bc(f["snaps"]["sup_opt"].before, traj, attach)
        ls, ps = f["losses"], f["snaps"]
        out.append(("value_loss", abs(float(ls["val_opt"]) - ppo[0][0])
                    / max(abs(ppo[0][0]), 1e-30)))
        out.append(("ppo_loss", abs(float(ls["pol_opt"]) - ppo[0][1])))
        out.append(("bc_loss", abs(float(ls["sup_opt"]) - bc[0])
                    / max(abs(bc[0]), 1e-30)))
        for group, names in (("ppo", ("val_opt", "pol_opt")),
                             ("bc", ("sup_opt",))):
            grad1 = change3 = 0.0
            for k in names:
                p, r = reached(ps[k], snaps[k])
                grad1 = max(grad1, gaps.leaf_norm_gap(p.grad1, r.grad1))
                change3 = max(change3, gaps.leaf_norm_gap(
                    p.change(), r.change(), gaps.moved_leaves(r.grad1)))
            out += [(f"{group}_grad1", grad1), (f"{group}_change3", change3)]
        limits = self.traffic["limits"]
        return [(name, v, limits.get(name, float("nan"))) for name, v in out]
