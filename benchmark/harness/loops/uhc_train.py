"""UHC training: ``UHCAgent.train_epoch`` back to back.

Set-up builds the trainer of the configuration (``train_uhc``'s
``build_trainer``, LTDL with K1-K3 and the contact plan) at the traffic's
envs x control steps, loads the traffic's checkpoint and runs the first
iteration through ``train_epoch`` with the harness's recorders on: a
sample of envs drawn from the seed at every env step, the trajectory and
the generator's state after the rollout, and Adam's state after the first
and third steps of each net. That iteration warms every shape the window
uses. The window then runs iterations back to back, starting none after
``--seconds``; in one of them (the traffic's ``check.iteration``, after
the first call has built and cached what it builds) the same envs are
recorded at every env step again. Once the window has closed, one more
iteration runs with a fixed stretch profiled (a few control steps of its
rollout, and its update): its device time is an end-to-end metric, and in
a traced run its trace feeds the per-layer ones.
"""

from __future__ import annotations

import dataclasses
import math
import time
import traceback

import torch

from harness import counts, gaps, loops, probe
from harness.profiling import Summary
from harness.record import Unit
from harness.spec import BENCH_DIR

ROOT = BENCH_DIR.parent


class Loop(loops.Loop):
    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from kinpoly_tpu_torch import native
        from kinpoly_tpu_torch.config.defaults import UHCConfig
        from kinpoly_tpu_torch.data.banks import load_hard_states
        from kinpoly_tpu_torch.scripts.eval_uhc import get_takes
        from kinpoly_tpu_torch.scripts.train_uhc import build_trainer

        tr = self.traffic
        cfg = UHCConfig.named(self.config["name"])
        loops.check_config(cfg, self.config["values"])
        # the seed feeds the agent's generator: every draw of the rollouts
        # (clips, resets, exploration) and of the PPO minibatches
        cfg = dataclasses.replace(cfg, seed=self.seed)
        if self.device == "cuda":
            native.build()
        takes = get_takes(str(ROOT / tr["bank"]))
        hard = (load_hard_states(str(ROOT / tr["hard_states"]))
                if tr.get("hard_states") else None)
        agent = build_trainer(takes, cfg, tr["n_envs"], tr["rollout_steps"],
                              hard_states=hard, device=self.device)
        agent.load_checkpoint(str(ROOT / tr["checkpoint"]))
        self.built(agent)
        self.cfg, self.program = cfg, agent
        self.steps, self.n_envs = tr["rollout_steps"], tr["n_envs"]
        self._first_iteration()

    def _record_steps(self) -> probe.Recorder:
        """Record the env step's rows of the checked envs (drawn from the
        seed) until the patch is restored."""
        g = torch.Generator().manual_seed(self.seed)
        n = min(self.traffic["check"]["envs"], self.n_envs)
        idx = torch.randperm(self.n_envs, generator=g)[:n].sort().values
        rec = probe.Recorder(idx.to(self.device))
        self.patch.set(self.program.env, "step",
                       rec.wrap(self.program.env.step))
        return rec

    def _first_iteration(self) -> None:
        """The first iteration, recorded for the check."""
        agent, p = self.program, self.patch
        rec = self._record_steps()
        captured = {}
        rollout = agent._rollout

        def recorded_rollout(*a, **kw):
            carry, traj = rollout(*a, **kw)
            captured.update(traj=traj._asdict(), carry_obs=carry.obs,
                            gen_state=agent.generator.get_state())
            return carry, traj
        p.set(agent, "_rollout", recorded_rollout)
        snaps = {}
        for name, opt in (("policy", agent.policy_opt),
                          ("value", agent.value_opt)):
            snaps[name] = probe.AdamSnapshots()
            snaps[name].attach(opt, p)
        out = agent.train_epoch(adaptive=self.cfg.adaptive_params(agent.epoch))
        p.restore()
        self.first = dict(rec=rec, out=out, snaps=snaps,
                          **captured)

    # -- window ------------------------------------------------------------

    def flop_per_iteration(self) -> float:
        c = self.config["values"]
        sizes = self.config["sizes"]
        T, N = self.steps, self.n_envs
        pol = counts.mcp_flop(sizes["obs_dim"], sizes["action_dim"],
                              c["num_primitive"], c["policy_hsize"],
                              sizes["composer_hsize"])
        val = counts.mlp_flop([sizes["obs_dim"], *c["value_hsize"], 1])
        sub = counts.substep_flop(counts.DEPTH, sizes["contact_blocks"],
                                  sizes["contact_iters"],
                                  sizes["mass_solve_rhs"] - 1)
        rollout = T * N * (pol + sizes["substeps"] * sub)
        mb = min(c["mini_batch_size"], T * N)
        update = T * N * val + c["num_optim_epoch"] * mb * 3 * (pol + val)
        return rollout + update

    def window(self, run, seconds: float, profile: bool = True) -> None:
        agent = self.program
        run.counters.update(n_envs=self.n_envs, steps=self.steps,
                            flop_per_unit=self.flop_per_iteration(),
                            contact_blocks=self.config["sizes"]["contact_blocks"],
                            contact_iters=self.config["sizes"]["contact_iters"])
        self.window_rec = None
        run.window_t0 = t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            spans = []
            if i == self.traffic["check"]["iteration"]:
                self.window_rec = self._record_steps()
            if run.trace:
                # a synchronised span around the rollout
                self.patch.set(agent, "_rollout", probe.timed(
                    agent._rollout, self.device, spans))
            if not self._unit(run, spans, profiled=False):
                return
            i += 1
        if profile:
            tr = self.traffic["trace"]
            run.profile = Summary()
            self.profile_unit(run, agent, "train_epoch", tr["first_step"],
                              tr["steps"])
            self._unit(run, [], profiled=True)

    def _unit(self, run, spans: list, profiled: bool) -> bool:
        """One iteration through ``train_epoch``, counted; False if it
        failed."""
        agent = self.program
        ts = time.perf_counter()
        try:
            m = agent.train_epoch(
                adaptive=self.cfg.adaptive_params(agent.epoch))
            ok = all(math.isfinite(m[k]) for k in
                     ("reward_mean", "policy_loss", "value_loss"))
        except Exception:          # a failed unit, counted
            traceback.print_exc()
            ok, m = False, None
        te = time.perf_counter()
        self.patch.restore()
        self.attempted += 1
        self.failed += 0 if ok else 1
        run.units.append(Unit(ts, te, work=self.steps * self.n_envs,
                              steps=self.steps, profiled=profiled,
                              parts={"rollout": sum(spans)} if spans else {}))
        return m is not None

    # -- check ---------------------------------------------------------------

    def check(self) -> list:
        """(name, value, limit) of every number compared: one env step of
        each recorded env and control step, of the first iteration and of
        the window's checked one together; and on the first iteration the
        policy's log-probability of every action taken (through the
        running norm), and the PPO update's losses, first gradient and the
        change of the first three steps (after the running-norm update
        and GAE, which feed them)."""
        from harness import ref_uhc
        dev, f = self.device, self.first
        env, cfg = ref_uhc.build_env(self.config["values"], self.traffic,
                                     ROOT, dev)
        limits = self.traffic["limits"]
        out = []

        # one env step of every recorded (control step, env)
        recs = [r for r in (f["rec"], self.window_rec) if r and r.calls]
        (state, action), (p_state, p_obs, p_rew, p_done, _) = (
            probe.stack([r.stacked()[k] for r in recs]) for k in (0, 1))
        state, action = ref_uhc.to_ref((state, action), dev)
        with torch.no_grad():
            r_state, r_obs, r_rew, r_done, _ = env.step(state, action)
        sim = lambda s: torch.cat([s.sim.qpos, s.sim.qvel], dim=-1)
        out += gaps.step_numbers(sim(p_state), sim(r_state), p_obs, r_obs,
                                 p_rew, r_rew, p_done, r_done)

        # the policy over every sample of the iteration
        traj = f["traj"]
        obs_dim, action_dim = traj["raw_obs"].shape[-1], traj["actions"].shape[-1]
        policy, value, norm0, tc = ref_uhc.load_nets(
            cfg, str(ROOT / self.traffic["checkpoint"]), obs_dim, action_dim,
            dev)
        from refimpl.models import nets as ref_nets
        from refimpl.rl import running_norm as ref_rn
        with torch.no_grad():
            obs_n = ref_rn.apply(norm0, traj["raw_obs"].to(dev, torch.float64))
            mean, log_std = policy(obs_n)
            lp = ref_nets.gaussian_log_prob(
                traj["actions"].to(dev, torch.float64), mean, log_std)
        out.append(("policy_logp", gaps.rel_gap(traj["log_probs"], lp)))
        del obs_n, mean, log_std, lp

        # the update
        snaps = {"policy": probe.AdamSnapshots(), "value": probe.AdamSnapshots()}
        _, metrics = ref_uhc.ppo_iteration(
            policy, value, tc, norm0, traj, f["carry_obs"], f["gen_state"],
            snaps["policy"], snaps["value"], dev, probe.Patch())
        po = f["out"]
        out.append(("value_loss", abs(po["value_loss"] - metrics["value_loss"])
                    / max(abs(metrics["value_loss"]), 1e-30)))
        out.append(("policy_loss", abs(po["policy_loss"]
                                        - metrics["policy_loss"])))
        grad1, change3 = 0.0, 0.0
        for k in ("policy", "value"):
            ps, rs = f["snaps"][k], snaps[k]
            grad1 = max(grad1, gaps.leaf_norm_gap(ps.grad1, rs.grad1))
            change3 = max(change3, gaps.leaf_norm_gap(
                ps.change(), rs.change(), gaps.moved_leaves(rs.grad1)))
        out.append(("grad1", grad1))
        out.append(("change3", change3))
        return [(name, v, limits.get(name, float("nan"))) for name, v in out]
