"""The AR side of the frozen reference (``refimpl``, float64): the AR
training env on the synthetic humanoid with its movable objects and the
frozen controller of the traffic's checkpoint, the kinematic policy and
value net from the program's initial parameters, the context build, the
env step, the step GRU's re-run, and the first steps of the PPO and
step-BC chains, built from the cell's configuration file and the raw files
the traffic names. Imports nothing of the program; the program's records
(tensors, and NamedTuples read by field name) are its inputs."""

from __future__ import annotations

import sys

import torch

from harness import gaps
from refimpl.anim.spec import synthetic_spec
from refimpl.config.defaults import UHCConfig, uhc_control_params
from refimpl.envs.humanoid_ar import (ARContext, AREnvState, ARRewardWeights,
                                      HumanoidAREnv)
from refimpl.models import nets
from refimpl.models.policy_ar import PolicyAR
from refimpl.models.traj_ar import ClipData, TrajARConfig, obs_dim
from refimpl.physics import engine as eng
from refimpl.physics import fk as fklib
from refimpl.rl import agent_ar

# the chains' steps the reference runs: each chain's change after them is
# compared
N_STEPS = 3
# the context's compared row: the median env's
CONTEXT_Q = 0.5
# the env step's compared row, of every recorded (control step, env)
STEP_Q = 0.95

# what the reference covers of kin_poly.yml: a configuration file that
# sets another value is refused
COVERED = dict(use_of=False, use_vel=False, use_context=False)
COVERED_POLICY = dict(policy_v=1, reward_id="dynamic_supervision_v1",
                      rl_update=True, step_update=True, init_update=False,
                      full_update=False)


def to_ref(x, device, dtype=torch.float64):
    """Floating tensors in `dtype` on `device`, through dicts and
    (named) tuples; None stays None."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_ref(v, device, dtype) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [to_ref(y, device, dtype) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    y = x.to(device)
    return y.to(dtype) if y.is_floating_point() else y


def as_tuple(cls, x):
    """The reference's NamedTuple `cls` of the fields it has in `x`."""
    return cls(**{k: getattr(x, k) for k in cls._fields})


def cat(xs: list):
    """Concatenate nested (named) tuples of tensors along their first
    dim; None leaves stay None."""
    x0 = xs[0]
    if x0 is None:
        return None
    if isinstance(x0, tuple):
        items = [cat(list(z)) for z in zip(*xs)]
        return type(x0)(*items) if hasattr(x0, "_fields") else tuple(items)
    return torch.cat(xs)


class Reference:
    """The reference of one configuration file and traffic on `device`."""

    def __init__(self, config: dict, traffic: dict, root, device):
        v = config["values"]
        ms, ps = v["model_specs"], v["policy_specs"]
        bad = {k: v[k] for k, want in COVERED.items() if v[k] != want}
        bad.update({k: ps.get(k) for k, want in COVERED_POLICY.items()
                    if ps.get(k) != want})
        if bad or ps.get("joint_controller"):
            raise ValueError(f"the AR reference does not cover {bad}")
        self.device = device
        self.kin_cfg = TrajARConfig(
            use_head=v["use_head"], use_action=v["use_action"],
            has_z=v["has_z"], model_v=ms["model_v"], rnn_hdim=ms["rnn_hdim"],
            mlp_hsize=tuple(ms["mlp_hsize"]), mlp_htype=ms["mlp_htype"],
            w_rp=ms["w_rp"], w_rr=ms["w_rr"], w_p=ms["w_p"], w_ee=ms["w_ee"])
        self.spec = spec = synthetic_spec(with_objects=True)
        model = eng.build_model(spec, uhc_control_params(spec), device=device,
                                dtype=torch.float64, with_objects=True,
                                movable_objects=True,
                                compact_k=tuple(config["sizes"]["compact_k"]))
        cc_policy, cc_norm = agent_ar.load_uhc(
            str(root / traffic["checkpoint"]), device)
        rw = ARRewardWeights(**{k: float(x) for k, x in
                                ps["reward_weights"].items()})
        self.env = HumanoidAREnv(
            model, self.kin_cfg, UHCConfig().env_config(), rw, cc_policy,
            cc_norm, body_diff_thresh=ps["body_diff_thresh"],
            body_diff_gt_thresh=ps["body_diff_gt_thresh"])
        self.upd = agent_ar.ARUpdateConfig(
            lr=v["lr"], policy_lr=ps["policy_lr"], value_lr=ps["value_lr"],
            clip_epsilon=ps["clip_epsilon"], gamma=ps["gamma"], tau=ps["tau"])
        self.log_std = ps["log_std"]

    def policy(self, params=None, state_dict=None) -> PolicyAR:
        """A float64 policy with the program's parameters: a state dict of
        its TrajARNet, or its parameter list in order."""
        p = PolicyAR(self.spec, self.env.model.st, self.kin_cfg, self.log_std)
        if state_dict is not None:
            p.net.load_state_dict(state_dict)
        p.to(device=self.device, dtype=torch.float64)
        if params is not None:
            with torch.no_grad():
                for a, b in zip(p.parameters(), params, strict=True):
                    a.copy_(b)
        return p

    def nets(self, init: dict):
        """(policy, value net) of the program's initial state dicts."""
        value = nets.Value(obs_dim(self.kin_cfg, True), (512, 256))
        value.load_state_dict(init["value"])
        return (self.policy(state_dict=init["policy"]),
                value.to(device=self.device, dtype=torch.float64))

    # -- the numbers compared ------------------------------------------------

    def context_numbers(self, policy: PolicyAR, batch, ctx) -> list:
        """The context of the program's windows against the program's:
        the AR rollout's poses with the initial pose, its velocities with
        the initial velocity, and the body positions (AR and ground truth)
        with the ground truth's body quaternions; each the median env's
        row (a few percent of a seed-initialised policy's open-loop
        rollouts are unstable, and float32 parts from float64 there), and
        infinite if an episode length differs."""
        b = to_ref(as_tuple(ClipData, batch), self.device)
        c = to_ref(ctx, self.device)
        with torch.no_grad():
            ar = policy.init_context(b)
        B, T = b.qpos.shape[:2]
        st = self.env.model.st
        gt_wbpos = fklib.fk(st, b.qpos).xpos.reshape(B, T, -1)
        pairs = dict(
            context_qpos=[(c.ar_qpos, ar["ar_qpos"]),
                          (c.init_qpos, ar["init_qpos"])],
            context_qvel=[(c.ar_qvel, ar["ar_qvel"]),
                          (c.init_qvel, ar["init_qvel"])],
            context_body=[(c.ar_wbpos, ar["ar_wbpos"]), (c.gt_wbpos, gt_wbpos),
                          (c.bquat, fklib.body_quat_sim(b.qpos))])
        same = torch.equal(c.length.cpu(), (b.length - 1).cpu())
        out = []
        for name, ps in pairs.items():
            rows = torch.stack([gaps.row_gaps(p.reshape(B, -1), r.reshape(B, -1))
                                for p, r in ps]).amax(dim=0)
            _diag(name, rows)
            out.append((name, gaps.quantile(rows, CONTEXT_Q) if same
                        else float("inf")))
        return out

    def step_numbers(self, recs: list, n_envs: int) -> list:
        """One env step of every recorded (control step, env) row, from
        the program's state and kinematic action, with the controller's
        noise drawn again from the generator's recorded state: the 95th
        percentile of the rows' gaps in the humanoid's state, in the
        objects' poses, and in the reward with the controller's raw
        observation (a row's gap the larger of the two), a row whose done
        flag differs counting as infinitely far. So a fault in more than
        one row in twenty shows; a seed-initialised policy's first steps
        start from poses deep in contact, where a contact that float32
        and float64 decide apart moves a row by O(1), in up to a few
        percent of the rows."""
        dev = self.device
        states, actions, ctxs, noise, outs, raws = [], [], [], [], [], []
        offset = 0
        for r in recs:
            idx = r["idx"].to(dev)
            (state, action), out = r["steps"].stacked()
            ctx = r["ctx"]
            if "batch" in r:                  # the whole context
                ctx = type(ctx)(*(None if x is None else x[idx] for x in ctx))
            pos = torch.searchsorted(idx, state.clip_idx)
            if not torch.equal(idx[pos.clamp(max=len(idx) - 1)],
                               state.clip_idx):
                raise ValueError("a recorded env steps another env's take")
            cc = out[4].cc_action
            for s in r["gen"]:
                g = torch.Generator(device=dev)
                g.set_state(s)
                noise.append(torch.randn((n_envs, cc.shape[-1]), generator=g,
                                         dtype=cc.dtype, device=dev)[idx])
            states.append(as_tuple(AREnvState, state._replace(
                sim=as_tuple(eng.SimState, state.sim), clip_idx=pos + offset,
                sim_fk=None)))
            actions.append(action)
            ctxs.append(as_tuple(ARContext, ctx))
            outs.append(out)
            raws.append(r["cc_obs"].stacked()[1])
            offset += len(idx)
        state = to_ref(cat(states), dev)
        state = state._replace(sim_fk=fklib.fk(self.env.model.st,
                                               state.sim.qpos))
        with torch.no_grad():
            r_state, _, r_rew, r_done, r_info = self.env.step(
                state, to_ref(torch.cat(actions), dev),
                to_ref(cat(ctxs), dev), to_ref(torch.cat(noise), dev))
        p_state, _, p_rew, p_done, _ = cat(outs)
        differs = p_done.to(dev) != r_done
        out = []
        for name, ps in dict(
                step_state=[(torch.cat([p_state.sim.qpos, p_state.sim.qvel],
                                       dim=-1),
                             torch.cat([r_state.sim.qpos, r_state.sim.qvel],
                                       dim=-1))],
                step_objects=[(p_state.sim.obj_qpos, r_state.sim.obj_qpos)],
                step_reward_obs=[(p_rew, r_rew),
                                 (torch.cat(raws), r_info.cc_raw_obs)]).items():
            rows = torch.stack([gaps.row_gaps(p, r) for p, r in ps]).amax(dim=0)
            rows = torch.where(differs, torch.full_like(rows, float("inf")),
                               rows)
            _diag(name, rows)
            out.append((name, gaps.quantile(rows, STEP_Q)))
        return out

    def logp_gap(self, policy: PolicyAR, traj: dict, prog_lp) -> float:
        """The program's log-probability of every action it took against
        the policy's, through the step GRU's re-run over the trajectory."""
        with torch.no_grad():
            means = policy.action_means_over_time(
                traj["obs"], agent_ar.prev_masks(traj["masks"]))
            lp = nets.gaussian_log_prob(traj["actions"], means,
                                        torch.full_like(means, self.log_std))
        return gaps.rel_gap(prog_lp, lp)

    def ppo(self, policy, value, traj: dict, last_obs, attach) -> list:
        """N_STEPS PPO epochs from fresh chains (`attach(name, chain)` is
        called on each first): each epoch's (value loss, policy loss)."""
        val_opt, pol_opt = agent_ar.ppo_chains(policy, value, self.upd)
        attach("val_opt", val_opt)
        attach("pol_opt", pol_opt)
        return agent_ar.ppo_epochs(policy, value, self.upd, val_opt, pol_opt,
                                   traj, last_obs, N_STEPS)

    def bc(self, params: list, traj: dict, attach) -> list:
        """N_STEPS step-BC epochs from the program's parameters `params`
        (those it started its step BC from) and a fresh chain: each
        epoch's loss."""
        policy = self.policy(params=params)
        sup_opt = agent_ar.bc_chain(policy, self.upd)
        attach("sup_opt", sup_opt)
        return agent_ar.bc_epochs(policy, sup_opt, traj, N_STEPS)


def _diag(name: str, rows: torch.Tensor) -> None:
    """The spread of a number's rows, on stderr (not compared)."""
    v = rows.double().flatten().sort().values
    q = lambda f: float(v[min(v.numel() - 1, int(f * v.numel()))])
    print(f"check rows {name}: " + " ".join(
        f"q{int(100 * f)} {q(f):.3g}" for f in (0.5, 0.75, 0.9, 0.95, 0.99))
        + f" max {float(v[-1]):.3g} of {v.numel()}", file=sys.stderr)
