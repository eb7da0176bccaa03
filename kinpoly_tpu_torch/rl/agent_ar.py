"""The kinematic-policy agent (port of ``kinpoly_tpu/rl/agent_ar.py``): the
policy and value nets, the context build, the supervised warm start
(``train_init``), the composite epoch (``optimize_policy``) and
checkpoints in the JAX package's layout.

One composite epoch:

1. context build: ``n_envs`` windows sampled on the host (weighted by each
   take's success history), the policy's AR rollout over each;
2. rollout: ``rollout_steps`` control steps of the envs with sampled
   actions, the UHC controller in the loop (its own samples);
3. PPO (``rl_update``): value and policy epochs over the (T, N)
   trajectory, the step GRU re-run over it with the carry zeroed at
   episode starts; or, with ``grad_joint``, one step per epoch on the
   PPO surrogate plus 10 x the step loss (``grad_alternate`` gates the two
   terms on alternate epochs);
4. step BC (``step_update``): ``num_step_update`` epochs of the per-step
   loss toward the ground truth's next pose through the kinematic
   integrator (``step_update_dyna``: also toward the simulated pose);
5. ``joint_controller``: PPO epochs on the UHC controller over its
   recorded observations and actions, with the same advantages.

No gradient reaches the physics: the rollout is recorded without one, and
the losses go through the kinematic integrator only. The four optimiser
chains are ``rl/optim.AdamChain`` (optax's, stepping every parameter).

Data parallelism (the JAX config's ``axis_name``): with a process group
in ``group``, ``update`` averages every gradient across the ranks right
after its backward pass (``parallel/mesh.pmean_grads_``), before the
chain's clip and Adam, so the replicated nets and chains stay bitwise
equal. ``ppo_grad_norm`` and ``bc_nan_frac`` are read off the averaged
gradient; GAE's normalisation and every metric stay rank-local, as in
JAX. ``parallel/dryrun.dp_ar_step`` runs the rank's block of envs on a
context replicated from rank 0. ``train_init`` and ``optimize_policy``
run on one device, as JAX's do.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import pickle
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from kinpoly_tpu_torch.data import statear
from kinpoly_tpu_torch.data.statear import StateARDataset
from kinpoly_tpu_torch.envs.humanoid_ar import ARContext, HumanoidAREnv
from kinpoly_tpu_torch.models import nets, weights
from kinpoly_tpu_torch.models.policy_ar import PolicyAR
from kinpoly_tpu_torch.models.traj_ar import (ClipData, compute_loss,
                                              compute_loss_init, obs_dim)
from kinpoly_tpu_torch.parallel.mesh import pmean_grads_
from kinpoly_tpu_torch.physics import fk as fklib
from kinpoly_tpu_torch.rl import gae
from kinpoly_tpu_torch.rl import rollout_ar as roa
from kinpoly_tpu_torch.rl import running_norm as rn
from kinpoly_tpu_torch.rl.agent_uhc import UHCTrainConfig, make_policy
from kinpoly_tpu_torch.rl.optim import AdamChain, global_norm
from kinpoly_tpu_torch.utils.liveness import grad_nonfinite_fraction
from kinpoly_tpu_torch.utils.profiling import span


def load_uhc(path: str, device, dtype: torch.dtype = torch.float32,
             obs_dim: int = 784, action_dim: int = 75):
    """The frozen UHC controller of the AR env from a UHC checkpoint:
    (policy module in `dtype` on `device`, its observation norm as saved),
    the policy built by ``agent_uhc.make_policy`` from the checkpoint's
    config."""
    ck = weights.load_uhc_checkpoint(path)
    saved = ck["cfg"] or {}
    cfg = UHCTrainConfig(**{f.name: saved[f.name] for f in
                            dataclasses.fields(UHCTrainConfig) if f.name in saved})
    cfg.policy_hsize = tuple(cfg.policy_hsize)
    policy = make_policy(cfg, obs_dim, action_dim)
    policy.load_state_dict(ck["policy"])
    norm = rn.RunningNorm(*(x.to(device) for x in ck["norm"]))
    return policy.to(device=device, dtype=dtype), norm


@dataclass
class ARTrainConfig:
    # supervised phase (kin_poly.yml root level)
    lr: float = 5e-4
    batch_size: int = 32
    fr_num: int = 100
    # RL phase (policy_specs)
    policy_lr: float = 1e-5
    value_lr: float = 3e-4
    clip_epsilon: float = 0.2
    gamma: float = 0.95
    tau: float = 0.95
    num_optim_epoch: int = 10
    num_step_update: int = 20
    num_init_update: int = 3
    log_std: float = -3.2
    # training rollouts sample: with mean actions the PPO surrogate's
    # gradient is exactly zero (d log p / d mean = 0 at a = mean)
    mean_action_rollout: bool = False
    n_envs: int = 64
    rollout_steps: int = 156
    max_grad_norm: float = 40.0
    sampling_temp: float = 0.3
    sampling_freq: float = 0.5
    seed: int = 4
    save_model_interval: int = 50
    # update modes (policy_specs)
    rl_update: bool = True
    step_update: bool = True
    step_update_dyna: bool = False
    init_update: bool = False
    full_update: bool = False
    grad_joint: bool = False
    grad_alternate: bool = False
    joint_controller: bool = False
    cc_lr: float = 1e-5


class AgentAR:
    """The policy (PolicyAR: TrajARNet, and with the env's policy_v 2 the
    residual head) and value net on the env's device and dtype, freshly
    initialised as flax does (seeded) until a checkpoint is loaded; a
    live copy of the env's UHC controller, which the rollouts run and
    ``joint_controller`` tunes; the optimiser chains, the window
    sampler (numpy, seeded as the JAX agent's and drawn in the same order)
    and a torch generator for the rollouts' and losses' noise."""

    # with time_phases, optimize_policy syncs the device around each phase
    # (context, rollout, ppo, bc, controller) and adds its seconds to
    # phase_s
    time_phases = False
    # a process group: update averages every gradient across its ranks
    # (None: one device)
    group = None

    def __init__(self, env: HumanoidAREnv, dataset: StateARDataset,
                 cfg: ARTrainConfig | None = None, out_dir: str | None = None):
        cfg = cfg or ARTrainConfig()
        self.env, self.dataset, self.cfg = env, dataset, cfg
        self.out_dir = Path(out_dir) if out_dir else None
        self.epoch = 0
        model = env.model
        self.device, self.dtype = model.device, model.dtype
        self.np_rng = np.random.RandomState(cfg.seed)
        self.generator = torch.Generator(device=model.device).manual_seed(cfg.seed)
        self.policy = PolicyAR(model.spec, model.st, env.kin_cfg, cfg.log_std,
                               policy_v=env.policy_v)
        self._use_of = bool(env.kin_cfg.use_of)
        # the JAX agent initialises its nets on an example batch of one
        # window; the draw is kept so that later windows are the same
        self.dataset.get_batch(self.np_rng, 1, use_of=self._use_of)
        # the value net sees the policy's observation (policy_v 2: with the
        # AR pose appended)
        v_dim = obs_dim(env.kin_cfg, as_policy=True)
        if env.policy_v == 2:
            v_dim += self.policy.action_dim
        self.value = nets.Value(v_dim, hidden=(512, 256))
        gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
        self.policy.init_flax_(gen).to(device=model.device, dtype=model.dtype)
        nets.init_flax_(self.value, gen).to(device=model.device,
                                            dtype=model.dtype)
        self.cc_policy = copy.deepcopy(env.cc_policy)

        # the supervised and policy chains cover every policy parameter, as
        # optax's cover the whole tree: the warm start reaches only
        # TrajARNet and, with policy_v 2, PPO and step BC only the head
        net_params = self.policy.parameters()
        self.sup_opt = AdamChain(net_params, cfg.lr, cfg.max_grad_norm,
                                 zero_nans=True)
        self.pol_opt = AdamChain(net_params, cfg.policy_lr, cfg.max_grad_norm)
        self.val_opt = AdamChain(self.value.parameters(), cfg.value_lr)
        self.cc_opt = AdamChain(self.cc_policy.parameters(), cfg.cc_lr,
                                cfg.max_grad_norm)
        self._rollout = roa.make_ar_rollout(env, self.policy, cfg.rollout_steps)
        self.freq = {}              # take -> its last 50 episode successes
        self.phase_s = {}

    @contextlib.contextmanager
    def _phase(self, name: str):
        """The span ``ar.<name>``; with ``time_phases`` also the phase's
        synchronised seconds, added to ``phase_s``."""
        with span(f"ar.{name}"):
            if not self.time_phases:
                yield
                return
            sync = (torch.cuda.synchronize if self.device.type == "cuda"
                    else lambda: None)
            sync()
            t0 = time.perf_counter()
            yield
            sync()
            self.phase_s[name] = (self.phase_s.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def _get_batch(self, batch_size: int, **kw) -> ClipData:
        """`batch_size` windows (tensors; `take_idx` int64)."""
        b = self.dataset.get_batch(self.np_rng, batch_size,
                                   use_of=self._use_of, **kw)
        return statear.clip_tensors(b, self.dtype, self.device)

    # -- supervised warm start --------------------------------------------

    def _backward(self, loss: torch.Tensor, opt: AdamChain,
                  group=None) -> None:
        """The gradient of `loss` into `opt`'s parameters, averaged across
        the ranks of `group` if one is given."""
        opt.zero_grad()
        loss.backward()
        if group is not None:
            pmean_grads_(opt.params, group)

    def _sup_update(self, loss: torch.Tensor, group=None) -> torch.Tensor:
        """One step of the supervised chain on `loss`; returns the fraction
        of gradient leaves that held a non-finite value (over every
        policy parameter, as JAX counts its whole tree)."""
        self._backward(loss, self.sup_opt, group)
        nan_frac = grad_nonfinite_fraction(
            [(n, p.grad) for n, p in self.policy.named_parameters()])
        self.sup_opt.step()
        return nan_frac

    def _full_sup_step(self, batch: ClipData, gt_rate: float):
        feats = self.policy.net(batch, gt_rate, self.generator, train=True)
        loss, info = compute_loss(self.env.kin_cfg, feats, batch)
        info = dict(info, grad_nan_frac=self._sup_update(loss))
        return loss.detach(), info

    def _init_sup_step(self, batch: ClipData):
        qpos0, qvel0, _ = self.policy.net.init_states(batch)
        loss, info = compute_loss_init(self.env.model.st, self.env.kin_cfg,
                                       qpos0, batch.qpos[:, 0], qvel0,
                                       batch.qvel[:, 0])
        info = dict(info, grad_nan_frac=self._sup_update(loss))
        return loss.detach(), info

    def train_init(self, init_steps: int = 500, full_steps: int = 50,
                   gt_rate: float = 0.3, log_every: int = 50):
        """The supervised warm start: `init_steps` steps of the initial
        state's loss, then `full_steps` of the full AR rollout's (scheduled
        sampling at `gt_rate`), each on a fresh batch. Yields (phase, step,
        loss, grad_nan_frac) every `log_every` steps (the only host
        syncs)."""
        for i in range(init_steps):
            loss, info = self._init_sup_step(self._get_batch(self.cfg.batch_size))
            if i % log_every == 0:
                yield ("init", i, float(loss), float(info["grad_nan_frac"]))
        for i in range(full_steps):
            loss, info = self._full_sup_step(
                self._get_batch(self.cfg.batch_size), gt_rate)
            if i % log_every == 0:
                yield ("full", i, float(loss), float(info["grad_nan_frac"]))

    # -- context ----------------------------------------------------------

    @torch.no_grad()
    def build_context(self, batch: ClipData, fix_height: bool = False) -> ARContext:
        """The context bank of a batch of takes (tensors on the env's
        device): the AR rollout with smoothing (and the feet fix), the
        ground truth's FK and body quaternions, and the episode lengths
        (true frames - 1: padded frames never count as tracked)."""
        ar = self.policy.init_context(batch, smooth=True, fix_height=fix_height)
        B, T = batch.qpos.shape[:2]
        gt_fk = fklib.fk(self.env.model.st, batch.qpos)
        length = (batch.length - 1 if batch.length is not None
                  else torch.full((B,), T - 1, device=batch.qpos.device))
        return ARContext(
            qpos=batch.qpos, qvel=batch.qvel,
            bquat=fklib.body_quat_sim(batch.qpos),
            gt_wbpos=gt_fk.xpos.reshape(B, T, -1),
            head_pose=batch.head_pose, head_vels=batch.head_vels,
            obj_pose=batch.obj_pose,
            obj_head_relative_poses=batch.obj_head_relative_poses,
            action_one_hot=batch.action_one_hot,
            ar_qpos=ar["ar_qpos"], ar_qvel=ar["ar_qvel"],
            ar_wbpos=ar["ar_wbpos"], init_qpos=ar["init_qpos"],
            init_qvel=ar["init_qvel"], length=length,
            context_feat=ar["context_feat"], of=batch.of)

    # -- the composite update -----------------------------------------------

    def _rl_and_step_update(self, carry: roa.ARRolloutState, ctx: ARContext,
                            w_ppo: float = 1.0, w_bc: float = 1.0):
        """The rollout from `carry` on `ctx`, then ``update`` on its
        trajectory: (new carry, trajectory, metrics)."""
        with self._phase("rollout"):
            carry, traj = self._rollout(
                carry, ctx, mean_action=self.cfg.mean_action_rollout,
                cc_policy=self.cc_policy, generator=self.generator)
        return carry, traj, self.update(traj, carry.obs, w_ppo, w_bc)

    def update(self, traj: roa.ARTrajectory, last_obs: torch.Tensor,
               w_ppo: float = 1.0, w_bc: float = 1.0) -> dict:
        """PPO (or the joint PPO + BC epochs), step BC and the controller
        epochs on a recorded trajectory (T, N, ...); `last_obs` is the
        observation after its last step (the value bootstrap). Updates the
        nets in place; returns the metrics as 0-dim tensors. With a
        ``group``, `traj` is this rank's block of envs and the gradients
        are averaged across the ranks."""
        cfg = self.cfg
        T, N = traj.rewards.shape
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        with torch.no_grad():
            values = self.value(traj.obs)
            bootstrap = self.value(last_obs)
        adv, ret = gae.estimate_advantages(traj.rewards, traj.masks, values,
                                           cfg.gamma, cfg.tau, bootstrap)
        prev_masks = torch.cat([torch.ones_like(traj.masks[:1]),
                                traj.masks[:-1]])

        def flat(x):
            return x.reshape((T * N,) + x.shape[2:])

        obs, ret, adv_f = flat(traj.obs), flat(ret), flat(adv)
        actions, fixed_lp = flat(traj.actions), flat(traj.log_probs)
        eps = cfg.clip_epsilon

        def surrogate(lp, fixed):
            ratio = torch.exp(lp - fixed)
            surr = -torch.mean(torch.minimum(
                ratio * adv_f, torch.clamp(ratio, 1 - eps, 1 + eps) * adv_f))
            return surr, ratio

        pls, vls, ratio_devs, pgnorms = [zero], [zero], [zero], [zero]
        if cfg.grad_joint or cfg.rl_update:
            pls, vls, ratio_devs, pgnorms = [], [], [], []
            with self._phase("ppo"):
                for _ in range(cfg.num_optim_epoch):
                    vl = torch.mean((self.value(obs) - ret) ** 2)
                    self._backward(vl, self.val_opt, self.group)
                    self.val_opt.step()
                    means = self.policy.action_means_over_time(traj.obs,
                                                               prev_masks)
                    lp = nets.gaussian_log_prob(
                        actions, flat(means),
                        torch.full_like(flat(means), self.policy.log_std))
                    loss, ratio = surrogate(lp, fixed_lp)
                    if cfg.grad_joint:
                        bc, _ = self.policy.step_update_loss(
                            traj.obs, prev_masks, traj.curr_qpos,
                            traj.gt_qpos, means=means)
                        loss = w_ppo * loss + w_bc * bc * 10.0
                    self._backward(loss, self.pol_opt, self.group)
                    pgnorms.append(global_norm(
                        [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in self.pol_opt.params]))
                    self.pol_opt.step()
                    pls.append(loss.detach())
                    vls.append(vl.detach())
                    ratio_devs.append(torch.mean(torch.abs(ratio.detach() - 1.0)))

        def bc_epochs(target):
            losses, nan_fracs = [], []
            for _ in range(cfg.num_step_update):
                loss, _ = self.policy.step_update_loss(
                    traj.obs, prev_masks, traj.curr_qpos, target)
                nan_fracs.append(self._sup_update(loss, self.group).to(
                    self.dtype))
                losses.append(loss.detach())
            return losses, nan_fracs

        bc_losses, bc_nan_fracs = [zero], [zero]
        with self._phase("bc"):
            if cfg.step_update and not cfg.grad_joint:
                bc_losses, bc_nan_fracs = bc_epochs(traj.gt_qpos)
            if cfg.step_update_dyna:
                losses, nan_fracs = bc_epochs(traj.res_qpos)
                bc_losses, bc_nan_fracs = (bc_losses + losses,
                                           bc_nan_fracs + nan_fracs)

        cc_losses = [zero]
        if cfg.joint_controller:
            with self._phase("controller"):
                cc_state, cc_action = flat(traj.cc_state), flat(traj.cc_action)
                with torch.no_grad():
                    cc_fixed = nets.gaussian_log_prob(
                        cc_action, *self.cc_policy(cc_state))
                cc_losses = []
                for _ in range(cfg.num_optim_epoch):
                    loss, _ = surrogate(nets.gaussian_log_prob(
                        cc_action, *self.cc_policy(cc_state)), cc_fixed)
                    self._backward(loss, self.cc_opt, self.group)
                    self.cc_opt.step()
                    cc_losses.append(loss.detach())

        mean = lambda xs: torch.stack(xs).mean()
        return dict(
            reward_mean=traj.rewards.mean(), ppo_loss=mean(pls),
            value_loss=mean(vls), bc_loss=mean(bc_losses),
            cc_loss=mean(cc_losses),
            fail_frac=traj.fails.to(self.dtype).mean(),
            ratio_dev=mean(ratio_devs), ppo_grad_norm=mean(pgnorms),
            adv_std=adv.std(correction=0), bc_nan_frac=mean(bc_nan_fracs))

    def optimize_policy(self) -> dict:
        """One composite epoch (context, rollout, updates), the per-take
        success history, the supervised extras of ``init_update`` and
        ``full_update``, and the periodic checkpoint. Returns the metrics
        as floats and the epoch's seconds (``T_iter``)."""
        t0 = time.time()
        cfg = self.cfg
        with self._phase("context"):
            nb = self.dataset.get_batch(
                self.np_rng, cfg.n_envs, use_of=self._use_of,
                freq_dict=self.freq or None, sampling_temp=cfg.sampling_temp,
                sampling_freq=cfg.sampling_freq)
            take_idx = np.asarray(nb.take_idx)
            ctx = self.build_context(statear.clip_tensors(nb, self.dtype,
                                                          self.device))
            carry = roa.init_ar_rollout_state(
                self.env, self.policy,
                torch.arange(cfg.n_envs, device=self.device), ctx)
        # grad_alternate: pure PPO on odd epochs, pure BC on even ones
        w_ppo = 1.0 if (not cfg.grad_alternate or self.epoch % 2 == 1) else 0.0
        w_bc = 1.0 if (not cfg.grad_alternate or self.epoch % 2 == 0) else 0.0
        _, traj, metrics = self._rl_and_step_update(carry, ctx, w_ppo, w_bc)
        names = list(metrics)
        values = torch.stack([metrics[k].to(torch.float64) for k in names]).cpu()
        out = {k: float(v) for k, v in zip(names, values)}

        # per-take success history for the window sampling: one entry per
        # finished episode, success = tracked to the end
        dones = (traj.masks == 0).cpu().numpy()
        clips, percents = traj.clips.cpu().numpy(), traj.percents.cpu().numpy()
        for t, n in zip(*np.nonzero(dones)):
            take = int(take_idx[int(clips[t, n])])
            succ = 1.0 if float(percents[t, n]) >= 1.0 else 0.0
            self.freq.setdefault(take, []).append(succ)
            self.freq[take] = self.freq[take][-50:]

        if cfg.init_update:
            for _ in range(cfg.num_init_update):
                self._init_sup_step(self._get_batch(cfg.batch_size))
        if cfg.full_update:
            self._full_sup_step(self._get_batch(cfg.batch_size), 0.3)

        self.epoch += 1
        out["T_iter"] = time.time() - t0
        if self.out_dir and self.epoch % cfg.save_model_interval == 0:
            self.save_checkpoint()
        return out

    # -- checkpoints ----------------------------------------------------------

    def save_checkpoint(self, path: str | None = None) -> str:
        """A pickle in the JAX package's layout: the flax trees of the
        policy ({"arnet", "delta"} with policy_v 2) and value net (numpy),
        the epoch, the tuned controller's (with ``joint_controller``, else
        None) and the success history; the JAX ``AgentAR.load_checkpoint``
        and ``load_checkpoint`` both read it."""
        path = Path(path or self.out_dir / f"iter_{self.epoch:04d}.p")
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = dict(
            params=weights.policy_ar_params(self.policy),
            value_params=weights.value_params(self.value.state_dict()),
            epoch=self.epoch,
            cc_params=(weights.policy_params(self.cc_policy.state_dict())
                       if self.cfg.joint_controller else None),
            freq=self.freq)
        with open(path, "wb") as f:
            pickle.dump(blob, f)
        return str(path)

    def load_checkpoint(self, path: str) -> None:
        """The policy, value net, epoch and success history of a
        kinematic-policy checkpoint (``iter_*.p``), and its tuned
        controller if it has one, which also resets the controller's
        optimiser (no other optimiser is reset, as in JAX). Evaluation
        runs the env's own controller, not this one."""
        ck = weights.load_ar_checkpoint(path)
        if (ck["delta"] is None) != (self.policy.delta_net is None):
            raise ValueError(f"{path} holds a policy_v "
                             f"{1 if ck['delta'] is None else 2} policy; "
                             f"this agent's is policy_v {self.policy.policy_v}")
        self.policy.net.load_state_dict(ck["policy"])
        if ck["delta"] is not None:
            self.policy.delta_net.load_state_dict(ck["delta"])
        self.value.load_state_dict(ck["value"])
        self.epoch = ck["epoch"]
        if ck["cc"] is not None:
            self.cc_policy.load_state_dict(ck["cc"])
            self.cc_opt.reset()
        self.freq = ck["freq"]
