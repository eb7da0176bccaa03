"""The frozen reference agrees with the port at a small size in float64 on
the CPU: one control step, one env step and one update of the UHC
configuration. A reference that is wrong is caught here, before the
chip."""

import numpy as np
import pytest
import torch

from harness import probe, ref_uhc, spec

ROOT = spec.BENCH_DIR.parent
F64 = torch.float64
TOL = 1e-9


def close(a, b, tol=TOL):
    if a is None:
        assert b is None
        return
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            close(x, y, tol)
        return
    a, b = a.detach(), b.detach()
    assert a.shape == b.shape
    if a.is_floating_point():
        assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))
    else:
        assert torch.equal(a, b)


def cell(name):
    return spec.find_cell(spec.load_json(ROOT / "BENCHMARK.json"), name)


@pytest.fixture(scope="module")
def uhc():
    torch.manual_seed(0)
    from kinpoly_tpu_torch.config.defaults import UHCConfig
    from kinpoly_tpu_torch.data.banks import load_hard_states
    from kinpoly_tpu_torch.scripts.eval_uhc import get_takes
    from kinpoly_tpu_torch.scripts.train_uhc import build_trainer
    c = cell("uhc.train.e1024")
    tr = c.traffic
    agent = build_trainer(get_takes(str(ROOT / tr["bank"])),
                          UHCConfig.named("uhc"), 3, 2,
                          hard_states=load_hard_states(
                              str(ROOT / tr["hard_states"])),
                          device="cpu", dtype=F64)
    agent.load_checkpoint(str(ROOT / tr["checkpoint"]))
    env, cfg = ref_uhc.build_env(c.config["values"], tr, ROOT, "cpu")
    return c, agent, env, cfg


def test_uhc_control_and_env_step(uhc):
    from kinpoly_tpu_torch.physics import engine as eng
    from refimpl.physics import engine as ref_eng
    c, agent, env, _ = uhc
    state, obs = agent.env.reset(torch.tensor([0, 5, 11]), start_ind=3)
    rstate, robs = env.reset(torch.tensor([0, 5, 11]), start_ind=3)
    close(obs, robs)
    a = torch.as_tensor(np.random.RandomState(1).normal(
        0, 0.3, (3, agent.env.action_dim)), dtype=F64)
    tgt = agent.env.expert_frame(state, delta_t=1).qpos[..., 7:]
    sim = eng.control_step(agent.env.model, state.sim, a, tgt, agent.env.base_rot)
    rsim = ref_eng.control_step(env.model, ref_uhc.to_ref(state.sim, "cpu"),
                                a, tgt, env.base_rot)
    close(tuple(sim), tuple(rsim))
    out = agent.env.step(state, a)
    rout = env.step(ref_uhc.to_ref(state, "cpu"), a)
    close(tuple(out), tuple(rout))


def test_uhc_update(uhc):
    from kinpoly_tpu_torch.rl import ppo
    c, agent, env, cfg = uhc
    obs_dim, action_dim = agent.obs_dim, agent.env.action_dim
    policy, value, norm, tc = ref_uhc.load_nets(
        cfg, str(ROOT / c.traffic["checkpoint"]), obs_dim, action_dim, "cpu")
    rng = np.random.RandomState(2)
    T, N = 2, 3
    traj = dict(raw_obs=torch.as_tensor(rng.normal(0, 1, (T, N, obs_dim))),
                actions=torch.as_tensor(rng.normal(0, 0.3, (T, N, action_dim))),
                rewards=torch.as_tensor(rng.uniform(0, 1, (T, N))),
                masks=torch.as_tensor([[1.0, 0.0, 1.0], [1.0, 1.0, 1.0]],
                                      dtype=F64),
                log_probs=torch.as_tensor(rng.normal(60, 1, (T, N))))
    carry_obs = torch.as_tensor(rng.normal(0, 1, (N, obs_dim)))
    gen = torch.Generator().manual_seed(5)
    snaps = {k: probe.AdamSnapshots() for k in ("p", "v", "rp", "rv")}
    # the port's update on the same batch, as _train_iter runs it
    from kinpoly_tpu_torch.rl import gae as pgae
    from kinpoly_tpu_torch.rl import running_norm as prn
    pnorm = agent.norm
    obs_n = prn.apply(pnorm, traj["raw_obs"])
    with torch.no_grad():
        values = agent.value(obs_n)
        boot = agent.value(prn.apply(pnorm, carry_obs))
    adv, ret = pgae.estimate_advantages(traj["rewards"], traj["masks"], values,
                                        tc.gamma, tc.tau, boot)
    patch = probe.Patch()
    snaps["p"].attach(agent.policy_opt, patch)
    snaps["v"].attach(agent.value_opt, patch)
    flat = lambda x: x.reshape((T * N,) + x.shape[2:])
    m = ppo.ppo_update(agent.policy, agent.value, agent.ppo_cfg,
                       agent.policy_opt, agent.value_opt,
                       torch.Generator().manual_seed(5), flat(obs_n),
                       flat(traj["actions"]), flat(adv), flat(ret),
                       flat(traj["log_probs"]))
    n1, rm = ref_uhc.ppo_iteration(policy, value, tc, norm, traj, carry_obs,
                                      gen.get_state(), snaps["rp"], snaps["rv"],
                                      "cpu", patch)
    close(prn.update_batch(pnorm, traj["raw_obs"]).mean, n1.mean)
    assert m["policy_loss"].item() == pytest.approx(rm["policy_loss"], abs=1e-9)
    assert m["value_loss"].item() == pytest.approx(rm["value_loss"], rel=1e-9)
    for a, b in ((snaps["p"], snaps["rp"]), (snaps["v"], snaps["rv"])):
        close(tuple(a.grad1), tuple(b.grad1))
        close(tuple(a.change()), tuple(b.change()))
