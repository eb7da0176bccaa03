"""The port's kinematic-policy training path against the benchmark's frozen
plain reference (``benchmark/refimpl``, driven by ``benchmark/harness/
ref_ar.py``), both in float64 on the CPU, at kin_poly.yml's widths: the
policy and value net seeded as ``train_ar_policy --skip-init`` seeds them,
the frozen controller of ``iter_13000.p``, 4 envs x 3 control steps on
one take of ``ar_train_56.pkl``. The benchmark's loop runs the program's
first epoch with its recorders and checks it: the context built from the
epoch's windows, one env step of every recorded (step, env) row (state,
object poses, the controller's raw observation, reward, done), the
log-probability of every action through the step GRU's re-run, the first
PPO value and policy losses, the first step-BC loss, and each chain's
first gradient and change after three steps. Each number must be at
float64 round-off.

Also the AR path's three spans (``ar.kin_policy``, ``ar.controller``,
``physics.objects``): the AR rollout opens each, each has its layer in
``profile_eval.GROUPS``, and the UHC rollout opens none."""

import contextlib
import dataclasses
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT / "benchmark") not in sys.path:
    sys.path.insert(0, str(ROOT / "benchmark"))

from harness import cli, spec  # noqa: E402

from kinpoly_tpu_torch.config.defaults import UHCConfig  # noqa: E402
from kinpoly_tpu_torch.scripts import profile_eval as pe  # noqa: E402
from kinpoly_tpu_torch.scripts.eval_uhc import get_takes  # noqa: E402
from kinpoly_tpu_torch.scripts.train_uhc import build_trainer  # noqa: E402
from kinpoly_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(1)

N_ENVS, STEPS = 4, 3
AR_SPANS = {"ar.kin_policy": "kin_policy", "ar.controller": "controller",
            "physics.objects": "objects"}
# the compared numbers, each at float64 round-off (the float32 program on
# the card reads 1e-7 to 1e-2 against the same reference)
CHECKS = ("context_qpos", "context_qvel", "context_body", "step_state",
          "step_objects", "step_reward_obs", "policy_logp", "value_loss",
          "ppo_loss", "bc_loss", "ppo_grad1", "ppo_change3", "bc_grad1",
          "bc_change3")
TOL = 1e-8


@contextlib.contextmanager
def recorded_spans():
    """Spans on, each name the port opens appended to the yielded list."""
    real = torch.profiler.record_function
    names = []

    @contextlib.contextmanager
    def record(name, args=None):
        names.append(name)
        with real(name, args):
            yield
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", record)
        profiling.enable(True)
        try:
            yield names
        finally:
            profiling.enable(False)


@pytest.fixture(scope="module")
def ar_run():
    """The kin_poly cell at 4 envs x 3 steps on one take, in float64 on
    the CPU: its set-up (the first epoch, recorded, spans on) and check."""
    cell = spec.find_cell(spec.load_json(ROOT / "BENCHMARK.json"),
                          "kin_poly.train.e320x32")
    cell.config = dict(cell.config, n_envs=N_ENVS, rollout_steps=STEPS)
    cell.traffic = dict(cell.traffic, n_envs=N_ENVS, rollout_steps=STEPS,
                        check=dict(envs=N_ENVS, iteration=0))
    loop = cli.make_loop(cell, 3000000029, "cpu", precision="float64")
    from kinpoly_tpu_torch.data import statear
    takes = statear.load_annotations
    one_take = lambda *a, **kw: takes(*a, **kw)[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(statear, "load_annotations", one_take)
        with recorded_spans() as names:
            loop.setup()
    loop.release()
    return dict(checks={n: v for n, v, _ in loop.check()}, spans=names,
                epoch=loop.first["out"])


def test_the_epoch_ran_on_one_take(ar_run):
    assert ar_run["epoch"]["reward_mean"] > 0
    assert set(ar_run["checks"]) == set(CHECKS)


@pytest.mark.parametrize("name", CHECKS)
def test_port_matches_the_reference(ar_run, name):
    assert ar_run["checks"][name] <= TOL, (name, ar_run["checks"][name])


@pytest.mark.parametrize("name", sorted(AR_SPANS))
def test_ar_span_opened_and_mapped(ar_run, name):
    """Per control step one ``ar.kin_policy`` and one ``ar.controller``;
    per substep ``physics.objects`` around the object frames, the object
    Jacobian rows, the Delassus block, the wrench and the integration."""
    per_step = {"ar.kin_policy": 1, "ar.controller": 1,
                "physics.objects": 15 * 5}
    assert ar_run["spans"].count(name) == STEPS * per_step[name]
    assert pe.GROUPS[name] == AR_SPANS[name]


def test_uhc_rollout_opens_no_ar_span():
    cfg = UHCConfig.named("uhc")
    agent = build_trainer(get_takes(None, 2, 8, seed=1), cfg, 2, 2,
                          device="cpu")
    with recorded_spans() as names:
        agent.train_epoch(adaptive=cfg.adaptive_params(0))
    assert "env.step" in names and "physics.substep" in names
    assert not set(names) & set(AR_SPANS)


def test_reference_widths_are_the_configs():
    """The reference runs the configuration file's widths (no cut)."""
    from harness import ref_ar
    cell = spec.find_cell(spec.load_json(ROOT / "BENCHMARK.json"),
                          "kin_poly.train.e320x32")
    ref = ref_ar.Reference(cell.config, cell.traffic, ROOT, "cpu")
    kc = ref.kin_cfg
    assert (kc.rnn_hdim, kc.mlp_hsize, kc.action_dim) == (1024, (1024, 512,
                                                                  256), 80)
    net = ref.policy().net
    assert net.action_gru.weight_ih.shape == (3 * 1024, 105)
    assert dataclasses.asdict(kc)["w_ee"] == 10.0
