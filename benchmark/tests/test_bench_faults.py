"""A run with the timed path broken underneath comes out not correct.
The cell is driven on the CPU at a small size (the harness's look for a
chip skipped), with one window iteration, each fault it can have planted
(``harness/faults.py``); the limits are the cell's own, and a number that
has to catch the fault exceeds its limit. The exchange between chips is a
fault no one-chip cell has. (Sound runs are held to the limits on the
card, at the cell's size: ``test_bench_control_cuda.py``.)"""

import math

import pytest
import torch

from harness import cli, faults, spec

WORKLOAD = "uhc.train.e1024"
# 8 envs, all recorded, so that every eighth env is among them
SMALL = dict(n_envs=8, rollout_steps=3, check={"envs": 8, "iteration": 0})
# the numbers each fault has to fail (it may fail others too)
CAUGHT_BY = {
    "frozen_step": {"grad1", "change3"},
    "half_batch": {"value_loss", "policy_loss", "grad1", "change3"},
    "altered_answer": {"step_reward"},
    "eighth_unstepped": {"step_state"},
    "half_unstepped": {"step_state"},
}


def checks_of(fault):
    torch.set_num_threads(2)
    cell = spec.find_cell(spec.load_json(spec.BENCH_DIR.parent
                                         / "BENCHMARK.json"), WORKLOAD)
    cell.traffic.update(SMALL)
    _, loop, checks, _ = cli.execute(cell, 2718281829, 1e-3, False,
                                     device="cpu", fault=fault)
    assert loop.window_rec is not None and loop.window_rec.calls
    return checks


@pytest.fixture(scope="module")
def sound():
    return {n: v for n, v, _ in checks_of(None)}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_caught(sound, fault):
    """The fault fails a number that it has to fail, which it reads above
    its limit and at ten times the sound run's reading or more (a few
    rows at this size read float32 against float64 wider than the cell's
    hundreds do)."""
    checks = checks_of(fault)
    assert all(math.isfinite(lim) for _, _, lim in checks)
    failed = {n for n, v, lim in checks
              if not v <= lim and not v < 10 * sound[n]}
    assert failed & CAUGHT_BY[fault], (checks, sound)
