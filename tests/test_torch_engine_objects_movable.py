"""Port parity: one physics substep and one 15-substep control step with
movable objects with split object-floor rows and no compaction, and one
control step with the object-floor rows merged into the humanoid's
(``split_of=False``), kinpoly_tpu_torch against kinpoly_tpu, float64 on
the CPU, on the push, drop and sit cases of
``test_torch_engine_objects.py``."""

import pytest
import torch

from test_torch_engine_objects import CASES, check_case, run_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    return run_config("movable")


@pytest.mark.parametrize("step", ["substep", "control_step"])
@pytest.mark.parametrize("case", CASES)
def test_movable_step_matches_jax(runs, step, case):
    check_case(runs, "movable", step, case)


@pytest.fixture(scope="module")
def merged():
    return run_config("merged", steps=("control_step",))


@pytest.mark.parametrize("case", CASES)
def test_merged_rows_control_step_matches_jax(merged, case):
    check_case(merged, "merged", "control_step", case)
