"""Port parity: one physics substep and one 15-substep control step with
static objects posed per control step (``control_step(..., obj_qpos=)``), kinpoly_tpu_torch against kinpoly_tpu, float64 on the CPU, on the
push, drop and sit cases of ``test_torch_engine_objects.py``."""

import pytest
import torch

from test_torch_engine_objects import CASES, check_case, run_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    return run_config("static")


@pytest.mark.parametrize("step", ["substep", "control_step"])
@pytest.mark.parametrize("case", CASES)
def test_static_step_matches_jax(runs, step, case):
    check_case(runs, "static", step, case)
