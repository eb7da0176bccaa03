"""Port parity: the AR rollout with the evaluation's fail-safe (a failing
env teleports to the AR rollout's pose and runs on to the end of its take),
kinpoly_tpu_torch against kinpoly_tpu, float64 on the CPU, as
``test_torch_rollout_ar.py``."""

import pytest
import torch

from test_torch_env_ar import build_envs
from test_torch_rollout_ar import THRESH, check_rollout

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def envs():
    return build_envs(body_diff_thresh=THRESH)


def test_ar_rollout_fail_safe_matches_jax(envs):
    check_rollout(envs, fail_safe=True)
