"""Port parity: the AR env under the use_of config in mode "train" (the
controller's log-std pinned at -30, the ground-truth termination on):
the tests of ``test_torch_use_of_env.py`` on envs built in that mode."""

import pytest
import torch

from test_torch_use_of_env import (stepped_envs, test_config_and_context,
                                   test_reset_obs, test_step)

torch.set_num_threads(1)

__all__ = ["test_config_and_context", "test_reset_obs", "test_step"]


@pytest.fixture(scope="module")
def env():
    e = stepped_envs("train")
    assert e.tenv.mode == e.jenv.mode == "train"
    return e
