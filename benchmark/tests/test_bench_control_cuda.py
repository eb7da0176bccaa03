"""The control on the card: the program with TF32 matmuls in place of the
configuration's float32 comes out not correct, at a size a test run holds
(a quarter of the cell's envs; the readings that set the limits were
taken at the cell's own size with ``benchmark/control.py``). Run on
a machine with a card:

    python -m pytest -m cuda benchmark/tests/test_bench_control_cuda.py
"""

import math

import pytest
import torch

from harness import cli, spec

pytestmark = pytest.mark.cuda

SMALLER = {"uhc.train.e1024": dict(n_envs=256)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def workloads():
    return [w["name"] for w in spec.load_json(
        spec.BENCH_DIR.parent / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("workload", workloads())
def test_control_is_not_correct(card, workload):
    cell = spec.find_cell(spec.load_json(spec.BENCH_DIR.parent
                                         / "BENCHMARK.json"), workload)
    cell.traffic.update(SMALLER.get(workload, {}))
    _, _, checks, _ = cli.execute(cell, 3141592654, 0.0, False,
                                  precision="tf32", profile=False)
    assert not all(math.isfinite(v) and v <= lim for _, v, lim in checks), \
        checks
