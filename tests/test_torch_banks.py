"""The port's bank reader against joblib: every ``data_bank/*.pkl`` reads
bit for bit as ``joblib.load`` reads it, a pickle that names any other
global is refused, and a state bank the port writes reads back through
both."""

import os
import pickle
from pathlib import Path

import joblib
import numpy as np
import pytest

from kinpoly_tpu_torch.data import banks
from kinpoly_tpu_torch.scripts import gen_states

ROOT = Path(__file__).resolve().parents[1]
BANKS = sorted(p.name for p in (ROOT / "data_bank").glob("*.pkl"))


def _assert_identical(got, want, path="bank"):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_identical(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_identical(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.flags.c_contiguous == want.flags.c_contiguous, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want or (got != got and want != want), path


def test_every_bank_is_here():
    assert len(BANKS) == 20


@pytest.mark.parametrize("name", BANKS)
def test_read_bank_equals_joblib(name):
    path = ROOT / "data_bank" / name
    _assert_identical(banks.read_bank(str(path)), joblib.load(path))


def test_bank_layouts():
    takes = banks.load_takes(str(ROOT / "data_bank/clips24.pkl"))
    assert len(takes) == 24
    assert {q.shape for q in takes.values()} == {(150, 76)}
    qpos, qvel = banks.load_hard_states(str(ROOT / "data_bank/hard_states_getup.pkl"))
    assert qpos.shape == (982, 76) and qvel.shape == (982, 75)


class _Shell:
    def __reduce__(self):
        return (os.system, ("exit 3",))


def test_read_bank_refuses_other_globals(tmp_path):
    for obj in ({"qpos": _Shell()}, _Shell(), np.ma.masked_array([1.0])):
        path = tmp_path / "bad.pkl"
        path.write_bytes(pickle.dumps(obj, protocol=4))
        with pytest.raises(pickle.UnpicklingError, match="not allowed"):
            banks.read_bank(str(path))


def test_written_state_bank_reads_back(tmp_path):
    rng = np.random.RandomState(0)
    qpos = rng.normal(0, 1, (7, 76)).astype(np.float32)
    qvel = rng.normal(0, 1, (7, 75)).astype(np.float32)
    path = str(tmp_path / "states.pkl")
    gen_states.write_states(path, qpos, qvel)
    for got in (banks.read_bank(path), joblib.load(path)):
        _assert_identical(got, {"qpos": qpos, "qvel": qvel})
    assert banks.load_hard_states(path)[1].shape == (7, 75)
