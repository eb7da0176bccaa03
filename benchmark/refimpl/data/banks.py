"""Read the expert and state banks in ``data_bank/*.pkl`` without joblib.

Every bank is an uncompressed joblib pickle (protocol 4): a dict tree whose
arrays are ``joblib.numpy_pickle.NumpyArrayWrapper`` objects. In the stream,
the ``BUILD`` of each wrapper ends a committed frame and is followed, outside
any frame, by one pad-length byte, that many pad bytes and the raw array
bytes. ``read_bank`` reads them with a restricted unpickler: the wrapper maps
to a local stand-in, numpy's dtype and array reconstructors are admitted,
and any other global is refused, so reading a bank runs no other code. The
same reader takes plain numpy pickles (``_reconstruct``), such as the state
banks that ``scripts/gen_states.py`` writes.
"""

from __future__ import annotations

import importlib
import pickle

import numpy as np

NUMPY_GLOBALS = frozenset({
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"), ("numpy.core.multiarray", "scalar"),
})


def numpy_global(module: str, name: str):
    """One of ``NUMPY_GLOBALS``, from numpy 1.x or 2.x whichever is
    installed (numpy 1.x names ``numpy._core`` ``numpy.core``)."""
    try:
        mod = importlib.import_module(module)
    except ImportError:
        mod = importlib.import_module(module.replace("._core", ".core"))
    return getattr(mod, name)


class _ArrayWrapper:
    """Stand-in for ``joblib.numpy_pickle.NumpyArrayWrapper``: takes its
    pickled state (subclass, shape, order, dtype, ...) and nothing else."""


class _BankUnpickler(pickle._Unpickler):
    """The standard library's pure-Python unpickler, whose ``BUILD`` of a
    wrapper reads the array bytes that follow it in the file."""

    def __init__(self, file):
        super().__init__(file)
        self._raw = file

    def find_class(self, module: str, name: str):
        if (module, name) == ("joblib.numpy_pickle", "NumpyArrayWrapper"):
            return _ArrayWrapper
        if (module, name) in NUMPY_GLOBALS:
            return numpy_global(module, name)
        raise pickle.UnpicklingError(
            f"bank refers to {module}.{name}, which is not allowed")

    def _load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack[-1] = self._read_array(self.stack[-1].__dict__)

    def _read_array(self, meta: dict) -> np.ndarray:
        if meta["subclass"] is not np.ndarray:
            raise pickle.UnpicklingError(
                f"array subclass {meta['subclass']!r} is not allowed")
        dtype, shape = meta["dtype"], tuple(meta["shape"])
        if dtype.hasobject:
            return _BankUnpickler(self._raw).load()
        # the bytes follow the frame that ended with BUILD: read them from
        # the file itself, not through the unpickler's framed read
        if meta.get("numpy_array_alignment_bytes") is not None:
            self._raw.read(self._raw.read(1)[0])
        n_bytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        data = self._raw.read(n_bytes)
        if len(data) != n_bytes:
            raise pickle.UnpicklingError("bank ends inside an array")
        arr = np.frombuffer(data, dtype=dtype).copy()
        if meta["order"] == "F":
            arr = arr.reshape(shape[::-1]).transpose()
        else:
            arr = arr.reshape(shape)
        if not dtype.isnative:
            arr = arr.astype(dtype.newbyteorder("="))
        return arr

    dispatch = dict(pickle._Unpickler.dispatch)
    dispatch[pickle.BUILD[0]] = _load_build


def read_bank(path: str):
    """The object a ``data_bank/*.pkl`` holds (for the expert banks a dict
    of takes, each a dict of numpy arrays), equal to ``joblib.load(path)``."""
    with open(path, "rb") as f:
        return _BankUnpickler(f).load()


def load_takes(path: str) -> dict:
    """An expert bank as {take name: qpos (T, 76) float32}; a bank that
    holds a top-level ``qpos`` is one take (the JAX scripts' reading)."""
    takes = read_bank(path)
    if "qpos" in takes:
        takes = {"take_0": takes}
    return {k: np.asarray(t["qpos"], np.float32) for k, t in takes.items()}


def load_hard_states(path: str) -> tuple[np.ndarray, np.ndarray]:
    """A reactive_v 2 start bank: (qpos (K, 76), qvel (K, 75)) float32."""
    hs = read_bank(path)
    return (np.asarray(hs["qpos"], np.float32),
            np.asarray(hs["qvel"], np.float32))
