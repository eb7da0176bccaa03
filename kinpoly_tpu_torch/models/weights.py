"""Load a trained UHC checkpoint (``results/motion_im/uhc/models/iter_*.p``)
into the port.

The checkpoints are plain pickles of numpy arrays: flax parameter trees for
the policy and the value net, and a ``kinpoly_tpu.rl.running_norm.RunningNorm``.
A restricted unpickler maps that class to the port's own ``RunningNorm`` and
admits numpy's array reconstructors and nothing else, so neither JAX nor the
JAX package is imported and no other code can run. The file is read in
place.

Flax ``Dense`` kernels (in, out) become torch ``Linear`` weights (out, in);
the primitive bank's stacked (P, in, out) weights keep their layout
(``kinpoly_tpu/models/torch_import.py`` holds the reverse mapping).
"""

from __future__ import annotations

import importlib
import pickle

import numpy as np
import torch

from kinpoly_tpu_torch.rl.running_norm import RunningNorm

_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"), ("numpy.core.multiarray", "scalar"),
}


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) == ("kinpoly_tpu.rl.running_norm", "RunningNorm"):
            return RunningNorm
        if (module, name) in _NUMPY_GLOBALS:
            try:
                mod = importlib.import_module(module)
            except ImportError:   # numpy 1.x names numpy._core numpy.core
                mod = importlib.import_module(module.replace("._core", ".core"))
            return getattr(mod, name)
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}, which is not allowed")


def read_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _dense(prefix: str, d: dict) -> dict:
    return {f"{prefix}.weight": _t(np.asarray(d["kernel"]).T),
            f"{prefix}.bias": _t(d["bias"])}


def _mlp(prefix: str, d: dict) -> dict:
    out = {}
    for i in range(len(d)):
        out.update(_dense(f"{prefix}.layers.{i}", d[f"Dense_{i}"]))
    return out


def policy_state_dict(params: dict) -> dict:
    """flax PolicyMCP params -> ``nets.PolicyMCP`` state dict."""
    p = params["params"]
    sd = {f"bank.{k}": _t(v) for k, v in p["_PrimitiveBank_0"].items()}
    sd.update(_mlp("composer", p["MLP_0"]))
    sd.update(_dense("composer_head", p["Dense_0"]))
    return sd


def value_state_dict(params: dict) -> dict:
    """flax Value params -> ``nets.Value`` state dict."""
    p = params["params"]
    sd = _mlp("mlp", p["MLP_0"])
    sd.update(_dense("head", p["Dense_0"]))
    return sd


def load_uhc_checkpoint(path: str) -> dict:
    """{"policy": state dict, "value": state dict, "norm": RunningNorm of
    float32 tensors, "epoch": int} from a UHC checkpoint."""
    blob = read_checkpoint(path)
    count, mean, m2 = blob["norm"]
    return dict(policy=policy_state_dict(blob["policy_params"]),
                value=value_state_dict(blob["value_params"]),
                norm=RunningNorm(_t(count), _t(mean), _t(m2)),
                epoch=int(blob["epoch"]))
