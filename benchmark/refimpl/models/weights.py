"""Read UHC checkpoints (``results/motion_im/uhc/models/iter_*.p``), plain
pickles of numpy arrays in the JAX trainer's layout: flax parameter trees
for the policy and the value net, and a running norm. A restricted
unpickler maps the norm's class to ``RunningNorm`` and admits numpy's
array reconstructors and nothing else. Flax ``Dense`` kernels (in, out)
become torch ``Linear`` weights (out, in); the primitive bank's stacked
(P, in, out) weights and a learnable ``log_std`` keep their layout.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from refimpl.data.banks import NUMPY_GLOBALS, numpy_global
from refimpl.rl.running_norm import RunningNorm


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) == ("kinpoly_tpu.rl.running_norm", "RunningNorm"):
            return RunningNorm
        if (module, name) in NUMPY_GLOBALS:
            return numpy_global(module, name)
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
    """flax PolicyMCP or PolicyGaussian params -> the state dict of
    ``nets.PolicyMCP`` or ``nets.PolicyGaussian``."""
    p = params["params"]
    if "_PrimitiveBank_0" in p:
        sd = {f"bank.{k}": _t(v) for k, v in p["_PrimitiveBank_0"].items()}
        sd.update(_mlp("composer", p["MLP_0"]))
        sd.update(_dense("composer_head", p["Dense_0"]))
    else:   # the Gaussian policy's layers are the value net's
        sd = value_state_dict(params)
    if "log_std" in p:
        sd["log_std"] = _t(p["log_std"])
    return sd


def value_state_dict(params: dict) -> dict:
    """flax Value params -> ``nets.Value`` state dict."""
    p = params["params"]
    sd = _mlp("mlp", p["MLP_0"])
    sd.update(_dense("head", p["Dense_0"]))
    return sd


def load_uhc_checkpoint(path: str) -> dict:
    """{"policy": state dict, "value": state dict, "norm": RunningNorm of
    tensors as saved (float32 from the JAX trainer), "epoch": int,
    "success_ewma"/"seen": the clip mining history or None, "cfg": the
    trainer's config as a dict or None} from a UHC checkpoint."""
    blob = read_checkpoint(path)
    count, mean, m2 = blob["norm"]
    return dict(policy=policy_state_dict(blob["policy_params"]),
                value=value_state_dict(blob["value_params"]),
                norm=RunningNorm(_t(count), _t(mean), _t(m2)),
                epoch=int(blob["epoch"]),
                success_ewma=blob.get("success_ewma"), seen=blob.get("seen"),
                cfg=blob.get("cfg"))
