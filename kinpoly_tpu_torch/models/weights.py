"""Read and write UHC checkpoints (``results/motion_im/uhc/models/iter_*.p``)
in the JAX package's layout, and read the kinematic policy's
(``results*/statear/kin_poly/models/iter_*.p``).

The checkpoints are plain pickles of numpy arrays: flax parameter trees for
the policy and the value net, and a ``kinpoly_tpu.rl.running_norm.RunningNorm``.
A restricted unpickler maps that class to the port's own ``RunningNorm`` and
admits numpy's array reconstructors and nothing else, so neither JAX nor the
JAX package is imported and no other code can run. The file is read in
place.

Flax ``Dense`` kernels (in, out) become torch ``Linear`` weights (out, in)
and back; the primitive bank's stacked (P, in, out) weights and a learnable
``log_std`` keep their layout. ``policy_params``/``value_params`` give the
flax trees (nested dicts of numpy arrays) that the port's trainer saves.
A flax ``GRUCell`` (``ir/iz/in`` with biases, ``hr/hz`` without, ``hn``
with) becomes a torch GRU's stacked (r, z, n) weights with zero hidden
biases on r and z (``trajar_from_jax``).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from kinpoly_tpu_torch.data.banks import NUMPY_GLOBALS, numpy_global
from kinpoly_tpu_torch.rl.running_norm import RunningNorm


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


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().copy()


def _flax_dense(sd: dict, prefix: str) -> dict:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T.copy(),
            "bias": _np(sd[f"{prefix}.bias"])}


def _flax_mlp(sd: dict, prefix: str) -> dict:
    n = len({k.split(".")[2] for k in sd if k.startswith(f"{prefix}.layers.")})
    return {f"Dense_{i}": _flax_dense(sd, f"{prefix}.layers.{i}")
            for i in range(n)}


def policy_params(sd: dict) -> dict:
    """``nets.PolicyMCP`` or ``nets.PolicyGaussian`` state dict -> flax
    params of the same policy."""
    if "head.weight" in sd:
        p = value_params(sd)["params"]
    else:
        p = {"_PrimitiveBank_0": {k[len("bank."):]: _np(v)
                                  for k, v in sd.items() if k.startswith("bank.")},
             "MLP_0": _flax_mlp(sd, "composer"),
             "Dense_0": _flax_dense(sd, "composer_head")}
    if "log_std" in sd:
        p["log_std"] = _np(sd["log_std"])
    return {"params": p}


def value_params(sd: dict) -> dict:
    """``nets.Value`` state dict -> flax Value params."""
    return {"params": {"MLP_0": _flax_mlp(sd, "mlp"),
                       "Dense_0": _flax_dense(sd, "head")}}


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


def _gru(prefix: str, d: dict, suffix: str = "") -> dict:
    """flax GRUCell params -> torch GRUCell (suffix "") or single-layer GRU
    (suffix "_l0") state dict entries."""
    w_ih = np.concatenate([np.asarray(d[g]["kernel"]).T for g in ("ir", "iz", "in")])
    w_hh = np.concatenate([np.asarray(d[g]["kernel"]).T for g in ("hr", "hz", "hn")])
    b_ih = np.concatenate([np.asarray(d[g]["bias"]) for g in ("ir", "iz", "in")])
    b_hn = np.asarray(d["hn"]["bias"])
    b_hh = np.concatenate([np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])
    return {f"{prefix}.weight_ih{suffix}": _t(w_ih),
            f"{prefix}.weight_hh{suffix}": _t(w_hh),
            f"{prefix}.bias_ih{suffix}": _t(b_ih),
            f"{prefix}.bias_hh{suffix}": _t(b_hh)}


def trajar_from_jax(params: dict) -> dict:
    """flax TrajARNet params -> the state dict of ``traj_ar.TrajARNet``."""
    p = params["params"]
    sd = _gru("context_gru", p["context_gru"], "_l0")
    sd.update(_mlp("context_mlp", p["context_mlp"]))
    sd.update(_dense("context_fc", p["context_fc"]))
    if "action_gru" in p:
        sd.update(_gru("action_gru", p["action_gru"]))
    sd.update(_mlp("action_mlp", p["action_mlp"]))
    sd.update(_dense("action_fc", p["action_fc"]))
    return sd


def load_ar_checkpoint(path: str) -> dict:
    """{"policy": TrajARNet state dict, "value": ``nets.Value`` state dict,
    "cc": the jointly tuned UHC controller's ``nets.PolicyMCP``/
    ``PolicyGaussian`` state dict or None, "epoch": int, "freq": the
    per-take success history} from a kinematic-policy checkpoint."""
    blob = read_checkpoint(path)
    cc = blob.get("cc_params")
    return dict(policy=trajar_from_jax(blob["params"]),
                value=value_state_dict(blob["value_params"]),
                cc=None if cc is None else policy_state_dict(cc),
                epoch=int(blob["epoch"]), freq=blob.get("freq") or {})
