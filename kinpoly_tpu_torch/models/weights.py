"""Read and write UHC checkpoints (``results/motion_im/uhc/models/iter_*.p``)
and the kinematic policy's (``results*/statear/<cfg>/models/iter_*.p``)
in the JAX package's layout, and map the flow encoder's flax ResNet-18
(``data_bank/of_encoder.pkl``) onto the port's.

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
biases on r and z (``trajar_from_jax``), and back (``trajar_to_jax``,
which refuses a non-zero r or z hidden bias: flax has no place for it);
so does policy_v 2's residual head (``delta_from_jax``/``delta_to_jax``),
which a policy_v 2 checkpoint stores beside TrajARNet as
``params = {"arnet": ..., "delta": ...}``.

The model zoo (``models/aux_nets.py``, ``models/rnn.py``) has one
``<net>_from_jax(variables)`` per net: flax ``Conv`` kernels (*k, in, out)
become torch's (out, in, *k) (a depthwise kernel (3, 3, 1, C) becomes
(C, 1, 3, 3)), a ``ConvTranspose`` kernel (*k, in, out) becomes (in, out,
*k) flipped on every spatial axis (``aux_nets.ConvTranspose``), a
``BatchNorm``'s scale, bias and batch_stats its weight, bias and running
statistics, an ``OptimizedLSTMCell``'s gates a torch LSTM's stacked
(i, f, g, o) with the biases on the hidden side.
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


def _flax_gru(sd: dict, prefix: str, suffix: str = "") -> dict:
    w_ih = _np(sd[f"{prefix}.weight_ih{suffix}"])
    w_hh = _np(sd[f"{prefix}.weight_hh{suffix}"])
    b_ih = _np(sd[f"{prefix}.bias_ih{suffix}"])
    b_hh = _np(sd[f"{prefix}.bias_hh{suffix}"])
    H = w_hh.shape[1]
    if np.any(b_hh[:2 * H] != 0):
        raise ValueError(f"{prefix}: non-zero r/z hidden bias, which a flax "
                         f"GRUCell does not have")
    part = lambda x, i: x[i * H:(i + 1) * H]
    out = {g: {"kernel": part(w_ih, i).T.copy(), "bias": part(b_ih, i).copy()}
           for i, g in enumerate(("ir", "iz", "in"))}
    out.update({g: {"kernel": part(w_hh, i).T.copy()}
                for i, g in enumerate(("hr", "hz"))})
    out["hn"] = {"kernel": part(w_hh, 2).T.copy(), "bias": part(b_hh, 2).copy()}
    return out


def trajar_to_jax(sd: dict) -> dict:
    """``traj_ar.TrajARNet`` state dict -> flax TrajARNet params."""
    p = {"context_gru": _flax_gru(sd, "context_gru", "_l0"),
         "context_mlp": _flax_mlp(sd, "context_mlp"),
         "context_fc": _flax_dense(sd, "context_fc")}
    if "action_gru.weight_ih" in sd:
        p["action_gru"] = _flax_gru(sd, "action_gru")
    p["action_mlp"] = _flax_mlp(sd, "action_mlp")
    p["action_fc"] = _flax_dense(sd, "action_fc")
    return {"params": p}


def delta_from_jax(params: dict) -> dict:
    """flax ActionDeltaNet params -> the state dict of
    ``policy_ar.ActionDeltaNet``."""
    p = params["params"]
    sd = _gru("rnn", p["rnn"])
    sd.update(_mlp("mlp", p["mlp"]))
    sd.update(_dense("fc", p["fc"]))
    return sd


def delta_to_jax(sd: dict) -> dict:
    """``policy_ar.ActionDeltaNet`` state dict -> flax ActionDeltaNet
    params."""
    return {"params": {"rnn": _flax_gru(sd, "rnn"),
                       "mlp": _flax_mlp(sd, "mlp"),
                       "fc": _flax_dense(sd, "fc")}}


def policy_ar_params(policy) -> dict:
    """A ``policy_ar.PolicyAR``'s flax params: TrajARNet's tree, or with
    policy_v 2 {"arnet": that tree, "delta": the residual head's}."""
    arnet = trajar_to_jax(policy.net.state_dict())
    if policy.delta_net is None:
        return arnet
    return {"arnet": arnet,
            "delta": delta_to_jax(policy.delta_net.state_dict())}


def load_ar_checkpoint(path: str) -> dict:
    """{"policy": TrajARNet state dict, "delta": ``ActionDeltaNet`` state
    dict of a policy_v 2 checkpoint or None, "value": ``nets.Value`` state
    dict, "cc": the jointly tuned UHC controller's ``nets.PolicyMCP``/
    ``PolicyGaussian`` state dict or None, "epoch": int, "freq": the
    per-take success history} from a kinematic-policy checkpoint."""
    blob = read_checkpoint(path)
    cc = blob.get("cc_params")
    params = blob["params"]
    delta = None
    if "arnet" in params:
        params, delta = params["arnet"], delta_from_jax(params["delta"])
    return dict(policy=trajar_from_jax(params), delta=delta,
                value=value_state_dict(blob["value_params"]),
                cc=None if cc is None else policy_state_dict(cc),
                epoch=int(blob["epoch"]), freq=blob.get("freq") or {})


def _conv(prefix: str, d: dict) -> dict:
    """flax ``Conv`` (kernel (*k, in/groups, out)) -> torch (out,
    in/groups, *k), with its bias where it has one."""
    k = np.asarray(d["kernel"])
    nd = k.ndim - 2
    sd = {f"{prefix}.weight": _t(k.transpose((nd + 1, nd) + tuple(range(nd))))}
    if "bias" in d:
        sd[f"{prefix}.bias"] = _t(d["bias"])
    return sd


def _conv_transpose(prefix: str, d: dict) -> dict:
    """flax ``ConvTranspose`` (kernel (*k, in, out)) -> ``aux_nets.
    ConvTranspose``'s (in, out, *k), flipped on every spatial axis."""
    k = np.asarray(d["kernel"])
    nd = k.ndim - 2
    w = k.transpose((nd, nd + 1) + tuple(range(nd)))
    w = np.flip(w, axis=tuple(range(2, nd + 2)))
    return {f"{prefix}.weight": _t(w), f"{prefix}.bias": _t(d["bias"])}


def _bn(prefix: str, d: dict, stats: dict) -> dict:
    return {f"{prefix}.weight": _t(d["scale"]), f"{prefix}.bias": _t(d["bias"]),
            f"{prefix}.running_mean": _t(stats["mean"]),
            f"{prefix}.running_var": _t(stats["var"])}


def _lstm(prefix: str, d: dict) -> dict:
    """flax ``OptimizedLSTMCell`` (input kernels ii/if/ig/io without bias,
    hidden kernels hi/hf/hg/ho with one) -> a one-layer torch LSTM's
    stacked (i, f, g, o) weights, the biases on the hidden side."""
    w_ih = np.concatenate([np.asarray(d[g]["kernel"]).T for g in ("ii", "if", "ig", "io")])
    w_hh = np.concatenate([np.asarray(d[g]["kernel"]).T for g in ("hi", "hf", "hg", "ho")])
    b_hh = np.concatenate([np.asarray(d[g]["bias"]) for g in ("hi", "hf", "hg", "ho")])
    return {f"{prefix}.weight_ih_l0": _t(w_ih), f"{prefix}.weight_hh_l0": _t(w_hh),
            f"{prefix}.bias_ih_l0": _t(np.zeros_like(b_hh)),
            f"{prefix}.bias_hh_l0": _t(b_hh)}


def _rnn(prefix: str, d: dict) -> dict:
    """flax ``rnn.RNN`` params -> ``rnn.RNN``'s state dict entries, keys
    prefixed by `prefix` ("" or "<name>.")."""
    sd = {}
    for cell in ("cell", "cell_bwd"):
        if cell in d:
            c = d[cell]
            sd.update(_lstm(f"{prefix}{cell}", c) if "ii" in c
                      else _gru(f"{prefix}{cell}", c, "_l0"))
    return sd


def _resnet18(prefix: str, p: dict, bs: dict) -> dict:
    sd = _conv(f"{prefix}conv", p["Conv_0"])
    sd.update(_bn(f"{prefix}bn", p["BatchNorm_0"], bs["BatchNorm_0"]))
    i = 0
    while f"ResBlock_{i}" in p:
        b, s, pre = p[f"ResBlock_{i}"], bs[f"ResBlock_{i}"], f"{prefix}blocks.{i}"
        for j in (0, 1):
            sd.update(_conv(f"{pre}.conv{j}", b[f"Conv_{j}"]))
            sd.update(_bn(f"{pre}.bn{j}", b[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"]))
        if "Conv_2" in b:
            sd.update(_conv(f"{pre}.shortcut", b["Conv_2"]))
        i += 1
    sd.update(_dense(f"{prefix}fc", p["Dense_0"]))
    return sd


def resnet18_from_jax(variables: dict) -> dict:
    """flax ResNet18 variables ({"params", "batch_stats"}) -> the state
    dict of ``aux_nets.ResNet18``: ``Conv`` HWIO kernels to OIHW,
    ``BatchNorm`` scale/bias/mean/var to weight/bias/running_mean/
    running_var, ``Dense`` transposed."""
    return _resnet18("", variables["params"], variables["batch_stats"])


def rnn_from_jax(variables: dict) -> dict:
    """flax ``RNN`` params -> the state dict of ``rnn.RNN``."""
    return _rnn("", variables["params"])


def _dw_block(prefix: str, p: dict, bs: dict) -> dict:
    sd = _conv(f"{prefix}conv_dw", p["Conv_0"])
    sd.update(_bn(f"{prefix}bn0", p["BatchNorm_0"], bs["BatchNorm_0"]))
    sd.update(_conv(f"{prefix}conv_pw", p["Conv_1"]))
    sd.update(_bn(f"{prefix}bn1", p["BatchNorm_1"], bs["BatchNorm_1"]))
    return sd


def dw_block_from_jax(variables: dict) -> dict:
    """flax DWBlock variables -> the state dict of ``aux_nets.DWBlock``
    (the depthwise kernel (3, 3, 1, C) becomes (C, 1, 3, 3))."""
    return _dw_block("", variables["params"], variables["batch_stats"])


def mobile_net_from_jax(variables: dict) -> dict:
    """flax MobileNet variables -> ``aux_nets.MobileNet``'s state dict."""
    p, bs = variables["params"], variables["batch_stats"]
    sd = _conv("conv", p["Conv_0"])
    sd.update(_bn("bn", p["BatchNorm_0"], bs["BatchNorm_0"]))
    i = 0
    while f"DWBlock_{i}" in p:
        sd.update(_dw_block(f"blocks.{i}.", p[f"DWBlock_{i}"], bs[f"DWBlock_{i}"]))
        i += 1
    sd.update(_dense("fc", p["Dense_0"]))
    return sd


def _convs(prefix: str, p: dict, name: str = "Conv") -> dict:
    sd, i = {}, 0
    while f"{name}_{i}" in p:
        conv = _conv_transpose if name == "ConvTranspose" else _conv
        sd.update(conv(f"{prefix}.{i}", p[f"{name}_{i}"]))
        i += 1
    return sd


def simple_cnn_from_jax(variables: dict) -> dict:
    """flax SimpleCNN params -> ``aux_nets.SimpleCNN``'s state dict."""
    p = variables["params"]
    sd = _convs("convs", p)
    sd.update(_dense("fc", p["Dense_0"]))
    return sd


def tcn_from_jax(variables: dict) -> dict:
    """flax TCN params -> ``aux_nets.TCN``'s state dict (1-D kernels (k,
    in, out) to torch's (out, in, k))."""
    return simple_cnn_from_jax(variables)


def erd_net_from_jax(variables: dict) -> dict:
    """flax ERDNet params -> ``aux_nets.ERDNet``'s state dict."""
    p = variables["params"]
    sd = _mlp("enc", p["MLP_0"])
    sd.update(_rnn("rnn.", p["RNN_0"]))
    sd.update(_mlp("dec", p["MLP_1"]))
    sd.update(_dense("fc", p["Dense_0"]))
    return sd


def _mlp_head(variables: dict) -> dict:
    p = variables["params"]
    sd = _mlp("mlp", p["MLP_0"])
    sd.update(_dense("fc", p["Dense_0"]))
    return sd


def cmlp_from_jax(variables: dict) -> dict:
    """flax CMLP params -> ``aux_nets.CMLP``'s state dict."""
    return _mlp_head(variables)


def discriminator_from_jax(variables: dict) -> dict:
    """flax Discriminator params -> ``aux_nets.Discriminator``'s state dict."""
    return _mlp_head(variables)


def policy_discrete_from_jax(variables: dict) -> dict:
    """flax PolicyDiscrete params -> ``aux_nets.PolicyDiscrete``'s state
    dict."""
    return _mlp_head(variables)


def video_reg_net_from_jax(variables: dict) -> dict:
    """flax VideoRegNet variables -> ``aux_nets.VideoRegNet``'s state dict."""
    p, bs = variables["params"], variables["batch_stats"]
    sd = _resnet18("cnn.", p["ResNet18_0"], bs["ResNet18_0"])
    sd.update(_rnn("rnn.", p["RNN_0"]))
    sd.update(_mlp_head(variables))
    return sd


def video_state_net_from_jax(variables: dict) -> dict:
    """flax VideoStateNet params -> ``aux_nets.VideoStateNet``'s state dict."""
    p = variables["params"]
    sd = _rnn("rnn.", p["RNN_0"])
    sd.update(_dense("fc", p["Dense_0"]))
    return sd


def video_forecast_net_from_jax(variables: dict) -> dict:
    """flax VideoForecastNet params -> ``aux_nets.VideoForecastNet``'s state
    dict (the decoder ``GRUCell``'s (1, H) input kernel included)."""
    p = variables["params"]
    sd = _rnn("rnn.", p["RNN_0"])
    sd.update(_gru("dec.cell", p["GRUCell_0"], "_l0"))
    sd.update(_dense("fc", p["Dense_0"]))
    return sd


def space_net_from_jax(variables: dict) -> dict:
    """flax SpaceNet params -> ``aux_nets.SpaceNet``'s state dict (3-D
    kernels; the transposed convolutions' flipped, ``aux_nets.
    ConvTranspose``)."""
    p = variables["params"]
    sd = _convs("convs", p)
    sd.update(_dense("mu", p["Dense_0"]))
    sd.update(_dense("logvar", p["Dense_1"]))
    sd.update(_dense("dec_in", p["Dense_2"]))
    sd.update(_convs("deconvs", p, "ConvTranspose"))
    return sd
