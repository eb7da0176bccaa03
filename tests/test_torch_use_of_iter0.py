"""Port parity: the tracked use_of warm start
``results_r4/statear/use_of/models/iter_0000.p`` at use_of.yml's full
widths, read by the JAX package's pickle and by the port's restricted
reader, kinpoly_tpu_torch against kinpoly_tpu in float64 on the CPU."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import torch

from kinpoly_tpu.models import policy_ar as jpa
from kinpoly_tpu_torch.anim import spec as sp
from kinpoly_tpu_torch.models import policy_ar as tpa
from kinpoly_tpu_torch.models import weights

from test_torch_objects import jax_spec
from test_torch_use_of_policy import _close, configs, f64, jclip, of_clips, tclip

torch.set_num_threads(1)

NET_TOL = 1e-6       # full-width network outputs
ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "results_r4", "statear", "use_of", "models",
                    "iter_0000.p")


def test_iter_0000_full_width():
    """The tracked use_of warm start at use_of.yml's widths (GRUs 529 ->
    256 and 873 -> 256, the delta 949 -> 512), read by the JAX package's
    pickle and by the port's restricted reader: init_context and the
    policy's first actions on two wild takes."""
    spec = sp.synthetic_spec(0, with_objects=True)
    jspec, st = jax_spec(spec), sp.spec_tensors(spec, torch.float64, "cpu")
    with open(CKPT, "rb") as f:
        blob = pickle.load(f)
    params = f64(blob["params"])
    ck = weights.load_ar_checkpoint(CKPT)
    assert ck["epoch"] == blob["epoch"] == 0 and ck["delta"] is not None
    jc, tc = configs()
    clip = of_clips(spec, 2, 12)
    jp = jpa.PolicyAR(jspec, jc, policy_v=2)
    tp = tpa.PolicyAR(spec, st, tc, policy_v=2).to(dtype=torch.float64)
    tp.net.load_state_dict(ck["policy"])
    tp.delta_net.load_state_dict(ck["delta"])
    assert tp.net.action_gru.input_size == 873
    assert tp.delta_net.rnn.input_size == 949
    cj = jp.init_context(params, jclip(clip))
    ct = tp.init_context(tclip(clip))
    for k in ("ar_qpos", "init_qpos", "init_qvel", "context_feat"):
        _close(cj[k], ct[k], NET_TOL)
    obs = np.random.RandomState(2).normal(0, 0.5, (2, 949))
    obs[:, -76:] = clip.qpos[:, 0]
    h = np.zeros((2, 512))
    cj, aj = jp.action_mean(params, jnp.asarray(h), jnp.asarray(obs))
    with torch.no_grad():
        ct, at = tp.action_mean(torch.tensor(h), torch.tensor(obs))
    _close(cj, ct, NET_TOL)
    _close(aj, at, NET_TOL)
