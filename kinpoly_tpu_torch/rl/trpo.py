"""TRPO policy update (port of ``kinpoly_tpu/rl/trpo.py``; reference
``uhc/khrylib/rl/agents/agent_trpo.py``): the natural gradient by conjugate
gradient on Fisher-vector products of the mean KL, then a backtracking line
search. Off the main path, part of the RL inventory.

The policy is an ``nn.Module`` evaluated on a parameter dict through
``torch.func.functional_call``. The Fisher-vector product is a double
backward through the mean KL (JAX takes a forward-over-reverse product;
the two agree in exact arithmetic), its first backward built once per
update. The whole update runs in one float dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import functional_call

from kinpoly_tpu_torch.models import nets


class TRPOConfig(NamedTuple):
    max_kl: float = 1e-2
    cg_iters: int = 10
    cg_damping: float = 1e-2
    ls_steps: int = 10
    accept_ratio: float = 0.1


def _dot(a, b) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def _add(a, b, alpha=1.0) -> list:
    return [x + alpha * y for x, y in zip(a, b)]


def conjugate_gradient(avp: Callable, b, iters: int) -> list:
    """Solve A x = b for a list of tensors b, A given by its product avp,
    in `iters` iterations from x = 0."""
    x = [torch.zeros_like(t) for t in b]
    r, p = list(b), list(b)
    rdotr = _dot(r, r)
    for _ in range(iters):
        Ap = avp(p)
        alpha = rdotr / _dot(p, Ap)
        x = _add(x, p, alpha)
        r = _add(r, Ap, -alpha)
        new_rdotr = _dot(r, r)
        p = _add(r, p, new_rdotr / rdotr)
        rdotr = new_rdotr
    return x


def trpo_update(policy: torch.nn.Module, cfg: TRPOConfig, params: dict,
                obs, actions, advantages, fixed_log_probs):
    """One TRPO step of `policy` (returning (mean, log_std)) from `params`
    (name -> tensor, e.g. ``dict(policy.named_parameters())``), in the
    parameters' dtype. Returns (new params, {"loss0",
    "accepted", "lm"}): the line search tries every fraction 0.5^k,
    k < ls_steps, and keeps the first whose improvement over the expected
    one exceeds ``accept_ratio`` with a mean KL under 1.5 ``max_kl``;
    the old parameters if none does."""
    names = list(params)
    dtype = params[names[0]].dtype
    p0 = [params[n].detach().to(dtype).clone().requires_grad_() for n in names]
    obs, actions, advantages, fixed_log_probs = (
        t.to(dtype) for t in (obs, actions, advantages, fixed_log_probs))

    def call(ps):
        return functional_call(policy, dict(zip(names, ps)), (obs,))

    def surrogate(ps):
        mean, log_std = call(ps)
        lp = nets.gaussian_log_prob(actions, mean, log_std)
        return -torch.mean(torch.exp(lp - fixed_log_probs) * advantages)

    with torch.no_grad():
        mean0, log_std0 = call(p0)

    def mean_kl(ps):
        mean, log_std = call(ps)
        return torch.mean(nets.gaussian_kl(mean0, log_std0, mean, log_std))

    def grads(y, xs, **kw):
        g = torch.autograd.grad(y, xs, allow_unused=True, **kw)
        return [torch.zeros_like(x) if gi is None else gi for gi, x in zip(g, xs)]

    loss0 = surrogate(p0)
    g = [t.detach() for t in grads(loss0, p0)]
    kl_grad = grads(mean_kl(p0), p0, create_graph=True)

    def fvp(v):
        hv = grads(_dot(kl_grad, v), p0, retain_graph=True)
        return [h.detach() + cfg.cg_damping * vi for h, vi in zip(hv, v)]

    stepdir = conjugate_gradient(fvp, [-t for t in g], cfg.cg_iters)
    shs = 0.5 * _dot(stepdir, fvp(stepdir))
    lm = torch.sqrt(torch.clamp(shs / cfg.max_kl, min=1e-12))
    fullstep = [t / lm for t in stepdir]
    expected = -_dot(g, fullstep)

    new = [t.detach() for t in p0]
    accepted = torch.zeros((), dtype=torch.bool, device=loss0.device)
    with torch.no_grad():
        for k in range(cfg.ls_steps):
            frac = 0.5 ** k
            cand = _add(new, fullstep, frac)
            improve = loss0 - surrogate(cand)
            ok = ((improve / torch.clamp(expected * frac, min=1e-12) > cfg.accept_ratio)
                  & (mean_kl(cand) < cfg.max_kl * 1.5))
            if bool(ok):
                new, accepted = cand, ok
                break
    return (dict(zip(names, new)),
            dict(loss0=loss0.detach(), accepted=accepted, lm=lm.detach()))
