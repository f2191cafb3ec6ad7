"""FCPO losses (Eqs. 3–5), GAE, loss gate, and the iAgent update.

Port of ``repro.core.ppo`` over the stacked fleet: every function takes
(A, T, ...) rollouts and returns per-agent (A,) values. Gradients come from
``torch.autograd`` over the *sum* of the per-agent losses; the parameters
are per agent, so the gradients separate.

Notes carried over from the reference:
  * Eq. 4 reads "GAE" as the advantage deficit (−Â); ``policy_mode="ppo"``
    is the standard clipped surrogate.
  * Advantages are normalised with the *population* std (``jnp.std``), so
    ``std(correction=0)`` here.
  * The loss gate (§IV-C) is per agent: a gated agent keeps its params and
    its whole optimizer state (``t`` does not advance). The fleet runs one
    batched backward and the gate selects afterwards — a batched backward
    cannot skip a subset of agents.
  * A non-finite loss or update keeps the old params AND the old optimizer
    state of that agent.
  * ``finetune_heads`` freezes the backbone and value head, but their Adam
    moments still update (the reference's frozen-leaf ``where``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.agent import ActionMask, action_logp
from repro_torch.resilience.guards import finite_mask


@dataclass
class Rollout:
    """One episode of experience per agent (A, T, ...)."""
    states: torch.Tensor     # (A, T, 8)
    actions: torch.Tensor    # (A, T, 3) long
    logp_old: torch.Tensor   # (A, T)
    rewards: torch.Tensor    # (A, T)
    values_old: torch.Tensor  # (A, T)


def gae(cfg: FCPOConfig, rewards, values):
    """Generalized Advantage Estimation (γ=λ=0.1), (A, T); bootstrap 0
    after the last step."""
    v_next = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], -1)
    deltas = rewards + cfg.gamma * v_next - values
    carry, advs = 0.0, []
    for t in reversed(range(deltas.shape[1])):
        carry = deltas[:, t] + cfg.gamma * cfg.lam * carry
        advs.append(carry)
    return torch.stack(advs[::-1], dim=1)


def returns(cfg: FCPOConfig, rewards):
    carry, rets = 0.0, []
    for t in reversed(range(rewards.shape[1])):
        carry = rewards[:, t] + cfg.gamma * carry
        rets.append(carry)
    return torch.stack(rets[::-1], dim=1)


def _normalized_adv(cfg: FCPOConfig, rollout: Rollout):
    adv = gae(cfg, rollout.rewards, rollout.values_old)
    return ((adv - adv.mean(-1, keepdim=True))
            / (adv.std(-1, correction=0, keepdim=True) + 1e-6))


def fcpo_loss(cfg: FCPOConfig, params, rollout: Rollout, mask: ActionMask):
    """Per-agent total loss l = l_p + l_v + ω·mean(a[0]+a[2]) (Eq. 3), (A,),
    and its parts."""
    logp, values, _ = action_logp(cfg, params, rollout.states,
                                  rollout.actions, mask)
    ratio = torch.exp(logp - rollout.logp_old)
    adv = _normalized_adv(cfg, rollout)

    if cfg.policy_mode == "ppo":  # beyond-paper: standard clipped surrogate
        clipped = torch.clamp(ratio, 1 - (1 - cfg.eps_clip),
                              1 + (1 - cfg.eps_clip))
        l_p = -torch.minimum(ratio * adv, clipped * adv).mean(-1)
    else:  # Eq. 4, with GAE read as the advantage deficit
        factor = -adv + torch.exp(-rollout.rewards)
        l_p = (torch.minimum(cfg.eps_clip * ratio, ratio) * factor).mean(-1)

    l_v = torch.square(values - returns(cfg, rollout.rewards)).mean(-1)

    # Eq. 3 penalty: normalized RES / MT indices
    a = rollout.actions.to(torch.float32)
    a_res = a[..., 0] / max(cfg.n_res - 1, 1)
    a_mt = a[..., 2] / max(cfg.n_mt - 1, 1)
    l_pen = cfg.omega * (a_res + a_mt).mean(-1)

    total = l_p + l_v + l_pen
    return total, {"l_p": l_p, "l_v": l_v, "l_pen": l_pen, "loss": total}


# ---------------------------------------------------------------------------
# iAgent optimizer (tiny Adam, LR from Table II) + loss gate
# ---------------------------------------------------------------------------
def agent_opt_init(params: Mapping[str, torch.Tensor]):
    n = next(iter(params.values())).shape[0]
    dev = next(iter(params.values())).device
    zeros = lambda: {k: torch.zeros_like(v, requires_grad=False)
                     for k, v in params.items()}
    return {"m": zeros(), "v": zeros(),
            "t": torch.zeros(n, dtype=torch.int32, device=dev)}


def _rows(x, like):
    """(A,) -> broadcastable against a stacked (A, ...) leaf."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def _adam(cfg: FCPOConfig, params, grads, opt, freeze=()):
    """One Adam step per agent; leaves whose top-level key is in ``freeze``
    keep their params but still update their moments. The moment math runs
    in float32 whatever the stored dtypes (a state policy may keep params
    and moments bf16), and each result is stored back at its leaf's dtype:
    the identity under float32."""
    t = opt["t"] + 1
    b1, b2, eps = 0.9, 0.999, 1e-8
    tf = t.to(torch.float32)
    bc1, bc2 = 1 - torch.pow(b1, tf), 1 - torch.pow(b2, tf)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m0, v0 = opt["m"][k], opt["v"][k]
        m = b1 * m0.float() + (1 - b1) * g
        v = b2 * v0.float() + (1 - b2) * g * g
        mh = m / _rows(bc1, m)
        vh = v / _rows(bc2, v)
        step = cfg.lr * mh / (torch.sqrt(vh) + eps)
        new_p[k] = p if k.split(".")[0] in freeze else \
            (p.float() - step).to(p.dtype)
        new_m[k], new_v[k] = m.to(m0.dtype), v.to(v0.dtype)
    return new_p, {"m": new_m, "v": new_v, "t": t}


def _select(ok, new, old):
    """Per-agent ``where`` over a flat {name: (A, ...)} dict."""
    return {k: torch.where(_rows(ok, new[k]), new[k], old[k]) for k in new}


def _select_opt(ok, new, old):
    return {"m": _select(ok, new["m"], old["m"]),
            "v": _select(ok, new["v"], old["v"]),
            "t": torch.where(ok, new["t"], old["t"])}


def agent_update(cfg: FCPOConfig, params, opt, rollout: Rollout,
                 mask: ActionMask):
    """One CRL update with the per-agent loss gate.

    ``params`` maps names to autograd leaves (``AgentPolicy.params()``).
    Returns (new_params, new_opt, metrics) with detached (A, ...) tensors."""
    with torch.enable_grad():
        # bf16 parameters are read up to float32 inside the forward, so
        # their gradients arrive rounded to bf16, as the reference's do
        loss, metrics = fcpo_loss(cfg, params, rollout, mask)
        names = list(params)
        grads = torch.autograd.grad(loss.sum(), [params[k] for k in names])
    loss = loss.detach()
    metrics = {k: v.detach() for k, v in metrics.items()}
    old = {k: v.detach() for k, v in params.items()}
    upd_p, upd_opt = _adam(cfg, old, dict(zip(names, grads)), opt)

    gated = torch.abs(loss) < cfg.loss_gate
    new_p = _select(~gated, upd_p, old)
    new_opt = _select_opt(~gated, upd_opt, opt)
    # self-healing guard: a NaN/Inf loss or a blown-up update rejects the
    # whole step — previous params AND optimizer state are kept
    ok = torch.isfinite(loss) & finite_mask(new_p)
    new_p = _select(ok, new_p, old)
    new_opt = _select_opt(ok, new_opt, opt)
    metrics = dict(metrics, gated=gated.to(torch.float32),
                   update_rejected=(~ok).to(torch.float32))
    return new_p, new_opt, metrics


def finetune_heads(cfg: FCPOConfig, params, opt, rollout: Rollout,
                   mask: ActionMask):
    """Alg. 2 lines 6–9: after FL aggregation, fine-tune ONLY the action
    heads on local experiences with the policy loss (backbone + value head
    frozen). ``params``: {name: (A, ...)}; returns (params, opt)."""
    # the advantage term carries no parameter dependence: computed once
    adv = _normalized_adv(cfg, rollout)
    factor = -adv + torch.exp(-rollout.rewards)
    p = {k: v.detach() for k, v in params.items()}
    for _ in range(cfg.finetune_steps):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            logp, _, _ = action_logp(cfg, leaves, rollout.states,
                                     rollout.actions, mask)
            ratio = torch.exp(logp - rollout.logp_old)
            loss = (torch.minimum(cfg.eps_clip * ratio, ratio)
                    * factor).mean(-1)
            # the value head is not in the policy loss: its gradient is 0
            grads = torch.autograd.grad(loss.sum(), list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        p, opt = _adam(cfg, p, grads, opt, freeze=("backbone", "value"))
    return p, opt
