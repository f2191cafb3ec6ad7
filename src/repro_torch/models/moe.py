"""Mixture-of-Experts layer (granite top-8/40e, deepseek 64e top-6 + shared).

Port of ``repro.models.moe``. Dispatch is sort-based with a static
per-expert capacity: tokens are routed to (expert, slot) coordinates by a
stable argsort over expert ids, copied into an (E, C, d) buffer, processed
with one batched product per projection, and added back with their gate
weights. Expert tensors are stacked on a leading E axis; the transformer
hands this module one layer's (E, d, ff) slice at a time, and it casts
that slice to the activation type once per call.

The discrete decisions are the reference's: the top-k of the float32
router probabilities (sorted), the stable sort, ``searchsorted`` on the
left, the capacity-drop mask ``keep`` and the slot of every kept
assignment; an overflowing assignment goes to a spare buffer row that is
dropped (the reference's ``mode="drop"``), never clamped onto a real slot.
``moe_capacity`` is a host int from the token count of the call, so a
full forward, a prefill and each decode step drop as they do in JAX.

The combine is deterministic: every token adds its k contributions left
to right in the reference's scatter order (sorted-slot order, which is
expert id ascending within a token), rounding to the activation type
after each add, with no atomics.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (_activate, _normal, dense, dense_init,
                                       mlp, mlp_init)


def moe_init(gen, cfg: ArchConfig, dtype, lead=()):
    """Router, the stacked expert projections and the shared experts
    (``lead`` prepends stacked layer axes)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": dense_init(gen, d, e, dtype, scale=scale, lead=lead),
        "gate": _normal(gen, (*lead, e, d, f), scale, dtype),
        "up": _normal(gen, (*lead, e, d, f), scale, dtype),
        "down": _normal(gen, (*lead, e, f, d), 1.0 / math.sqrt(f), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.moe_d_ff * cfg.n_shared_experts,
                               dtype, lead=lead)
    return p


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    cap = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)  # pad to a multiple of 8


class Routing(NamedTuple):
    """The router's decisions over a flat token axis of T tokens."""
    probs: torch.Tensor      # (T, E) float32
    topw: torch.Tensor       # (T, k) renormalized gates, activation type
    topi: torch.Tensor       # (T, k) expert ids, probability descending
    order: torch.Tensor      # (T*k,) assignments sorted by expert (stable)
    keep: torch.Tensor       # (T*k,) bool, sorted order: within capacity
    slot: torch.Tensor       # (T*k,) sorted order: e*cap + position, or E*cap
    cap: int


def moe_route(p, cfg: ArchConfig, xf) -> Routing:
    """Top-k routing and the capacity-limited dispatch plan. xf: (T, d)."""
    t = xf.shape[0]
    k, e = cfg.top_k, cfg.n_experts
    logits = dense(p["router"], xf).float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1, sorted=True)
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = moe_capacity(cfg, t)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # position of each assignment within its expert's contiguous run
    seg_start = torch.searchsorted(sorted_e, sorted_e, right=False)
    pos_in_e = torch.arange(t * k, device=xf.device) - seg_start
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(pos_in_e, e * cap))
    return Routing(probs, topw.to(xf.dtype), topi, order, keep, slot, cap)


def combine(contrib, order, k):
    """The reference's ``zeros((T, d)).at[order // k].add(contrib)`` without
    atomics: ``contrib`` (T*k, d) in sorted-slot order; every token adds its
    k rows left to right in that order, rounding to contrib's type after
    each add."""
    n = order.shape[0]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device)
    pos = rank.reshape(n // k, k).sort(dim=1).values
    y = contrib[pos[:, 0]]
    for j in range(1, k):
        y = y + contrib[pos[:, j]]
    return y


def _moe_tokens(p, cfg: ArchConfig, xf, w):
    """Dispatch / compute / combine over a flat token axis. xf: (T, d);
    ``w``: the (gate, up, down) expert stacks in xf's type."""
    t, d = xf.shape
    k, e = cfg.top_k, cfg.n_experts
    r = moe_route(p, cfg, xf)
    cap = r.cap
    token_of = r.order // k

    # one spare row takes every overflowing assignment and is dropped
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf[r.slot] = xf[token_of]
    buf = buf[:e * cap].view(e, cap, d)

    gate, up, down = w
    h = _activate(torch.bmm(buf, gate), cfg.act) * torch.bmm(buf, up)
    out = torch.bmm(h, down).reshape(e * cap, d)

    gathered = out[r.slot.clamp(max=e * cap - 1)]
    gathered = torch.where(r.keep[:, None], gathered,
                           torch.zeros((), dtype=xf.dtype, device=xf.device))
    y = combine(gathered * r.topw.reshape(-1)[r.order][:, None], r.order, k)

    # Switch-style load-balance auxiliary loss
    me = r.probs.mean(0)                                        # (E,)
    ce = torch.bincount(r.topi.reshape(-1), minlength=e).float() / (t * k)
    aux = e * torch.sum(me * ce)
    return y, aux


def moe_apply(p, cfg: ArchConfig, x):
    """x: (B, S, d) -> (y (B, S, d), the load-balance aux loss).

    ``moe_impl="batched"`` dispatches each batch row on its own (capacity
    per row, the aux loss averaged over rows), as the reference's vmap."""
    b, s, d = x.shape
    w = tuple(p[n].to(x.dtype) for n in ("gate", "up", "down"))
    if cfg.moe_impl == "batched" and b > 1:
        rows = [_moe_tokens(p, cfg, x[i], w) for i in range(b)]
        y = torch.stack([row[0] for row in rows])
        aux = torch.stack([row[1] for row in rows]).mean()
        if cfg.n_shared_experts:
            y = y + mlp(p["shared"], x, cfg.act)
        return y, aux
    y, aux = _moe_tokens(p, cfg, x.reshape(b * s, d), w)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x.reshape(b * s, d), cfg.act)
    return y.reshape(b, s, d), aux
