"""Staleness-tolerant (async-FL) round semantics.

Port of ``repro.fl.staleness``. With a round deadline and *async* rounds, a
selected client that misses the deadline **parks** its decoded delta in a
server-side buffer (``fleet.pending``) and joins a later round with the
weight ``staleness_decay ** staleness``: the discounted delta enters
Algorithm 1 as the contribution ``base + w · delta``.

Bookkeeping per round (all masks (A,) bool, computed on the device):

* ``fresh_sent`` — selected, available AND on time: its fresh delta
  crossed the wire and supersedes any delta it had parked.
* ``parked`` — selected, available, missed the deadline: its decoded delta
  (error feedback already applied) is parked with staleness 1.
* ``consumed`` — selected with a parked delta and no fresh arrival: the
  parked delta is used, discounted, and cleared.
* otherwise a parked delta ages: staleness += 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.distributed.sharding import agent_allreduce
from repro_torch.resilience.guards import finite_mask


@dataclass
class PendingDeltas:
    """Server-side parked uploads, stacked over the agent axis."""
    delta: Dict[str, torch.Tensor]   # like params, (A, ...) decoded deltas
    staleness: torch.Tensor          # (A,) int32 — rounds the delta waited
    has: torch.Tensor                # (A,) bool — a delta is parked


def pending_init(params: Dict[str, torch.Tensor]) -> PendingDeltas:
    a = next(iter(params.values())).shape[0]
    dev = next(iter(params.values())).device
    return PendingDeltas(
        delta={k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for k, p in params.items()},
        staleness=torch.zeros(a, dtype=torch.int32, device=dev),
        has=torch.zeros(a, dtype=torch.bool, device=dev))


def _rows(m, leaf):
    return m.reshape((-1,) + (1,) * (leaf.dim() - 1))


def validate_pending(pending: PendingDeltas, place=None):
    """Drop parked deltas holding a NaN or Inf before anything reads them.
    Returns ``(pending, n_dropped)``; the identity on a healthy buffer.
    ``place``: a meshed fleet's placement; the count is a world sum."""
    ok = finite_mask(pending.delta)
    dropped = pending.has & ~ok
    return (PendingDeltas(pending.delta, pending.staleness, pending.has & ok),
            agent_allreduce(dropped.sum().to(torch.float32), place))


def stale_weights(pending: PendingDeltas, decay: float) -> torch.Tensor:
    """(A,) discount of a parked delta when it is consumed."""
    base = torch.full(pending.staleness.shape, decay, dtype=torch.float32,
                      device=pending.staleness.device)
    return torch.pow(base, pending.staleness.to(torch.float32))


def merge_contributions(decoded, pending: PendingDeltas, fresh_ok, w_stale):
    """Per-agent contribution: the fresh decoded delta where it arrived,
    else the discounted parked delta."""
    return {k: torch.where(_rows(fresh_ok, d), d,
                           _rows(w_stale, d) * pending.delta[k])
            for k, d in decoded.items()}


def update_pending(pending: PendingDeltas, decoded, parked, consumed,
                   fresh_sent) -> PendingDeltas:
    """The buffer after one round (see the module docstring). The float32
    decoded deltas are parked at the buffer's stored dtype."""
    kept = pending.has & ~consumed & ~fresh_sent
    return PendingDeltas(
        delta={k: torch.where(_rows(parked, p), decoded[k].to(p.dtype), p)
               for k, p in pending.delta.items()},
        staleness=torch.where(parked, 1, torch.where(
            kept, pending.staleness + 1, 0)).to(torch.int32),
        has=parked | kept)
