"""Self-healing defenses for Algorithm 1.

Port of ``repro.resilience.guards``. ``GuardConfig`` is a frozen dataclass
threaded through ``fl_round`` and the fleet drivers:

* ``agg`` — the Algorithm 1 statistic: ``"mean"`` is the paper's masked
  segment mean; ``"trimmed"`` / ``"median"`` are coordinate-wise robust
  statistics over {selected clients} ∪ {base network}.
* ``clip_factor`` — per-leaf L2 norm clip of client deltas at
  ``clip_factor ×`` the selected clients' median leaf norm (0 disables).
* ``reject_nonfinite`` — drop contributions holding a NaN or Inf from the
  aggregation mask before they touch any pod member (on by default; the
  identity on a healthy round).
* ``susp_threshold`` — with the health observatory on, clients whose
  attribution suspicion EMA from the previous round exceeds the threshold
  leave the Eq. 7 candidate pool before the top-k (``fl_round``;
  ``suspicion_gate`` is the same rule on a finished selection). 0
  disables; attribution then still scores the clients without acting.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.distributed.sharding import agent_allgather, agent_allreduce

AGG_METHODS = ("mean", "trimmed", "median")


@dataclass(frozen=True)
class GuardConfig:
    agg: str = "mean"
    trim_frac: float = 0.2
    clip_factor: float = 0.0
    reject_nonfinite: bool = True
    susp_threshold: float = 0.0

    def __post_init__(self):
        if self.agg not in AGG_METHODS:
            raise ValueError(f"unknown agg {self.agg!r}; expected one of "
                             f"{AGG_METHODS}")
        if not (0.0 <= self.trim_frac < 0.5):
            raise ValueError("trim_frac must be in [0, 0.5)")
        if self.clip_factor < 0.0:
            raise ValueError("clip_factor must be >= 0")
        if not (0.0 <= self.susp_threshold <= 1.0):
            raise ValueError("susp_threshold must be in [0, 1]")


DEFAULT_GUARDS = GuardConfig()


def finite_mask(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(A,) bool — True where every leaf of agent i is entirely finite."""
    ok = None
    for leaf in tree.values():
        f = torch.isfinite(leaf).flatten(1).all(1)
        ok = f if ok is None else ok & f
    return ok


def _masked_median_1d(x, mask):
    """Median of ``x[mask]`` as a 0-dim tensor; +inf for an empty mask.
    The ranks are read by ``gather`` at device indices (no host sync)."""
    n = mask.sum()
    srt = torch.sort(torch.where(mask, x, torch.inf), stable=True).values
    lo = srt.gather(0, torch.clamp_min(
        torch.div(n - 1, 2, rounding_mode="floor"), 0).view(1))
    hi = srt.gather(0, torch.div(n, 2, rounding_mode="floor").view(1))
    return (0.5 * (lo + hi))[0]


def suspicion_gate(sel, suspicion, threshold: float):
    """Drop clients whose suspicion exceeds ``threshold`` from the
    selection mask. Returns ``(gated_sel, n_gated)``. The suspicion is the
    previous round's EMA (this round's scores exist only after
    aggregation), so the gate reacts one round late by construction."""
    hit = sel & (suspicion > threshold)
    return sel & ~hit, hit.sum().to(torch.float32)


def clip_deltas(contrib: Dict[str, torch.Tensor], sel, clip_factor: float,
                place=None):
    """Per-leaf L2 norm clip at ``clip_factor ×`` the selected clients'
    median norm of that leaf. Returns ``(clipped, n_clipped)``, the count
    of agents with at least one clipped leaf. Unselected agents are never
    scaled. ``place``: a meshed fleet's placement; the median is over
    every rank's agents (the norms all-gathered), the count a world
    sum."""
    any_clip = torch.zeros_like(sel)
    out = {}
    for k, d in contrib.items():
        flat = d.reshape(d.shape[0], -1)
        nrm = torch.sqrt((flat * flat).sum(1))
        lim = clip_factor * _masked_median_1d(agent_allgather(nrm, place),
                                              agent_allgather(sel, place))
        hit = sel & (nrm > lim)
        scale = torch.where(hit, lim / torch.clamp_min(nrm, 1e-12), 1.0)
        out[k] = d * scale.reshape((-1,) + (1,) * (d.dim() - 1))
        any_clip = any_clip | hit
    return out, agent_allreduce(any_clip.sum().to(torch.float32), place)
