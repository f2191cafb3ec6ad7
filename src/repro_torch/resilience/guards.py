"""The defense of the default FL round.

Port of the part of ``repro.resilience.guards`` that the default round
uses (``GuardConfig()``: mean aggregation, ``reject_nonfinite=True``): a
contribution holding a NaN or Inf is dropped from the aggregation mask
before it touches any pod member. In this slice that rejection is always
on and Algorithm 1 always aggregates by the mean; robust aggregation, delta
clipping and the suspicion gate are a later slice.
"""
from __future__ import annotations

from typing import Dict

import torch


def finite_mask(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(A,) bool — True where every leaf of agent i is entirely finite."""
    ok = None
    for leaf in tree.values():
        f = torch.isfinite(leaf).flatten(1).all(1)
        ok = f if ok is None else ok & f
    return ok
