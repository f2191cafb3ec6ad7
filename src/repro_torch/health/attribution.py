"""FL contribution attribution: who moved the aggregate, and should we
trust them.

Port of ``repro.health.attribution``. Each selected client's delta is
scored against a robust reference direction built from norm-downweighted
deltas (the squared clip of ``robust_reference_weights``: a sign-flipped
delta at 25x re-enters the reference with vanishing mass instead of at
full honest scale), and the scores blend into a per-agent ``suspicion``
in [0, 1]:

* ``cos_i`` — cosine of d_i to the reference r;
* ``cos_loo_i`` — cosine of d_i to the leave-one-out reference
  r - w_i d_i, in closed form from the same dot products;
* ``norm_term_i`` — ``log(r)+ / (1 + log(r)+)`` of the norm ratio to the
  lower median.

One pass of per-leaf reductions: no (A, A) matrix, no per-client rebuild.
The sums run over the 12 leaves in the reference's (sorted) order; within
a leaf PyTorch sums in its own order, so scores agree to float32
roundoff.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.sharding import agent_allgather, agent_allreduce

_EPS = 1e-12

# evidence blend: leave-one-out alignment discriminates best, raw alignment
# confirms it, the norm term catches magnitude attacks pointing the right
# way
W_COS_LOO = 0.45
W_COS = 0.25
W_NORM = 0.30


def _masked_lower_median(x: torch.Tensor, mask: torch.Tensor
                         ) -> torch.Tensor:
    """The order statistic at rank (n-1)//2 over the masked entries (+inf
    padding sorts the others last), 0 for an empty mask. Not the
    interpolated median of ``guards``: at even counts its upper middle may
    be an attacker, while the lower one stays honest for up to half of
    the selected set inflated. The rank is read with ``gather`` at a
    device index (no host sync)."""
    n = mask.sum()
    srt = torch.sort(torch.where(mask, x, torch.inf)).values
    med = srt.gather(0, torch.clamp_min(
        torch.div(n - 1, 2, rounding_mode="floor"), 0).view(1))[0]
    return torch.where(n > 0, med, 0.0)


def _leaves(deltas: Dict[str, torch.Tensor]):
    """The leaves as float32 (A, -1) rows, in sorted key order (the order
    of ``jax.tree.leaves`` over a dict)."""
    return [deltas[k].float().reshape(deltas[k].shape[0], -1)
            for k in sorted(deltas)]


def _fleet_median(norms, sel, place):
    """The lower median norm of the selected clients of every rank."""
    return _masked_lower_median(agent_allgather(norms, place),
                                agent_allgather(sel.bool(), place))


def robust_reference_weights(norms: torch.Tensor, sel: torch.Tensor,
                             place=None) -> torch.Tensor:
    """Squared norm-clip weights: ``sel_i * min(1, (med / norm_i)^2)`` with
    ``med`` the lower median norm of the selected clients (of every rank's
    agents under a meshed fleet's placement ``place``)."""
    med = _fleet_median(norms, sel, place)
    ratio = med / torch.clamp_min(norms, _EPS)
    return sel.to(torch.float32) * torch.clamp_max(ratio * ratio, 1.0)


def attribution_scores(deltas: Dict[str, torch.Tensor],
                       sel: torch.Tensor, place=None
                       ) -> Dict[str, torch.Tensor]:
    """``deltas``: {name: (A, ...)} wire deltas; ``sel``: (A,) selection
    mask. Returns (A,) ``norm``, ``cos``, ``cos_loo`` and ``susp``
    (unselected clients score 0 suspicion). ``place``: a meshed fleet's
    placement (the arguments this rank's agents): the reference direction
    r is all-reduced from the ranks' partial sums, the medians read the
    all-gathered norms, and the leave-one-out terms follow from r and
    |r|² per agent."""
    leaves = _leaves(deltas)
    sq = sum((f * f).sum(1) for f in leaves)
    norms = torch.sqrt(sq)
    w = robust_reference_weights(norms, sel, place)

    # r = sum_i w_i d_i and dot_i = <d_i, r>, accumulated leaf by leaf
    dot = torch.zeros_like(sq)
    ref_sq = torch.zeros((), dtype=torch.float32, device=sq.device)
    for f in leaves:
        r = agent_allreduce(w @ f, place)
        ref_sq = ref_sq + (r * r).sum()
        dot = dot + (f * r).sum(1)

    cos = dot / torch.clamp_min(norms * torch.sqrt(ref_sq), _EPS)
    # leave-one-out in closed form: r_-i = r - w_i d_i
    dot_loo = dot - w * sq
    loo_sq = torch.clamp_min(ref_sq - 2.0 * w * dot + w * w * sq, 0.0)
    cos_loo = dot_loo / torch.clamp_min(norms * torch.sqrt(loo_sq), _EPS)

    med = _fleet_median(norms, sel, place)
    log_r = torch.clamp_min(torch.log(torch.clamp_min(norms, _EPS)
                                      / torch.clamp_min(med, _EPS)), 0.0)
    norm_term = log_r / (1.0 + log_r)

    susp = (W_COS_LOO * (1.0 - torch.clamp(cos_loo, -1.0, 1.0)) / 2.0
            + W_COS * (1.0 - torch.clamp(cos, -1.0, 1.0)) / 2.0
            + W_NORM * norm_term)
    susp = torch.clamp(susp, 0.0, 1.0) * sel.to(torch.float32)
    return {"norm": norms, "cos": cos, "cos_loo": cos_loo, "susp": susp}
