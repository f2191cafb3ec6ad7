"""Agent-specific Federated RL (§IV-D): Algorithm 1, Eq. 7 selection,
hierarchical rounds — over the stacked fleet's parameters.

Port of ``repro.core.federated``:
  * backbone + value head: equal aggregation over the selected clients AND
    the pod's base network, divided by |M|+1;
  * action heads: aggregated within (pod × action-space group) segments,
    weighted by ``exp(−(loss_i − mean loss))`` renormalised to the group
    count; a group with no contributor keeps each agent's own head;
  * the robust statistics (``method="trimmed"`` / ``"median"``) replace
    every segment mean by a coordinate-wise statistic over {selected
    clients} ∪ {base network}, the heads without the loss weighting;
  * Eq. 7: ``TotalUtil = Util · sqrt(Bandwidth/10)``, top-⌈frac·A⌉ among
    the available clients (stable order: ties go to the lower index);
  * the pod merge, optionally over the pods a partition leaves active.

The segment sums are ``index_add_`` (they sum in another order than
``jax.ops.segment_sum``, so results agree to float32 roundoff; so does the
trimmed mean's sum, while the median is bit for bit). On a device mesh
(``place``, a ``core.fleet.Placement``) each rank holds a slice of the
agents: the segment sums are its partial sums, all-reduced over the ranks
(``distributed.sharding.agent_allreduce``), and the selection and the
robust statistics all-gather what they rank. The robust ranks
are read with ``gather`` at device indices (no host sync). An agent
outside the selection enters every sum through a ``where``, not a multiply
by zero, so a rejected non-finite contribution cannot reach any pod member
(``NaN * 0`` is NaN). The host-side schedule helpers are numpy copies of
the reference and draw the same streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.agent import (BACKBONE_KEYS, HEAD_KEYS, ActionMask,
                                    agent_forward)
from repro_torch.core.ppo import Rollout, _normalized_adv
from repro_torch.distributed.sharding import (agent_allgather,
                                              agent_allreduce, agent_slice)


def per_head_losses(cfg: FCPOConfig, params, rollout: Rollout,
                    mask: ActionMask) -> torch.Tensor:
    """(A, 3) policy loss per action head on each agent's experiences."""
    out = agent_forward(cfg, params, rollout.states, mask)
    factor = -_normalized_adv(cfg, rollout) + torch.exp(-rollout.rewards)
    losses = []
    for i, head in enumerate(("res", "bs", "mt")):
        logp = torch.gather(out[head], -1,
                            rollout.actions[..., i:i + 1].long())[..., 0]
        ratio = torch.exp(logp - logp.detach())  # = 1 at the evaluation point
        losses.append((torch.minimum(cfg.eps_clip * ratio, ratio)
                       * factor).mean(-1))
    return torch.stack(losses, dim=-1)


@dataclass
class ClientStats:
    mem_avail: torch.Tensor      # (A,) in [0,1]
    compute_avail: torch.Tensor  # (A,) in [0,1]
    diversity: torch.Tensor      # (A,) mean buffer diversity score
    bandwidth: torch.Tensor      # (A,) Mbit/s
    available: torch.Tensor      # (A,) bool — False = straggler/offline


def total_utility(stats: ClientStats) -> torch.Tensor:
    div = stats.diversity / (1.0 + torch.abs(stats.diversity))  # squash
    util = (stats.mem_avail + stats.compute_avail + div) / 3.0
    return util * torch.sqrt(torch.clamp_min(stats.bandwidth, 1e-3) / 10.0)


def select_clients(cfg: FCPOConfig, stats: ClientStats, suspicion=None,
                   susp_threshold: float = 0.0, place=None) -> torch.Tensor:
    """Top-⌈frac·A⌉ by TotalUtil among available clients -> (A,) bool.
    ``suspicion`` ((A,) in [0, 1], the health observatory's EMA from the
    previous round) with ``susp_threshold`` > 0 takes the suspects out of
    the pool before the top-k, so that an excluded client frees its slot
    for the next candidate instead of shrinking the round. ``place``: a
    meshed fleet's placement: the utilities of every rank's agents are
    all-gathered, every rank ranks the whole fleet the same way, and the
    result is this rank's slice of the global selection."""
    available = stats.available
    if suspicion is not None and susp_threshold > 0.0:
        available = available & (suspicion <= susp_threshold)
    utils = agent_allgather(torch.where(available, total_utility(stats),
                                        -torch.inf), place)
    a = utils.shape[0]
    k = max(1, int(round(cfg.clients_per_round * a)))
    order = torch.argsort(-utils, stable=True)
    # index_fill_ keeps the value on the host side of the launch (an
    # indexed assignment would copy it to the device: no CUDA graph capture)
    sel = torch.zeros(a, dtype=torch.bool, device=utils.device).index_fill_(
        0, order[:k], True)
    return agent_slice(sel, place) & available


def _segment_sum(x, seg, n):
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg, x)


def _rows(w, like):
    return w.reshape((-1,) + (1,) * (like.dim() - 1))


def _masked_mean_with_base(stacked, base, sel, pod_ids, n_pods, place=None):
    """(base + Σ_sel m) / (n_sel + 1) per pod. Returns (per-agent (A, ...),
    new base (P, ...)); on a mesh the per-pod sums are this rank's partial
    sums, all-reduced."""
    wsum = agent_allreduce(_segment_sum(sel.to(stacked.dtype), pod_ids,
                                        n_pods), place)
    ssum = agent_allreduce(_segment_sum(
        torch.where(_rows(sel, stacked), stacked, 0.0), pod_ids, n_pods),
        place)
    agg = (base + ssum) / _rows(wsum + 1.0, base)
    return agg[pod_ids], agg


AGG_METHODS = ("mean", "trimmed", "median")


def _gather_rank(srt, rank):
    """srt: (S, M, ...) sorted along dim 1; rank: (S,) long. The rank-th
    entry of each segment row, (S, ...)."""
    idx = rank.reshape((rank.shape[0], 1) + (1,) * (srt.dim() - 2))
    idx = idx.expand((rank.shape[0], 1) + tuple(srt.shape[2:]))
    return srt.gather(1, idx)[:, 0]


def _robust_stat(vals, valid, method: str, trim_frac: float):
    """Coordinate-wise robust statistic over each segment row. vals:
    (S, M, ...) candidates; valid: (S, M) bool, at least one per row.
    Invalid entries sort to +inf, so ranks [0, n) are the valid ones.
    ``median`` averages the middle pair; ``trimmed`` is the mean of ranks
    [t, n − t) with t = floor(trim_frac · n)."""
    vb = valid.reshape(valid.shape + (1,) * (vals.dim() - 2))
    srt = torch.sort(torch.where(vb, vals, torch.inf), dim=1,
                     stable=True).values
    n = valid.sum(1)
    if method == "median":
        lo = _gather_rank(srt, torch.clamp_min(
            torch.div(n - 1, 2, rounding_mode="floor"), 0))
        hi = _gather_rank(srt, torch.div(n, 2, rounding_mode="floor"))
        return 0.5 * (lo + hi)
    if method == "trimmed":
        t = torch.floor(n.to(torch.float32) * trim_frac).long()
        ranks = torch.arange(vals.shape[1], device=vals.device)
        inc = (ranks[None, :] >= t[:, None]) & \
            (ranks[None, :] < (n - t)[:, None])
        incb = inc.reshape(inc.shape + (1,) * (vals.dim() - 2))
        kept = torch.clamp_min(n - 2 * t, 1).to(vals.dtype)
        denom = kept.reshape((n.shape[0],) + (1,) * (vals.dim() - 2))
        return torch.where(incb, srt, 0.0).sum(1) / denom
    raise ValueError(f"unknown robust method {method!r}")


def _with_base(stacked, b_seg, valid):
    """The candidates of ``_robust_stat``: every agent's entry for each of
    the S segments, then the segment's base; ``valid`` (S, A) gains the
    base's always-valid column."""
    s = b_seg.shape[0]
    vals = torch.cat([stacked[None].expand((s,) + tuple(stacked.shape)),
                      b_seg[:, None]], dim=1)
    ones = torch.ones((s, 1), dtype=torch.bool, device=valid.device)
    return vals, torch.cat([valid, ones], dim=1)


def _robust_masked_with_base(stacked, base, sel, pod_ids, n_pods,
                             method: str, trim_frac: float):
    """The robust counterpart of ``_masked_mean_with_base``: the per-pod
    statistic over {selected clients of the pod} ∪ {the pod's base}, (P,
    ...). Every agent's row enters: on a mesh, the gathered whole fleet's."""
    pods = torch.arange(n_pods, device=sel.device)
    valid = sel[None, :] & (pod_ids[None, :] == pods[:, None])
    return _robust_stat(*_with_base(stacked, base, valid), method, trim_frac)


def _head_weights(sel, losses_h, group_ids, n_groups, place=None):
    """Loss-centered exponential weights, renormalized within a segment
    (its sums over every rank's agents on a mesh)."""
    cnt = agent_allreduce(_segment_sum(sel.to(torch.float32), group_ids,
                                       n_groups), place)
    lsum = agent_allreduce(_segment_sum(torch.where(sel, losses_h, 0.0),
                                        group_ids, n_groups), place)
    mean_l = lsum / torch.clamp_min(cnt, 1.0)
    raw = torch.where(sel, torch.exp(-(losses_h - mean_l[group_ids])), 0.0)
    rsum = agent_allreduce(_segment_sum(raw, group_ids, n_groups), place)
    return raw * (cnt / torch.clamp_min(rsum, 1e-9))[group_ids]


def aggregate(cfg: FCPOConfig, fleet_params: Dict[str, torch.Tensor],
              base_params: Dict[str, torch.Tensor], sel: torch.Tensor,
              head_losses: torch.Tensor, head_groups: Dict[str, torch.Tensor],
              group_counts: Dict[str, int], pod_ids: torch.Tensor,
              n_pods: int, method: str = "mean", trim_frac: float = 0.2,
              place=None) -> Tuple[Dict, Dict]:
    """Algorithm 1. fleet_params {name: (A, ...)}, base_params
    {name: (P, ...)}, sel (A,) bool, head_losses (A, 3), head_groups
    {head: (A,) group ids} with ``group_counts`` {head: n groups}.
    ``method``: ``"mean"`` (the paper's), or ``"trimmed"`` / ``"median"``,
    the robust statistics, which also drop the heads' loss weighting.
    ``place``: a meshed fleet's placement. The agent-leading arguments are
    then this rank's agents and ``base_params`` the whole (P, ...) base
    networks: the segment sums are partial sums, all-reduced over the
    ranks; the robust statistics need every value of a segment and
    all-gather the rows. Returns (new_fleet_params for the agents given,
    the whole new_base_params)."""
    if method not in AGG_METHODS:
        raise ValueError(f"unknown aggregation method {method!r}; expected "
                         f"one of {AGG_METHODS}")
    robust = method != "mean"
    whole = lambda x: agent_allgather(x, place)
    if robust:
        sel_all, pods_all = whole(sel), whole(pod_ids)
    new_fleet, new_base = {}, {}
    for name, st in fleet_params.items():
        top = name.split(".")[0]
        b = base_params[name]
        if top in BACKBONE_KEYS:
            if robust:
                agg = _robust_masked_with_base(whole(st), b, sel_all,
                                               pods_all, n_pods, method,
                                               trim_frac)
                new_fleet[name], new_base[name] = agg[pod_ids], agg
            else:
                new_fleet[name], new_base[name] = _masked_mean_with_base(
                    st, b, sel, pod_ids, n_pods, place)
            continue
        h_idx = HEAD_KEYS.index(top)
        n_g = group_counts[top]
        seg = pod_ids * n_g + head_groups[top]     # pod×group segments
        n_seg = n_pods * n_g
        cnt = agent_allreduce(_segment_sum(sel.to(torch.float32), seg,
                                           n_seg), place)
        b_seg = torch.repeat_interleave(b, n_g, dim=0)
        if robust:
            segs = torch.arange(n_seg, device=seg.device)
            valid = sel_all[None, :] & (whole(seg)[None, :] == segs[:, None])
            agg = _robust_stat(*_with_base(whole(st), b_seg, valid), method,
                               trim_frac)
        else:
            wts = _head_weights(sel, head_losses[:, h_idx], seg, n_seg,
                                place)
            ssum = agent_allreduce(_segment_sum(
                torch.where(_rows(sel, st), st * _rows(wts, st), 0.0),
                seg, n_seg), place)
            agg = (b_seg + ssum) / _rows(cnt + 1.0, b_seg)   # (n_seg, ...)
        # groups with no contributor keep the agent's own head
        has = _rows(cnt[seg] > 0, st)
        new_fleet[name] = torch.where(has, agg[seg], st)
        new_base[name] = agg.reshape((n_pods, n_g) + tuple(st.shape[1:])
                                     ).mean(1)
    return new_fleet, new_base


def merge_pods(base_params: Dict[str, torch.Tensor], active=None):
    """Hierarchical FL (§IV-D Large-Scale): the pods' base networks are
    averaged and redistributed. ``active`` ((P,) bool) models a network
    partition: only active pods contribute to and receive the average; a
    partitioned pod keeps its own base network. The mean runs in float32
    and is stored at the base networks' dtype."""
    if active is None:
        return {k: b.float().mean(0, keepdim=True).expand_as(b)
                .to(b.dtype).clone() for k, b in base_params.items()}
    n_act = torch.clamp_min(active.sum(), 1).to(torch.float32)
    out = {}
    for k, b in base_params.items():
        w = _rows(active, b)
        b32 = b.float()
        m = torch.where(w, b32, 0.0).sum(0, keepdim=True) / n_act
        out[k] = torch.where(w, m.expand_as(b), b32).to(b.dtype)
    return out


# ---------------------------------------------------------------------------
# FL cadence — host-side numpy, the same streams as the reference
# ---------------------------------------------------------------------------
def fl_schedule(cfg: FCPOConfig, n_episodes: int, *, federated: bool = True,
                learn: bool = True):
    """(n_episodes,) bool: True where an FL round runs after the episode."""
    if not (federated and learn):
        return np.zeros((n_episodes,), bool)
    if cfg.fl_every < 1:
        raise ValueError(f"fl_every must be >= 1, got {cfg.fl_every}")
    return (np.arange(1, n_episodes + 1) % cfg.fl_every) == 0


def draw_availability(schedule, n_agents: int, straggler_prob: float = 0.0,
                      seed: int = 0):
    """(n_episodes, A) bool availability bits: one ``rng.random(A)`` per
    scheduled FL round, in episode order."""
    rng = np.random.default_rng(seed)
    avail = np.ones((len(schedule), n_agents), bool)
    for e in np.flatnonzero(schedule):
        avail[e] = rng.random(n_agents) >= straggler_prob
    return avail


def head_group_ids(masks: ActionMask, device) -> Tuple[Dict, Dict]:
    """Group agents by identical action-space masks, per head. Returns
    ({head: (A,) long group ids}, {head: number of groups})."""
    ids, counts = {}, {}
    for key, m in zip(HEAD_KEYS, (masks.res, masks.bs, masks.mt)):
        uniq, inv = np.unique(m.cpu().numpy(), axis=0, return_inverse=True)
        ids[key] = torch.as_tensor(inv.reshape(-1).astype(np.int64),
                                   device=device)
        counts[key] = int(uniq.shape[0])
    return ids, counts
