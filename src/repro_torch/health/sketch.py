"""Telemetry sketches: fixed-size streaming summaries of per-interval signals.

Port of ``repro.health.sketch``. Each function works on tensors with any
leading batch shape (the fleet's agent axis takes the place of ``vmap``):

* **Fixed-bin histograms** (``hist_*``) over signals with a known range —
  reward is ``tanh``-bounded in (-1, 1), the SLO-miss rate lives in
  [0, 1]. Quantile queries invert the CDF with in-bin interpolation; the
  estimate lies within one bin width of the exact inverted-CDF empirical
  quantile.
* **P² marker sketches** (``p2_*``) — Jain & Chlamtac's five-marker
  streaming quantile estimator with the parabolic update and the linear
  fallback; O(1) state.

Both are branchless (``torch.where``; no data-dependent control flow), so
they run inside the captured episode graph. The arithmetic is the JAX
package's compiled program, not its source: XLA turns a division by a
constant into a product by the float32 reciprocal, folds chained constant
factors into one, and fuses ``a * b + c`` into one rounding. A bin index
and a quantile read off the bins are computed that way here
(``_bin_scale``, ``fma``), so that bin counts are the reference's exactly
at any bin count.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device


def fma(x, y, z):
    """float32 ``x * y + z`` rounded once, as XLA's fused multiply-add: the
    float64 product of two float32 values is exact, then the sum is rounded
    to float64 and to float32 (the fused result but for a double rounding
    at an exact float32 midpoint)."""
    f64 = lambda v: v.double() if torch.is_tensor(v) else v
    return (f64(x) * f64(y) + f64(z)).to(torch.float32)


def _bin_scale(lo: float, hi: float, bins: int) -> float:
    """``/ (hi - lo) * bins`` as XLA folds it: the float32 reciprocal of
    the range times ``bins``, rounded to float32."""
    return float(np.float32(np.float32(1.0 / (hi - lo)) * np.float32(bins)))


# ---------------------------------------------------------------------------
# Fixed-bin histogram sketch
# ---------------------------------------------------------------------------
def hist_init(bins: int, batch=(), device="cuda") -> torch.Tensor:
    """All-empty (*batch, bins) float32 count vector."""
    return torch.zeros((*batch, bins), dtype=torch.float32,
                       device=resolve_device(device))


def bin_index(x: torch.Tensor, lo: float, hi: float, bins: int):
    """The (long) bin of each value; out-of-range values clamp to the edge
    bins, so the total count stays exact."""
    i = ((x - lo) * _bin_scale(lo, hi, bins)).to(torch.int32)
    return torch.clamp(i, 0, bins - 1).long()


def hist_update(counts: torch.Tensor, x, lo: float, hi: float
                ) -> torch.Tensor:
    """Rank-1 update: one observation per batch row into its bin."""
    i = bin_index(torch.as_tensor(x, dtype=torch.float32,
                                  device=counts.device), lo, hi,
                  counts.shape[-1])
    return counts.scatter_add(-1, i[..., None],
                              torch.ones_like(counts[..., :1]))


def hist_update_batch(counts: torch.Tensor, xs: torch.Tensor, lo: float,
                      hi: float) -> torch.Tensor:
    """Whole-episode update: (*batch, T) observations in one scatter-add
    (counts commute, so T ``hist_update`` calls give the same counts)."""
    i = bin_index(xs, lo, hi, counts.shape[-1])
    return counts.scatter_add(-1, i, torch.ones_like(xs, dtype=counts.dtype))


def hist_quantile(counts: torch.Tensor, p: float, lo: float, hi: float
                  ) -> torch.Tensor:
    """Inverted-CDF quantile with in-bin linear interpolation, per batch
    row; ``lo`` on an empty sketch."""
    b = counts.shape[-1]
    c = torch.cumsum(counts, -1)
    target = p * c[..., -1:]
    i = torch.clamp((c < target).sum(-1, keepdim=True), 0, b - 1)
    prev = torch.where(i > 0, c.gather(-1, torch.clamp_min(i - 1, 0)), 0.0)
    frac = torch.clamp((target - prev) / torch.clamp_min(
        counts.gather(-1, i), 1e-9), 0.0, 1.0)
    step = float(np.float32(np.float32(hi - lo) * np.float32(1.0 / b)))
    return fma(i.to(torch.float32) + frac, step, lo)[..., 0]


def hist_merge(stacked_counts: torch.Tensor) -> torch.Tensor:
    """Per-agent sketches (A, bins) merged into one fleet sketch (bins,):
    histograms over a shared range merge by addition."""
    return stacked_counts.sum(0)


# ---------------------------------------------------------------------------
# P² streaming quantile sketch (Jain & Chlamtac 1985)
# ---------------------------------------------------------------------------
@dataclass
class P2State:
    """Five-marker P² state, batched: ``q`` marker heights, ``n`` actual
    and ``npos`` desired marker positions ((*batch, 5) each), ``count``
    observations seen ((*batch,)). Heights start at +inf so that the
    warm-up sort keeps the empty slots at the top."""
    q: torch.Tensor
    n: torch.Tensor
    npos: torch.Tensor
    count: torch.Tensor


def p2_init(p: float, batch=(), device="cuda") -> P2State:
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    row = lambda v: torch.tensor(v, **f32).expand(*batch, 5).clone()
    return P2State(q=torch.full((*batch, 5), torch.inf, **f32),
                   n=row([0.0, 1.0, 2.0, 3.0, 4.0]),
                   npos=row(np.float32([0.0, 2 * p, 4 * p, 2 + 2 * p,
                                        4.0]).tolist()),
                   count=torch.zeros(batch, **f32))


def _safe_div(a, b):
    return a / torch.where(b == 0, 1.0, b)


def p2_update(s: P2State, x, p: float) -> P2State:
    """One observation per batch row, branchless. Warm-up (count < 5):
    insert and sort (the +inf fill keeps the unfilled slots above every
    real value). After: the P² step — locate the cell, shift the marker
    positions, move the interior markers by the parabolic formula with the
    linear fallback. The steady branch runs on the warm-up's +inf heights
    too (``inf - inf``); ``where`` discards it, as in the reference."""
    x = torch.as_tensor(x, dtype=torch.float32, device=s.q.device)
    c = s.count
    in_warm = c < 5.0

    slot = torch.clamp_max(c, 4.0).to(torch.int64)
    q_warm = torch.sort(s.q.scatter(-1, slot[..., None], x[..., None]),
                        -1).values

    q = list(s.q.unbind(-1))
    q[0] = torch.minimum(q[0], x)
    q[4] = torch.maximum(q[4], x)
    k = torch.clamp(sum((x >= qj).to(torch.int32) for qj in q) - 1, 0, 3)
    n = [s.n[..., j] + (k < j).to(torch.float32) for j in range(5)]
    inc = np.float32([0.0, p / 2, p, (1 + p) / 2, 1.0]).tolist()
    npos = [s.npos[..., j] + inc[j] for j in range(5)]
    for i in (1, 2, 3):
        d = npos[i] - n[i]
        up = (d >= 1.0) & (n[i + 1] - n[i] > 1.0)
        dn = (d <= -1.0) & (n[i - 1] - n[i] < -1.0)
        ds = torch.where(up, 1.0, torch.where(dn, -1.0, 0.0))
        qp = q[i] + _safe_div(ds, n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + ds) * _safe_div(q[i + 1] - q[i],
                                               n[i + 1] - n[i])
            + (n[i + 1] - n[i] - ds) * _safe_div(q[i] - q[i - 1],
                                                 n[i] - n[i - 1]))
        q_nb = torch.where(ds > 0, q[i + 1], q[i - 1])
        n_nb = torch.where(ds > 0, n[i + 1], n[i - 1])
        ql = q[i] + ds * _safe_div(q_nb - q[i], n_nb - n[i])
        use_lin = (qp <= q[i - 1]) | (qp >= q[i + 1])
        q[i] = torch.where(ds != 0, torch.where(use_lin, ql, qp), q[i])
        n[i] = n[i] + ds

    w = in_warm[..., None]
    return P2State(q=torch.where(w, q_warm, torch.stack(q, -1)),
                   n=torch.where(w, s.n, torch.stack(n, -1)),
                   npos=torch.where(w, s.npos, torch.stack(npos, -1)),
                   count=c + 1.0)


def p2_value(s: P2State) -> torch.Tensor:
    """The current quantile estimate (the middle marker); during warm-up
    (< 5 observations) the lower median of the filled slots."""
    filled = torch.isfinite(s.q)
    n_f = torch.clamp_min(filled.sum(-1, keepdim=True), 1)
    srt = torch.sort(torch.where(filled, s.q, torch.inf), -1).values
    mid = srt.gather(-1, torch.div(n_f - 1, 2, rounding_mode="floor"))[..., 0]
    return torch.where(s.count >= 5.0, s.q[..., 2], mid)
