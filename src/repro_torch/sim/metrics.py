"""Request-grade metrics from twin state: throughput, effective throughput,
drops, and latency percentiles from the on-device histogram.

Port of ``repro.sim.metrics`` (``hist_percentile``, ``summarize``,
``stage_breakdown_table``, ``warn_if_censored``), batched over the
fleet.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.sim.state import SimParams, SimState

CENSORED_WARN_FRACTION = 0.01


def hist_percentile(hist: torch.Tensor, q: float) -> torch.Tensor:
    """q-quantile (in ticks) of completed-latency histograms (..., H): the
    first bucket where the cumulative count reaches ceil(q * total); 0 for
    an empty histogram. The top bucket is right-censored, so the result is
    a lower bound whenever it is populated."""
    total = hist.sum(-1, keepdim=True, dtype=torch.int32)
    cum = torch.cumsum(hist, -1, dtype=torch.int32)
    target = torch.clamp_min(torch.ceil(q * total), 1)
    # argmax over an int tensor: the first bucket that reaches the target
    idx = torch.argmax((cum >= target).to(torch.int32), dim=-1)
    return torch.where(total[..., 0] > 0, idx, 0)


def summarize(state: SimState, sp: SimParams) -> dict:
    """Per-agent request-grade summary, (A,) tensors: rates per second over
    the simulated horizon, latencies in seconds. ``hist_censored`` is the
    fraction of completions in the top (censored) bucket;
    ``mean_latency_s`` comes from the unclipped latency sum."""
    f32 = torch.float32
    secs = torch.clamp_min(state.tick.to(f32) * sp.dt, 1e-9)
    completed = state.completed.to(f32)
    return {
        "hist_censored": (state.hist[..., -1].to(f32)
                          / torch.clamp_min(completed, 1.0)),
        "throughput": completed / secs,
        "effective_throughput": state.effective.to(f32) / secs,
        # 1.0 when nothing completed: an idle agent met every SLO it had
        "slo_attainment": (state.effective.to(f32)
                           / torch.clamp_min(completed, 1.0)),
        "drop_rate": (state.dropped.to(f32)
                      / torch.clamp_min(state.arrived.to(f32), 1.0)),
        "mean_latency_s": (state.lat_sum / torch.clamp_min(completed, 1.0)
                           * sp.dt),
        "p50_latency_s": hist_percentile(state.hist, 0.50).to(f32) * sp.dt,
        "p99_latency_s": hist_percentile(state.hist, 0.99).to(f32) * sp.dt,
        "arrived": state.arrived,
        "completed": state.completed,
        "dropped": state.dropped,
        "effective": state.effective,
        "in_flight": state.in_flight,
    }


def stage_breakdown_table(decomposition: dict) -> str:
    """Render a per-stage latency decomposition (the dict
    ``repro_torch.obs.requests.stage_decomposition`` returns: stage ->
    {mean_s, p50_s, p99_s, p99_tail_mean_s}) as an aligned table — the
    "where does the tail go" block ``launch/simulate.py --attribution``
    prints. The JAX package's text."""
    lines = [f"{'stage':12s}{'mean':>10s}{'p50':>10s}{'p99':>10s}"
             f"{'p99-tail':>10s}"]
    for stage, row in decomposition.items():
        lines.append(
            f"{stage:12s}"
            f"{row['mean_s'] * 1e3:9.1f}ms{row['p50_s'] * 1e3:9.1f}ms"
            f"{row['p99_s'] * 1e3:9.1f}ms"
            f"{row['p99_tail_mean_s'] * 1e3:9.1f}ms")
    return "\n".join(lines)


def warn_if_censored(summary: dict, sp: SimParams,
                     threshold: float = CENSORED_WARN_FRACTION,
                     stacklevel: int = 2) -> float:
    """Warn when more than ``threshold`` of any agent's completions landed
    in the censored top bucket (p50/p99 are then lower bounds capped at
    ``(hist_n - 1) * dt``). Returns the worst per-agent fraction (one
    device-to-host read)."""
    frac = float(summary["hist_censored"].max())
    if frac > threshold:
        warnings.warn(
            f"latency histogram is right-censored: {frac * 100:.1f}% of "
            f"completions landed in the top bucket (cap "
            f"{(sp.hist_n - 1) * sp.dt * 1e3:.0f} ms) — p50/p99 are lower "
            f"bounds; re-run with a larger SimParams.hist_n",
            stacklevel=stacklevel)
    return frac
