"""Fleet health observatory: learning-dynamics state of the fleet.

Port of ``repro.health``. Health is an optional field of the ``Fleet``
(``fleet.health``, None by default, when every driver runs exactly as
without it). Enabled, the state is a ``HealthState`` of agent-leading
float32 tensors, updated by tensor ops inside the drivers' bodies (the
episode and FL-round graphs on the GPU):

* per episode: telemetry sketches (``sketch.py``) and drift detectors
  (``drift.py``) consume the episode's per-interval telemetry (batched
  histogram and action-marginal updates, then the stride-mean samples
  through P² and both drift channels stacked);
* per FL round: contribution attribution (``attribution.py``) scores each
  selected client's wire delta into a suspicion EMA, which
  ``GuardConfig.susp_threshold`` can gate Eq. 7 selection on;
* per episode, on the host: the O(bins) summaries join the history and the
  metrics stream, where ``alerts.py`` evaluates rules into an alerts file
  and ``launch/watch.py`` renders them.

``HealthConfig`` is the reference's frozen dataclass: present means on,
None means off.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device

from repro_torch.health.attribution import attribution_scores
from repro_torch.health.drift import (DriftState, drift_init,
                                      drift_reset_episode, drift_update)
from repro_torch.health.sketch import (P2State, hist_merge, hist_quantile,
                                       hist_update_batch, p2_init,
                                       p2_update, p2_value)

__all__ = [
    "HealthConfig", "HealthState", "DEFAULT_HEALTH", "HEALTH_METRIC_KEYS",
    "health_init", "update_episode", "episode_summaries", "update_round",
    "attribution_scores", "DriftState", "P2State", "hist_merge",
]


@dataclass(frozen=True)
class HealthConfig:
    """The observatory's knobs, the reference's: ``bins`` histogram
    resolution (quantile error <= one bin width); ``cusum_k``/``cusum_h``
    and ``ph_delta``/``ph_lambda`` detector thresholds; ``stride``
    intervals per detector sample (``n_steps`` must be a multiple);
    ``warmup`` detector samples before the detectors arm; ``susp_beta``
    the EMA weight of the newest round's attribution score."""
    bins: int = 16
    stride: int = 10
    reward_lo: float = -1.0
    reward_hi: float = 1.0
    cusum_k: float = 0.5
    cusum_h: float = 10.0
    ph_delta: float = 0.2
    ph_lambda: float = 25.0
    ema_slow: float = 0.02
    ema_fast: float = 0.3
    warmup: int = 10
    zclip: float = 8.0
    var_floor: float = 1e-3
    susp_beta: float = 0.5

    def __post_init__(self):
        if self.bins < 2:
            raise ValueError("bins must be >= 2")
        if self.reward_hi <= self.reward_lo:
            raise ValueError("reward_hi must exceed reward_lo")
        for name in ("cusum_k", "cusum_h", "ph_delta", "ph_lambda",
                     "zclip", "var_floor"):
            if getattr(self, name) <= 0.0:
                raise ValueError(f"{name} must be > 0")
        for name in ("ema_slow", "ema_fast", "susp_beta"):
            if not (0.0 < getattr(self, name) <= 1.0):
                raise ValueError(f"{name} must be in (0, 1]")
        if self.warmup < 1:
            raise ValueError("warmup must be >= 1")
        if self.stride < 1:
            raise ValueError("stride must be >= 1")


DEFAULT_HEALTH = HealthConfig()

# per-episode summary keys merged into the history and the stream ((A,)
# tensors, fleet-reduced by the drivers like every other episode metric)
HEALTH_METRIC_KEYS = (
    "health_reward_p50", "health_reward_p10", "health_reward_p90",
    "health_miss_p90", "health_act_entropy", "health_drift_score",
    "health_drift_flag", "health_susp",
)


@dataclass
class HealthState:
    """Agent-leading float32 tensors (the reference's ``HealthState``)."""
    reward_hist: torch.Tensor   # (A, bins)
    miss_hist: torch.Tensor     # (A, bins)
    reward_p2: P2State          # (A, 5) / (A,)
    act_sum: torch.Tensor       # (A, K) running sum of action marginals
    n_obs: torch.Tensor         # (A,) intervals observed
    drift_reward: DriftState    # (A,)
    drift_rate: DriftState      # (A,)
    susp: torch.Tensor          # (A,) attribution suspicion EMA
    susp_last: torch.Tensor     # (A,) raw suspicion of the last FL round
    sel_last: torch.Tensor      # (A,) selection mask of that round


def health_init(hcfg: HealthConfig, n_agents: int, n_actions: int,
                device="cuda") -> HealthState:
    device = resolve_device(device)
    zeros = lambda *s: torch.zeros((n_agents, *s), dtype=torch.float32,
                                   device=device)
    return HealthState(
        reward_hist=zeros(hcfg.bins), miss_hist=zeros(hcfg.bins),
        reward_p2=p2_init(0.5, (n_agents,), device), act_sum=zeros(n_actions),
        n_obs=zeros(), drift_reward=drift_init((n_agents,), device),
        drift_rate=drift_init((n_agents,), device), susp=zeros(),
        susp_last=zeros(), sel_last=zeros())


def _detector_kwargs(hcfg: HealthConfig) -> dict:
    return dict(k=hcfg.cusum_k, h=hcfg.cusum_h, ph_delta=hcfg.ph_delta,
                ph_lambda=hcfg.ph_lambda, ema_slow=hcfg.ema_slow,
                ema_fast=hcfg.ema_fast, warmup=hcfg.warmup,
                zclip=hcfg.zclip, var_floor=hcfg.var_floor)


def _stack(a: DriftState, b: DriftState) -> DriftState:
    return DriftState(**{k: torch.stack([v, getattr(b, k)])
                         for k, v in vars(a).items()})


def _pick(d: DriftState, i: int) -> DriftState:
    return DriftState(**{k: v[i] for k, v in vars(d).items()})


def update_episode(hcfg: HealthConfig, state: HealthState, reward, miss,
                   probs, rate) -> HealthState:
    """Advance every agent's sketches and detectors through one episode of
    per-interval telemetry: ``reward``/``miss``/``rate`` (A, T), ``probs``
    (A, T, K). The histogram counts and the action marginals commute, so
    the episode lands in two scatter-adds and one sum; only the detectors
    are sequential, over the ``T / stride`` stride-mean samples, both drift
    channels as one stacked (2, A) update."""
    dk = _detector_kwargs(hcfg)
    a, t = reward.shape
    s = hcfg.stride
    if t % s != 0:
        raise ValueError(
            f"episode length {t} is not a multiple of HealthConfig.stride="
            f"{s}; pick a stride that divides cfg.n_steps")
    # the stride means as the reference compiles them: the sum times the
    # float32 reciprocal of the stride
    inv = float(np.float32(1.0 / s))
    rs = reward.reshape(a, t // s, s).sum(-1) * inv
    ras = rate.reshape(a, t // s, s).sum(-1) * inv
    p2 = state.reward_p2
    d2 = _stack(drift_reset_episode(state.drift_reward),
                drift_reset_episode(state.drift_rate))
    for j in range(t // s):
        p2 = p2_update(p2, rs[:, j], 0.5)
        d2 = drift_update(d2, torch.stack([rs[:, j], ras[:, j]]), **dk)
    return HealthState(
        reward_hist=hist_update_batch(state.reward_hist, reward,
                                      hcfg.reward_lo, hcfg.reward_hi),
        miss_hist=hist_update_batch(state.miss_hist, miss, 0.0, 1.0),
        reward_p2=p2,
        act_sum=state.act_sum + probs.float().sum(1),
        n_obs=state.n_obs + float(t),
        drift_reward=_pick(d2, 0), drift_rate=_pick(d2, 1),
        susp=state.susp, susp_last=state.susp_last,
        sel_last=state.sel_last)


def episode_summaries(hcfg: HealthConfig, state: HealthState
                      ) -> Dict[str, torch.Tensor]:
    """O(bins) per-agent digests of the state: the (A,) tensors merged
    into the episode metrics (keys ``HEALTH_METRIC_KEYS``)."""
    rq = lambda p: hist_quantile(state.reward_hist, p, hcfg.reward_lo,
                                 hcfg.reward_hi)
    marg = state.act_sum / torch.clamp_min(state.n_obs, 1.0)[:, None]
    pm = marg / torch.clamp_min(marg.sum(1, keepdim=True), 1e-9)
    entropy = -(pm * torch.log(pm + 1e-9)).sum(1)
    return {
        "health_reward_p50": p2_value(state.reward_p2),
        "health_reward_p10": rq(0.10),
        "health_reward_p90": rq(0.90),
        "health_miss_p90": hist_quantile(state.miss_hist, 0.90, 0.0, 1.0),
        "health_act_entropy": entropy,
        "health_drift_score": torch.maximum(state.drift_reward.score,
                                            state.drift_rate.score),
        "health_drift_flag": torch.maximum(state.drift_reward.flag,
                                           state.drift_rate.flag),
        "health_susp": state.susp,
    }


def update_round(hcfg: HealthConfig, state: HealthState, susp_new,
                 sel) -> HealthState:
    """Fold one FL round's attribution scores into the suspicion EMA;
    unselected clients keep theirs. ``susp_last``/``sel_last`` keep the raw
    round."""
    sel32 = sel.to(torch.float32)
    beta = hcfg.susp_beta
    ema = torch.where(sel32 > 0, (1.0 - beta) * state.susp + beta * susp_new,
                      state.susp)
    return HealthState(**{**vars(state), "susp": ema,
                          "susp_last": susp_new * sel32, "sel_last": sel32})
