"""Branchless change-point detectors carried as fleet state.

Port of ``repro.health.drift``. Per monitored channel (reward, arrival
rate) each agent carries a slow EMA baseline (a running mean for the first
``warmup`` samples), a fast EMA the detector re-anchors to after an alarm,
a two-sided CUSUM (``g+ <- max(0, g+ + z - k)``, alarm at ``h``) and a
two-sided Page–Hinkley test (``m <- m + z - delta``, alarm when ``m -
min(m)`` exceeds ``lambda``), both over the standardized, clipped residual
``z``. ``score`` / ``flag`` are episode-max accumulators, zeroed by
``drift_reset_episode`` at each episode start. Every leaf is a tensor of
one batch shape (the fleet's agents, or the two channels stacked), and
the update is all ``torch.where``, so it runs inside the episode graph.

The alarm compares a statistic with 1.0: a run whose statistic lies within
float32 roundoff of 1.0 may alarm in one package and not the other (the
reference fuses ``a * b + c`` into one rounding, and divides by a
constant as a product by its reciprocal; the divisions by ``h`` and
``lambda`` are taken that way here).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch import resolve_device


@dataclass
class DriftState:
    """One detector channel: ``mu``/``var`` slow baseline, ``mu_f``/
    ``var_f`` fast re-anchor estimate, ``count`` samples seen, ``g_pos``/
    ``g_neg`` CUSUM, ``m_up``/``m_up_min``/``m_dn``/``m_dn_max``
    Page–Hinkley accumulators and their extrema, ``score``/``flag`` the
    episode-max normalized statistic and alarm."""
    mu: torch.Tensor
    var: torch.Tensor
    mu_f: torch.Tensor
    var_f: torch.Tensor
    count: torch.Tensor
    g_pos: torch.Tensor
    g_neg: torch.Tensor
    m_up: torch.Tensor
    m_up_min: torch.Tensor
    m_dn: torch.Tensor
    m_dn_max: torch.Tensor
    score: torch.Tensor
    flag: torch.Tensor


def drift_init(batch=(), device="cuda") -> DriftState:
    device = resolve_device(device)
    return DriftState(**{f.name: torch.zeros(batch, dtype=torch.float32,
                                             device=device)
                         for f in fields(DriftState)})


def drift_reset_episode(s: DriftState) -> DriftState:
    """Zero the episode-max outputs (once per episode, before the episode's
    samples); baselines and accumulators persist across episodes."""
    return DriftState(**{**{f.name: getattr(s, f.name)
                            for f in fields(DriftState)},
                         "score": torch.zeros_like(s.score),
                         "flag": torch.zeros_like(s.flag)})


def _recip(c: float) -> float:
    return float(np.float32(1.0 / c))


def drift_update(s: DriftState, x, *, k: float, h: float, ph_delta: float,
                 ph_lambda: float, ema_slow: float, ema_fast: float,
                 warmup: int, zclip: float, var_floor: float) -> DriftState:
    """One sample through both detectors. On alarm the baseline re-anchors
    to the fast EMA and the accumulators reset, so that the shifted regime
    becomes the new normal."""
    x = torch.as_tensor(x, dtype=torch.float32, device=s.mu.device)
    armed = (s.count >= warmup).to(torch.float32)

    sd = torch.sqrt(torch.clamp_min(s.var, var_floor))
    z = torch.clamp((x - s.mu) / sd, -zclip, zclip) * armed

    g_pos = torch.clamp_min(s.g_pos + z - k, 0.0) * armed
    g_neg = torch.clamp_min(s.g_neg - z - k, 0.0) * armed
    m_up = (s.m_up + z - ph_delta) * armed
    m_up_min = torch.minimum(s.m_up_min, m_up)
    m_dn = (s.m_dn + z + ph_delta) * armed
    m_dn_max = torch.maximum(s.m_dn_max, m_dn)
    ph_up = m_up - m_up_min
    ph_dn = m_dn_max - m_dn

    stat = torch.maximum(torch.maximum(g_pos, g_neg) * _recip(h),
                         torch.maximum(ph_up, ph_dn) * _recip(ph_lambda))
    alarm = (stat >= 1.0).to(torch.float32) * armed

    # running mean during warm-up, then the slow EMA; the fast channel
    # tracks the same recursion at ema_fast. EW variance:
    # var' = (1 - r)(var + r * delta^2)
    boot = 1.0 / (s.count + 1.0)
    r_s = torch.where(s.count < warmup, boot, ema_slow)
    d_s = x - s.mu
    mu_s = s.mu + r_s * d_s
    var_s = (1.0 - r_s) * (s.var + r_s * d_s * d_s)
    r_f = torch.clamp_min(boot, ema_fast)
    d_f = x - s.mu_f
    mu_f = s.mu_f + r_f * d_f
    var_f = (1.0 - r_f) * (s.var_f + r_f * d_f * d_f)

    on = alarm > 0
    reset = lambda v: torch.where(on, 0.0, v)
    return DriftState(
        mu=torch.where(on, mu_f, mu_s),
        var=torch.where(on, torch.clamp_min(var_f, var_floor), var_s),
        mu_f=mu_f, var_f=var_f, count=s.count + 1.0,
        g_pos=reset(g_pos), g_neg=reset(g_neg), m_up=reset(m_up),
        m_up_min=reset(m_up_min), m_dn=reset(m_dn), m_dn_max=reset(m_dn_max),
        score=torch.maximum(s.score, stat),
        flag=torch.maximum(s.flag, alarm))
