"""Workload (arrival-rate) trace generation — the video-stream analogue.

Port of ``repro.data.workload``. Traces model the paper's content dynamics
(Fig. 2a): a base request rate per stream, slow diurnal drift, scene
regimes that switch on context changes, AR(1) wander and short bursts;
``switching_traces`` concatenates segments from different sources (Fig.
13), ``ood_traces`` is the Fig. 10 out-of-distribution workload, and
``diurnal_traces`` / ``flash_crowd_traces`` / ``drift_traces`` are the
scenario library's day cycle, sustained surge and slow ramp.

Each generator is split in two: ``*_draws`` takes every random number it
needs from a ``torch.Generator`` (other numbers than JAX's threefry
streams), and ``shape_*`` turns those draws into traces with the
reference's arithmetic. The tests hand ``shape_*`` the draws JAX made and
compare the traces. Traces are (A, n_steps) float32 requests per control
interval.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device

BASE_RATE, HETEROGENEITY = 30.0, 0.5
REGIME_PERIOD = 120
# Fig. 2a-grade content dynamics (3-10x swings)
DYNAMIC = dict(regime_scale=0.9, burst_prob=0.05, burst_scale=4.0)
# narrow profiling distribution (what an offline-trained agent sees)
PROFILING = dict(regime_scale=0.05, burst_prob=0.0)
# spiky event-camera workload: frequent short multi-x spikes
BURST = dict(regime_scale=0.3, burst_prob=0.15, burst_scale=5.0)
# Fig. 10 OOD streams (AI-City-style 10 FPS vehicle tracking): base rates
# and trace dynamics
OOD_BASE = dict(base_rate=60.0, heterogeneity=0.8)
OOD = dict(regime_period=30, regime_scale=1.0, burst_prob=0.08,
           burst_scale=2.0)


def _uniform(gen, *shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _normal(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _steps(n_steps, like):
    return torch.arange(n_steps, device=like.device)


def _clip(rate):
    return torch.clamp(rate, 1.0, 400.0)


def smooth_noise(eps, scale=1.0, corr=0.9):
    """AR(1) noise along the last axis of standard-normal draws ``eps``."""
    eps = eps * scale
    x = torch.zeros(eps.shape[:-1], device=eps.device)
    out = torch.empty_like(eps)
    for t in range(eps.shape[-1]):
        x = corr * x + (1 - corr) * eps[..., t]
        out[..., t] = x
    return out


# ---------------------------------------------------------------------------
# make_trace / fleet_traces (the nominal, steady, dynamic, burst, ood mixes)
# ---------------------------------------------------------------------------
def trace_draws(gen, n_agents, n_steps, regime_period=REGIME_PERIOD):
    return {"regime": _uniform(gen, n_agents, n_steps // regime_period + 1),
            "noise": _normal(gen, n_agents, n_steps),
            "burst": _uniform(gen, n_agents, n_steps)}


def shape_trace(draws, n_steps, base_rate, regime_period=REGIME_PERIOD,
                regime_scale=0.5, burst_prob=0.02, burst_scale=3.0):
    """One trace per entry of ``base_rate`` ((A,)): piecewise-constant scene
    regimes, a slow sine, AR(1) wander and Bernoulli bursts."""
    t = _steps(n_steps, base_rate)
    regime_mult = 1.0 + regime_scale * (draws["regime"] * 2 - 1)
    regimes = regime_mult[:, t // regime_period]
    slow = 1.0 + 0.25 * torch.sin(2 * math.pi * t / max(n_steps, 1) * 2.0)
    noise = 1.0 + smooth_noise(draws["noise"], scale=0.4)
    bursts = torch.where(draws["burst"] < burst_prob, burst_scale, 1.0)
    return _clip(base_rate[:, None] * regimes * slow * noise * bursts)


def make_trace(gen, n_steps, base_rate, **dynamics):
    """Arrival-rate traces, one per entry of ``base_rate`` ((A,)), with
    ``make_trace``'s keyword dynamics (regime_period, regime_scale,
    burst_prob, burst_scale)."""
    draws = trace_draws(gen, base_rate.shape[0], n_steps,
                        dynamics.get("regime_period", REGIME_PERIOD))
    return shape_trace(draws, n_steps, base_rate.to(gen.device), **dynamics)


def fleet_draws(gen, n_agents, n_steps, regime_period=REGIME_PERIOD):
    return {"base": _uniform(gen, n_agents),
            **trace_draws(gen, n_agents, n_steps, regime_period)}


def shape_fleet(draws, n_steps, base_rate=BASE_RATE,
                heterogeneity=HETEROGENEITY, **dynamics):
    bases = base_rate * (1.0 + heterogeneity * (draws["base"] * 2 - 1))
    return shape_trace(draws, n_steps, bases, **dynamics)


def fleet_traces(gen, n_agents, n_steps, base_rate=BASE_RATE,
                 heterogeneity=HETEROGENEITY, device="cuda", **dynamics):
    """(A, n_steps) traces with per-agent base rates (workload
    heterogeneity), drawn on ``gen``'s device and returned on ``device``.
    Extra keywords are ``make_trace``'s dynamics."""
    dev = resolve_device(device)
    draws = fleet_draws(gen, n_agents, n_steps,
                        dynamics.get("regime_period", REGIME_PERIOD))
    return shape_fleet(draws, n_steps, base_rate, heterogeneity,
                       **dynamics).to(dev)


def ood_traces(gen, n_agents, n_steps, device="cuda"):
    """Fig. 10: out-of-distribution workload (other rate statistics and
    burst structure)."""
    return fleet_traces(gen, n_agents, n_steps, device=device, **OOD_BASE,
                        **OOD)


# ---------------------------------------------------------------------------
# switching (Fig. 13)
# ---------------------------------------------------------------------------
def switching_draws(gen, n_agents, n_steps, segment=60, n_sources=3):
    src = torch.randint(0, n_sources, (n_agents, n_steps // segment + 1),
                        generator=gen, device=gen.device)
    return {"src": src, "noise": _normal(gen, n_agents, n_steps)}


def shape_switching(draws, n_steps, segment=60, base_rates=(15.0, 45.0, 90.0)):
    rates = torch.tensor(base_rates, device=draws["noise"].device)
    t = _steps(n_steps, draws["noise"])
    base = rates[draws["src"][:, t // segment]]
    noise = 1.0 + smooth_noise(draws["noise"], 0.3)
    return _clip(base * noise)


def switching_traces(gen, n_agents, n_steps, segment=60,
                     base_rates=(15.0, 45.0, 90.0), device="cuda"):
    """Concatenated segments from drastically different sources: every
    ``segment`` steps the underlying distribution switches."""
    dev = resolve_device(device)
    draws = switching_draws(gen, n_agents, n_steps, segment, len(base_rates))
    return shape_switching(draws, n_steps, segment, base_rates).to(dev)


# ---------------------------------------------------------------------------
# diurnal, flash crowd, drift
# ---------------------------------------------------------------------------
def diurnal_draws(gen, n_agents, n_steps):
    return {"phase": _uniform(gen, n_agents), "base": _uniform(gen, n_agents),
            "noise": _normal(gen, n_agents, n_steps)}


def shape_diurnal(draws, n_steps, base_rate=40.0, amplitude=0.7, cycles=1.0):
    phases = draws["phase"] * 2 * math.pi
    bases = base_rate * (1.0 + 0.3 * (draws["base"] * 2 - 1))
    t = _steps(n_steps, phases).to(torch.float32)
    cycle = 1.0 + amplitude * torch.sin(
        2 * math.pi * cycles * t / max(n_steps, 1) + phases[:, None])
    noise = 1.0 + smooth_noise(draws["noise"], scale=0.2)
    return _clip(bases[:, None] * cycle * noise)


def diurnal_traces(gen, n_agents, n_steps, device="cuda", **kw):
    """Day/night cycle: a deep sinusoid with a per-agent phase offset plus
    AR(1) wander."""
    dev = resolve_device(device)
    return shape_diurnal(diurnal_draws(gen, n_agents, n_steps), n_steps,
                         **kw).to(dev)


def _surge_len(n_steps, surge_frac):
    return max(int(n_steps * surge_frac), 1)


def flash_crowd_draws(gen, n_agents, n_steps, surge_frac=0.25):
    lo = n_steps // 8
    hi = max(n_steps - _surge_len(n_steps, surge_frac), lo + 1)
    start = torch.randint(lo, hi, (n_agents,), generator=gen,
                          device=gen.device)
    return {"start": start, "base": _uniform(gen, n_agents),
            "noise": _normal(gen, n_agents, n_steps)}


def shape_flash_crowd(draws, n_steps, base_rate=25.0, surge_mult=6.0,
                      surge_frac=0.25):
    surge_len = _surge_len(n_steps, surge_frac)
    bases = base_rate * (1.0 + 0.3 * (draws["base"] * 2 - 1))
    t = _steps(n_steps, bases)
    s0 = draws["start"][:, None]
    mult = torch.where((t >= s0) & (t < s0 + surge_len), surge_mult, 1.0)
    noise = 1.0 + smooth_noise(draws["noise"], scale=0.25)
    return _clip(bases[:, None] * mult * noise)


def flash_crowd_traces(gen, n_agents, n_steps, device="cuda", **kw):
    """Steady load, then a sustained surge of ``surge_frac`` of the
    horizon at ``surge_mult`` x the base rate from a per-agent random
    step."""
    dev = resolve_device(device)
    draws = flash_crowd_draws(gen, n_agents, n_steps,
                              kw.get("surge_frac", 0.25))
    return shape_flash_crowd(draws, n_steps, **kw).to(dev)


def drift_draws(gen, n_agents, n_steps):
    return {"jitter": _uniform(gen, n_agents),
            "noise": _normal(gen, n_agents, n_steps)}


def shape_drift(draws, n_steps, start_rate=15.0, end_rate=90.0):
    jitter = 1.0 + 0.25 * (draws["jitter"] * 2 - 1)
    t = _steps(n_steps, jitter).to(torch.float32)
    ramp = start_rate + (end_rate - start_rate) * t / max(n_steps - 1, 1)
    noise = 1.0 + smooth_noise(draws["noise"], scale=0.25)
    return _clip(ramp * jitter[:, None] * noise)


def drift_traces(gen, n_agents, n_steps, device="cuda", **kw):
    """Slow non-stationary drift: the base rate ramps from ``start_rate``
    to ``end_rate`` over the horizon."""
    dev = resolve_device(device)
    return shape_drift(drift_draws(gen, n_agents, n_steps), n_steps,
                       **kw).to(dev)
