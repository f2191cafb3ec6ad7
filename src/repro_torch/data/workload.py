"""Workload (arrival-rate) trace generation — the video-stream analogue.

Port of the ``nominal`` scenario of ``repro.data.workload`` (the fleet
CLI's default workload, with ``make_trace``'s default dynamics): per-stream
base rates around 30 requests per interval (±50 % across agents), scene
regimes that switch every 120 intervals, a slow diurnal drift, AR(1) wander
and 2 % bursts of 3×. Drawn with a ``torch.Generator`` (other numbers than
JAX's threefry streams; the tests hand JAX's traces to the port instead).
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device

BASE_RATE, HETEROGENEITY = 30.0, 0.5
REGIME_PERIOD, REGIME_SCALE = 120, 0.5
BURST_PROB, BURST_SCALE = 0.02, 3.0


def smooth_noise(gen: torch.Generator, shape, scale=1.0, corr=0.9):
    """AR(1) noise along the last axis — smooth rate wander."""
    eps = torch.randn(shape, generator=gen, device=gen.device) * scale
    x = torch.zeros(shape[:-1], device=gen.device)
    out = torch.empty_like(eps)
    for t in range(shape[-1]):
        x = corr * x + (1 - corr) * eps[..., t]
        out[..., t] = x
    return out


def make_trace(gen: torch.Generator, n_steps: int, base_rate: torch.Tensor):
    """Arrival-rate traces (requests per control interval), one per entry
    of ``base_rate`` ((A,)) -> (A, n_steps), on ``gen``'s device."""
    g = gen.device
    a = base_rate.shape[0]
    rand = lambda *s: torch.rand(s, generator=gen, device=g)
    t = torch.arange(n_steps, device=g)
    # scene regimes: piecewise-constant multipliers
    n_regimes = n_steps // REGIME_PERIOD + 1
    regime_mult = 1.0 + REGIME_SCALE * (rand(a, n_regimes) * 2 - 1)
    regimes = regime_mult[:, t // REGIME_PERIOD]
    # diurnal-ish slow sine
    slow = 1.0 + 0.25 * torch.sin(2 * math.pi * t / max(n_steps, 1) * 2.0)
    noise = 1.0 + smooth_noise(gen, (a, n_steps), scale=0.4)
    # bursts (event spikes)
    bursts = torch.where(rand(a, n_steps) < BURST_PROB, BURST_SCALE, 1.0)
    rate = base_rate[:, None] * regimes * slow * noise * bursts
    return torch.clamp(rate, 1.0, 400.0)


def fleet_traces(gen: torch.Generator, n_agents: int, n_steps: int,
                 device="cuda") -> torch.Tensor:
    """(A, n_steps) traces with per-agent base rates (workload
    heterogeneity), drawn on ``gen``'s device and returned on ``device``."""
    dev = resolve_device(device)
    u = torch.rand(n_agents, generator=gen, device=gen.device)
    bases = BASE_RATE * (1.0 + HETEROGENEITY * (u * 2 - 1))
    return make_trace(gen, n_steps, bases).to(dev)
