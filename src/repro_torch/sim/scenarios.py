"""Scenario library: named workload scenarios over the trace generators.

Port of ``repro.sim.scenarios``. One registry for training
(``launch/train_fleet.py --scenario``) and evaluation
(``launch/simulate.py``), so "train on X, evaluate on Y" is a pair of
names. Each scenario is a draw from a ``torch.Generator``
(``scenario_draws``) and its shaping arithmetic (``shape_scenario``), the
split ``data/workload.py`` makes for every generator.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.data import workload as wl

SCENARIOS = ("nominal", "steady", "dynamic", "burst", "diurnal",
             "flash-crowd", "drift", "switching", "ood")
# the scenarios that are ``fleet_traces`` with other dynamics; ``nominal``
# keeps make_trace's defaults (the fleet CLI's historical workload)
_FLEET = {"nominal": {}, "steady": wl.PROFILING, "dynamic": wl.DYNAMIC,
          "burst": wl.BURST, "ood": {**wl.OOD_BASE, **wl.OOD}}


def _check(name):
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"choose from {sorted(SCENARIOS)}")


def _segment(n_intervals):
    return max(n_intervals // 5, 1)


def scenario_draws(name: str, gen: torch.Generator, n_agents: int,
                   n_intervals: int) -> dict:
    """Every random number scenario ``name`` needs, from ``gen``."""
    _check(name)
    if name in _FLEET:
        return wl.fleet_draws(gen, n_agents, n_intervals,
                              _FLEET[name].get("regime_period",
                                               wl.REGIME_PERIOD))
    if name == "switching":
        return wl.switching_draws(gen, n_agents, n_intervals,
                                  _segment(n_intervals))
    return {"diurnal": wl.diurnal_draws, "flash-crowd": wl.flash_crowd_draws,
            "drift": wl.drift_draws}[name](gen, n_agents, n_intervals)


def shape_scenario(name: str, draws: dict, n_intervals: int) -> torch.Tensor:
    """(A, T) traces of scenario ``name`` from its draws."""
    _check(name)
    if name in _FLEET:
        return wl.shape_fleet(draws, n_intervals, **_FLEET[name])
    if name == "switching":
        return wl.shape_switching(draws, n_intervals, _segment(n_intervals))
    return {"diurnal": wl.shape_diurnal, "flash-crowd": wl.shape_flash_crowd,
            "drift": wl.shape_drift}[name](draws, n_intervals)


def make_scenario(name: str, gen: torch.Generator, n_agents: int,
                  n_intervals: int, device="cuda") -> torch.Tensor:
    """(A, T) control-interval arrival-rate traces for a named scenario,
    drawn on ``gen``'s device and returned on ``device``."""
    _check(name)
    dev = resolve_device(device)
    draws = scenario_draws(name, gen, n_agents, n_intervals)
    return shape_scenario(name, draws, n_intervals).to(dev)
