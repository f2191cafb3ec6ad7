"""Environment backends — the fluid MDP and the request-level twin.

Port of ``repro.core.backends``: an environment backend is the environment
contract of the CRL loop (``init`` / ``observe`` / ``step`` over the whole
fleet's (A,)-batched state, ``check_env_params`` once on the concrete
device profile).

* ``FluidBackend`` — the fluid MDP of ``core/env.py``: one env step per
  control interval, the SLO as a binary per-interval cutoff.
* ``TwinBackend`` — the request-level digital twin (``repro_torch.sim``):
  each step nests ``sp.k_ticks`` microticks of the discrete-event data
  plane (one K3 ``queue_advance`` launch for the fleet on the GPU) and the
  Eq. 1 reward is computed from request-grade completions, per-request
  deadline misses and admission drops.

The tensors' device picks the K3 implementation, as for K1 and K2.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core import env as env_mod
from repro_torch.core.dtypes import tree_f32, weak
from repro_torch.sim.state import (SimParams, SimState, action_caps,
                                   effective_queue_cap, sim_init,
                                   spread_arrivals, warn_if_ring_clamps)
from repro_torch.sim.step import sim_interval


@dataclass(frozen=True)
class FluidBackend:
    """The fluid MDP of ``core/env.py``."""

    name = "fluid"

    def init(self, cfg: FCPOConfig, n_agents: int, device="cuda"):
        return env_mod.env_init(cfg, n_agents, device)

    def observe(self, cfg, ep, state, rate):
        return env_mod.observe(cfg, ep, state, rate)

    def step(self, cfg, ep, state, action, rate):
        return env_mod.env_step(cfg, ep, state, action, rate)

    def check_env_params(self, ep) -> None:
        """Nothing to check: the fluid MDP honors any device profile."""


@dataclass
class TwinEnvState:
    """The fleet's twin environment state: the request-level pipeline plus
    the control-plane carries the fluid MDP keeps in ``EnvState``."""
    sim: SimState                # the pointer-segmented rings (A, ...)
    cur_action: torch.Tensor     # (A, 3) long current (res, bs, mt)
    drops_prev: torch.Tensor     # (A,) int32 admission drops last interval
    phase: torch.Tensor          # (A,) float32 fractional-arrival carry
    ema_lat: torch.Tensor        # (A,) float32 EMA of mean latency (s)

    # fl_round's Eq. 7 memory-availability stat reads ``env_state.pre_q``
    # on either backend
    @property
    def pre_q(self):
        return self.sim.pre_q.to(torch.float32)

    @property
    def post_q(self):
        return self.sim.post_q.to(torch.float32)


@dataclass(frozen=True)
class TwinBackend:
    """The request-level twin as a training environment: one ``step`` is
    one control interval of ``sp.k_ticks`` microticks."""

    name = "twin"
    sp: SimParams = field(default_factory=SimParams)

    def check_env_params(self, ep) -> None:
        """The ``effective_queue_cap`` clamp guard on the training path
        (the same check ``simulate_fleet`` makes)."""
        warn_if_ring_clamps(self.sp, ep.queue_cap, stacklevel=4)

    def init(self, cfg: FCPOConfig, n_agents: int, device="cuda"):
        dev = resolve_device(device)
        return TwinEnvState(
            sim=sim_init(self.sp, n_agents, dev),
            cur_action=torch.zeros(n_agents, 3, dtype=torch.long, device=dev),
            drops_prev=torch.zeros(n_agents, dtype=torch.int32, device=dev),
            phase=torch.zeros(n_agents, device=dev),
            ema_lat=torch.zeros(n_agents, device=dev))

    def observe(self, cfg, ep, state: TwinEnvState, rate):
        return env_mod.observe_vector(
            cfg, rate=rate, cur_action=state.cur_action,
            drops=state.drops_prev, pre_q=state.sim.pre_q,
            post_q=state.sim.post_q,
            queue_cap=effective_queue_cap(self.sp, ep), slo_s=ep.slo_s)

    def step(self, cfg, ep, state: TwinEnvState, action, rate):
        """One control interval. action: (A, 3) long; rate: (A,) requests/s;
        ``ep`` float32. Returns (new_state, reward (A,), info dict of (A,)
        tensors); the new state's float leaves come back float32 for the
        caller to store at the carry's dtypes."""
        sp = self.sp
        caps = action_caps(cfg, sp, ep, action)
        arrivals, phase = spread_arrivals(sp, rate, state.phase)
        # K3 takes float32 credits and latency sums: a narrower stored
        # state is read up here and stored back by the caller
        sim2 = sim_interval(tree_f32(state.sim), arrivals, caps)

        # request-grade interval deltas (the counters are cumulative)
        f32 = torch.float32
        d_comp = (sim2.completed - state.sim.completed).to(f32)
        d_eff = (sim2.effective - state.sim.effective).to(f32)
        d_drop = sim2.dropped - state.sim.dropped
        mean_lat = ((sim2.lat_sum - state.sim.lat_sum)
                    / torch.clamp_min(d_comp, 1.0) * sp.dt)
        # carry the EMA through empty intervals instead of decaying to zero
        ema_lat = torch.where(d_comp > 0,
                              weak(0.7, state.ema_lat)
                              * state.ema_lat.float() + 0.3 * mean_lat,
                              state.ema_lat.float())

        throughput = d_comp / sp.interval_s
        effective = d_eff / sp.interval_s
        miss_rate = (d_comp - d_eff) / sp.interval_s   # deadline misses /s
        drop_rate = d_drop.to(f32) / sp.interval_s

        res_v, bs_v, _ = env_mod.action_values(cfg, action.device)
        res_scale = res_v[action[:, 0]]
        bs = bs_v[action[:, 1]]

        # Eq. 1 on request-grade quantities: completions only, the EMA of
        # measured per-request latency, and an oversize penalty that grows
        # with per-request deadline misses and admission drops
        safe_rate = torch.clamp_min(rate, 1.0)
        r = 0.5 * (cfg.theta * throughput / safe_rate
                   - cfg.sigma * ema_lat
                   - cfg.phi * (bs + miss_rate + drop_rate) / safe_rate)
        r = torch.tanh(r)

        new_state = TwinEnvState(sim=sim2, cur_action=action,
                                 drops_prev=d_drop, phase=phase,
                                 ema_lat=ema_lat)
        info = {
            "throughput": throughput,
            "effective_throughput": effective,
            "latency": torch.where(d_comp > 0, mean_lat, ema_lat),
            "drops": d_drop.to(f32),
            "accuracy_proxy": res_scale ** 0.3,
            "batch_latency": ep.t0 + ep.t1 * bs * res_scale ** 2,
        }
        return new_state, r, info


FLUID = FluidBackend()
BACKENDS = ("fluid", "twin")


def get_backend(spec: Union[str, FluidBackend, TwinBackend, None],
                sim_params: SimParams = None):
    """Resolve a backend: a backend object passes through; ``"fluid"`` /
    ``None`` is the fluid MDP, ``"twin"`` the twin at ``sim_params``
    (default ``SimParams()``)."""
    if isinstance(spec, (FluidBackend, TwinBackend)):
        return spec
    if spec is None or spec == "fluid":
        return FLUID
    if spec == "twin":
        return TwinBackend(sp=sim_params or SimParams())
    raise ValueError(f"unknown env backend {spec!r}; choose from {BACKENDS}")
