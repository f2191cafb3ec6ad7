"""State layout and action decode of the request-level data-plane twin.

Port of ``repro.sim.state``, batched over the fleet. A ``SimState`` holds
every agent's discrete-event pipeline as (A, ...) tensors: a power-of-two
ring of arrival microticks plus the monotone stage counters, token-bucket
service credits and request-grade accumulators laid out in
``repro_torch.kernels.ref`` (``SIM_*``). Stage membership is positional:
queue lengths are counter differences and a request's deadline is
``arrive + slo_ticks``.

``action_caps`` decodes an iAgent action (RES, BS, MT) into per-tick
service capacities with the same formulas as the fluid ``core/env.py`` MDP
(contention, frame packing, the t0 + t1·bs·area batch curve), and
``spread_arrivals`` spreads an interval's arrivals over its ticks. Both
compute the float32 values the reference computes as XLA compiles it, so
the integer twin state they feed matches the JAX package exactly.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.env import EnvParams, action_values
from repro_torch.kernels import ref as kref


@dataclass(frozen=True)
class SimParams:
    """Static twin geometry."""
    dt: float = 0.05     # microtick length (s); k_ticks*dt = control interval
    k_ticks: int = 20    # microticks per control interval (1 s in the paper)
    ring: int = 512      # ring capacity; power of two, >= 3 * queue_cap
    hist_n: int = 64     # latency histogram buckets (ticks)

    def __post_init__(self):
        kref.check_ring(self.ring)
        if self.k_ticks < 1 or self.hist_n < 2:
            raise ValueError(f"SimParams needs k_ticks >= 1 and hist_n >= 2, "
                             f"got {self.k_ticks}, {self.hist_n}")

    @property
    def interval_s(self) -> float:
        return self.k_ticks * self.dt


@dataclass
class SimState:
    """The fleet's twin state, agent-leading."""
    arrive: torch.Tensor    # (A, R) int32 — arrival microtick per ring slot
    counters: torch.Tensor  # (A, SIM_NCOUNTERS) int32 — pointers, counts
    credits: torch.Tensor   # (A, 2) float32 — pre/post fractional credit
    lat_sum: torch.Tensor   # (A,) float32 — summed completed latency (ticks)
    hist: torch.Tensor      # (A, H) int32 — completed-latency histogram

    def tensors(self):
        """The five state tensors in the kernel's argument order."""
        return tuple(getattr(self, f.name) for f in fields(self))

    def _c(self, i):
        return self.counters[..., i]

    # queue lengths are differences of the monotone stage counters
    @property
    def pre_q(self):
        return self._c(kref.SIM_TAIL) - self._c(kref.SIM_PPRE)

    @property
    def batch_q(self):
        return self._c(kref.SIM_PPRE) - self._c(kref.SIM_LAUNCH)

    @property
    def post_q(self):
        return self._c(kref.SIM_PINF) - self._c(kref.SIM_HEAD)

    @property
    def in_flight(self):
        return self._c(kref.SIM_TAIL) - self._c(kref.SIM_HEAD)

    @property
    def arrived(self):
        return self._c(kref.SIM_ARRIVED)

    @property
    def dropped(self):
        return self._c(kref.SIM_DROPPED)

    @property
    def completed(self):
        return self._c(kref.SIM_COMPLETED)

    @property
    def effective(self):
        return self._c(kref.SIM_EFFECTIVE)

    @property
    def tick(self):
        return self._c(kref.SIM_TICK)


def sim_init(sp: SimParams, n_agents: int, device="cuda") -> SimState:
    """``n_agents`` empty pipelines."""
    dev = resolve_device(device)
    z = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device=dev)
    return SimState(arrive=z(n_agents, sp.ring),
                    counters=z(n_agents, kref.SIM_NCOUNTERS),
                    credits=z(n_agents, 2, dt=torch.float32),
                    lat_sum=z(n_agents, dt=torch.float32),
                    hist=z(n_agents, sp.hist_n))


def effective_queue_cap(sp: SimParams, ep: EnvParams) -> torch.Tensor:
    """Per-stage queue capacity (A,), clamped so the ring can never
    overflow (each of the three stage queues is bounded by it)."""
    return torch.clamp_max(ep.queue_cap, float(sp.ring // 3))


def warn_if_ring_clamps(sp: SimParams, queue_cap, stacklevel: int = 2
                        ) -> None:
    """Warn when the ring cannot hold 3x the device queue_cap: the clamp
    then changes twin dynamics, observation normalization and, in
    twin-backed training, ``fl_round``'s Eq. 7 memory-availability stat
    (which normalizes ``pre_q`` by the unclamped cap)."""
    qcap = np.asarray(torch.as_tensor(queue_cap).cpu())
    if (qcap > sp.ring // 3).any():
        warnings.warn(
            f"SimParams.ring={sp.ring} clamps queue_cap "
            f"{float(qcap.max()):.0f} -> {sp.ring // 3} (ring must be >= "
            f"3*queue_cap); twin dynamics, observation normalization, and "
            f"the Eq. 7 memory-availability stat (twin-backed training) "
            f"will differ from the fluid env — raise `ring` to match the "
            f"device profile", stacklevel=stacklevel)


def _fma(x, y, z):
    """float32 ``x * y + z`` rounded once, as a fused multiply-add: the
    float64 product of two float32 values is exact, and the sum is rounded
    to float64 and then to float32 (equal to the fused result but for a
    double rounding at an exact float32 midpoint)."""
    f64 = lambda v: v.double() if torch.is_tensor(v) else v
    return (f64(x) * f64(y) + f64(z)).to(torch.float32)


def action_caps(cfg: FCPOConfig, sp: SimParams, ep: EnvParams,
                action: torch.Tensor) -> torch.Tensor:
    """Decode (A, 3) actions into (A, SIM_NCAPS) float32 caps: the fluid
    MDP's latency surface (mt contention, 1/area frame packing, t_batch =
    t0 + t1·bs·area) discretized to ticks.

    The values are the reference's as XLA compiles it (every JAX caller
    runs it under ``jit``): ``1 - contention*(mt-1)`` and ``t0 +
    (t1*bs)*area`` each contracted into one fused multiply-add, and the
    divisions by ``dt`` turned into products with the float32 constant
    ``1/dt``. Evaluated op by op, the written form differs by up to 2 ulps
    in the pre/post service caps for device speeds outside the default mix
    {0.5, 0.75, 1, 2} (PERF.md)."""
    res_v, bs_v, mt_v = action_values(cfg, action.device)
    res_scale = res_v[action[:, 0]]
    bs = bs_v[action[:, 1]]
    mt = mt_v[action[:, 2]]
    inv_dt = float(np.float32(1.0) / np.float32(sp.dt))

    area = res_scale * res_scale
    mt_eff = mt * torch.clamp_min(_fma(-ep.contention, mt - 1.0, 1.0), 0.3)
    rate_pre = ep.pre_rate * mt_eff / torch.clamp_min(area, 0.05)
    rate_post = ep.post_rate * mt_eff
    t_batch_s = _fma(ep.t1 * bs, area, ep.t0)

    return torch.stack([
        rate_pre * sp.dt,
        rate_post * sp.dt,
        torch.clamp_min(torch.round(bs / area), 1.0),      # requests per batch
        torch.clamp_min(torch.ceil(t_batch_s * inv_dt), 1.0),
        torch.round(effective_queue_cap(sp, ep)),
        torch.clamp_min(torch.round(ep.slo_s * inv_dt), 1.0),
    ], dim=-1)


def spread_arrivals(sp: SimParams, rate: torch.Tensor, phase: torch.Tensor):
    """Per-tick arrival counts for one control interval, (A,) rates in
    requests/s: cumulative-floor spreading of ``rate`` over k_ticks, with
    ``phase`` carrying the fractional request left from earlier intervals.
    Returns ((A, K) int32 counts, (A,) float32 new phase in [0, 1)); the
    interval total is floor(phase + rate * dt * k_ticks).

    The arithmetic is the reference's as XLA compiles it (the form every
    JAX caller runs, under ``jit``): ``phase + (rate*dt) * j`` contracted
    into one fused multiply-add, and ``phase + rate * (dt*k_ticks)`` with
    ``dt*k_ticks`` folded into one float32 constant, also fused. Evaluated
    op by op, the written form differs in the last bit of the phase for
    about a quarter of the rates, and in a count for about one row in
    10^4."""
    f32 = torch.float32
    j = torch.arange(1 + sp.k_ticks, dtype=f32, device=rate.device)
    step = rate * sp.dt
    cum = torch.floor(_fma(step[:, None], j, phase[:, None]))
    counts = (cum[:, 1:] - cum[:, :-1]).to(torch.int32)
    per_interval = float(np.float32(sp.dt) * np.float32(sp.k_ticks))
    end = _fma(rate, per_interval, phase)
    return counts, end - torch.floor(end)
