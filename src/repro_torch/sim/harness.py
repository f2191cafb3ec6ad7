"""Closed-loop twin harness: trained FCPO policies driving the request-level
data plane.

Port of ``repro.sim.harness``. ``simulate_fleet`` is the counterpart of the
reference's jitted ``lax.scan`` over control intervals: one interval body
observes the twin, samples every agent's action (the policy acts once per
k_ticks microticks, the paper's 1 s control cadence), decodes the actions
to service caps, spreads the interval's arrivals over its ticks, advances
the whole fleet with one ``sim_interval`` (one K3 launch on the GPU) and
writes its history row. On the GPU the body is captured once as a CUDA
graph (``core/graphs.py``) and replayed for every later interval, its
carry (the twin state, last drops and actions, the arrival phase) updated
in place and the interval's rate and noise picked by a device-side
counter; on the CPU the same body runs eagerly. The per-interval history
stays on the device and moves to the host once, at the end. With
``record_ticks`` the interval advances through ``sim_interval_recorded``
(K3's recording instantiation) and also writes the counters after every
microtick and the interval's caps, the request attribution's input; they
move to the host in the same single transfer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.agent import ActionMask, sample_actions
from repro_torch.core.env import EnvParams, observe_vector
from repro_torch.core.graphs import GraphedBody, copy_into, full_float32
from repro_torch.kernels.ref import SIM_NCAPS, SIM_NCOUNTERS
from repro_torch.sim import metrics as sim_metrics
from repro_torch.sim.state import (SimParams, SimState, action_caps,
                                   effective_queue_cap, sim_init,
                                   spread_arrivals, warn_if_ring_clamps)
from repro_torch.sim.step import sim_interval, sim_interval_recorded

HISTORY_KEYS = ("throughput", "effective_throughput", "drops", "latency",
                "pre_q", "post_q")


def sim_observe(cfg: FCPOConfig, sp: SimParams, ep: EnvParams,
                state: SimState, drops_prev, cur_action, rate):
    """The (A, 8) iAgent state vectors (§IV-B) read off the twin; the
    normalization is ``core.env.observe_vector``, shared by every backend,
    so a policy trained on the fluid env transfers unchanged."""
    return observe_vector(cfg, rate=rate, cur_action=cur_action,
                          drops=drops_prev, pre_q=state.pre_q,
                          post_q=state.post_q,
                          queue_cap=effective_queue_cap(sp, ep),
                          slo_s=ep.slo_s)


def simulate_fleet(cfg: FCPOConfig, sp: SimParams, params,
                   masks: ActionMask, env_params: EnvParams,
                   traces: torch.Tensor, *, gumbel=None, generator=None,
                   record_ticks: bool = False
                   ) -> Tuple[SimState, Dict[str, np.ndarray], Dict]:
    """Drive a fleet of policies through the request-level twin.

    params/masks/env_params: the agent-stacked (A, ...) policy parameters,
    action masks and device profiles (a ``Fleet``'s); traces: (A, T)
    control-interval arrival rates (requests/s), on the fleet's device.
    ``gumbel``: optional pre-drawn (T, A, ``noise_width(cfg)``) action
    noise; without it the noise comes from ``generator``. On the GPU the
    interval body is captured once and replayed for every later interval
    (a capture error raises). Returns (final state, per-interval history
    of (T, A) numpy arrays, per-agent request-grade summary of (A,)
    tensors incl. p50/p99 latency).

    ``record_ticks``: also return the per-microtick counter series
    (``history["tick_counters"]``: (T, A, K, SIM_NCOUNTERS) int32) and the
    held interval caps (``history["caps"]``: (T, A, SIM_NCAPS) float32),
    which ``repro_torch.obs.requests`` turns into per-request stage
    stamps; the twin state is the unrecorded run's bit for bit."""
    warn_if_ring_clamps(sp, env_params.queue_cap, stacklevel=2)
    dev = traces.device
    a, n_int = traces.shape
    f32 = torch.float32
    # the run's inputs, staged interval-major once
    rates = traces.t().to(f32).contiguous()
    noise = None if gumbel is None else gumbel.to(dev, f32).contiguous()
    t_dev = torch.zeros((), dtype=torch.long, device=dev)
    k = sp.k_ticks
    if record_ticks:
        # one int32 buffer holds the history, the tick series and the caps
        # (float32 words viewed in place), so one transfer moves all three
        sizes = (n_int * len(HISTORY_KEYS) * a, n_int * a * k * SIM_NCOUNTERS,
                 n_int * a * SIM_NCAPS)
        record = torch.zeros(sum(sizes), dtype=torch.int32, device=dev)
        hist_w, ticks_w, caps_w = record.split(sizes)
        hist = hist_w.view(torch.float32).view(n_int, len(HISTORY_KEYS), a)
        tick_hist = ticks_w.view(n_int, a, k, SIM_NCOUNTERS)
        caps_hist = caps_w.view(torch.float32).view(n_int, a, SIM_NCAPS)
    else:
        hist = torch.zeros((n_int, len(HISTORY_KEYS), a), device=dev)
    state = sim_init(sp, a, dev)
    drops_prev = torch.zeros(a, dtype=torch.int32, device=dev)
    cur_action = torch.zeros(a, 3, dtype=torch.long, device=dev)
    phase = torch.zeros(a, device=dev)

    def interval():
        t = t_dev.view(1)
        rate = rates.index_select(0, t)[0]
        obs = sim_observe(cfg, sp, env_params, state, drops_prev, cur_action,
                          rate)
        actions, _, _ = sample_actions(
            cfg, params, obs, masks,
            gumbel=None if noise is None else noise.index_select(0, t)[0],
            generator=generator)
        caps = action_caps(cfg, sp, env_params, actions)
        arrivals, phase2 = spread_arrivals(sp, rate, phase)
        if record_ticks:
            state2, ticks = sim_interval_recorded(state, arrivals, caps)
            tick_hist.index_copy_(0, t, ticks[None])
            caps_hist.index_copy_(0, t, caps[None])
        else:
            state2 = sim_interval(state, arrivals, caps)

        d_comp = (state2.completed - state.completed).to(f32)
        d_drop = state2.dropped - state.dropped
        hist.index_copy_(0, t, torch.stack([
            d_comp / sp.interval_s,
            (state2.effective - state.effective).to(f32) / sp.interval_s,
            d_drop.to(f32),
            (state2.lat_sum - state.lat_sum)
            / torch.clamp_min(d_comp, 1.0) * sp.dt,
            state2.pre_q.to(f32),
            state2.post_q.to(f32)])[None])
        copy_into(state, state2)
        drops_prev.copy_(d_drop)
        cur_action.copy_(actions)
        phase.copy_(phase2)
        t_dev.add_(1)

    body = GraphedBody(interval, dev,
                       (generator,) if noise is None else ())
    with torch.no_grad(), full_float32():
        for _ in range(n_int):
            body()
    if record_ticks:
        host = record.cpu().numpy()                  # one transfer
        hist_h, ticks_h, caps_h = np.split(host, np.cumsum(sizes)[:-1])
        history = dict(zip(HISTORY_KEYS, hist_h.view(np.float32).reshape(
            n_int, len(HISTORY_KEYS), a).transpose(1, 0, 2)))
        history["tick_counters"] = ticks_h.reshape(n_int, a, k,
                                                   SIM_NCOUNTERS)
        history["caps"] = caps_h.view(np.float32).reshape(n_int, a,
                                                          SIM_NCAPS)
    else:
        stacked = hist.transpose(0, 1).cpu().numpy()   # one transfer
        history = dict(zip(HISTORY_KEYS, stacked))
    summary = sim_metrics.summarize(state, sp)
    sim_metrics.warn_if_censored(summary, sp, stacklevel=3)
    return state, history, summary


def eval_fleet(cfg: FCPOConfig, sp: SimParams, fleet, traces, *,
               gumbel=None, generator=None, record_ticks: bool = False):
    """``simulate_fleet`` for a trained fleet: reads the policy, masks and
    device profiles off anything Fleet-shaped (``.astate.policy`` /
    ``.masks`` / ``.env_params``); the noise comes from ``generator``,
    else from the fleet's own generator."""
    return simulate_fleet(cfg, sp, fleet.astate.policy.params(), fleet.masks,
                          fleet.env_params, traces, gumbel=gumbel,
                          generator=(fleet.generator if generator is None
                                     else generator),
                          record_ticks=record_ticks)
