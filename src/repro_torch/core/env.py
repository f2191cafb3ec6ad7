"""Serving-environment MDP for iAgents (§IV-B), batched over the fleet.

Port of ``repro.core.env``: one inference replica's pipeline — arrivals ->
bounded pre-processing queue -> batched inference -> bounded
post-processing queue -> sink — with the RES / BS / MT actions and the
Eq. 1 reward. Every quantity is a scalar per agent, so the fleet steps as
(A,) tensors (the JAX package ``vmap``s a per-agent function instead).
Heterogeneity enters through the per-agent ``EnvParams`` leaves.

One env step = one control interval (1 s in the paper).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.dtypes import weak


@dataclass
class EnvParams:
    """Per-agent device/model characteristics, (A,) float32 each."""
    t0: torch.Tensor           # fixed per-batch latency (s)
    t1: torch.Tensor           # per-item compute time at full res (s)
    pre_rate: torch.Tensor     # pre-proc throughput at 1 thread (req/s)
    post_rate: torch.Tensor    # post-proc throughput at 1 thread (req/s)
    contention: torch.Tensor   # thread-contention coefficient
    queue_cap: torch.Tensor    # bounded queue capacity (requests)
    slo_s: torch.Tensor        # end-to-end SLO (s) — also a state input
    net_lat: torch.Tensor      # network/base latency offset (s)


def default_env_params(speed, slo_s=0.25, device="cuda") -> EnvParams:
    """Device profile per agent from its relative ``speed`` ((A,) or
    scalar)."""
    speed = torch.as_tensor(speed, dtype=torch.float32,
                            device=resolve_device(device))
    full = lambda v: torch.full_like(speed, v)
    return EnvParams(
        t0=0.012 / speed, t1=0.0022 / speed,
        pre_rate=220.0 * speed, post_rate=260.0 * speed,
        contention=0.18 / torch.clamp_min(speed, 0.25),
        queue_cap=full(128.0), slo_s=full(slo_s), net_lat=full(0.015))


# NVIDIA H100 SXM data sheet (dense, 700 W): 989 TFLOP/s bf16, 3.35 TB/s HBM3
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
# the fixed cost of one serving step beyond streaming its weights: the
# device time of a full-width qwen2-0.5b decode step at B=8 (chip_smoke.py
# [generate]: 4.675 ms) less its weight-streaming term (1.976 GB of
# float32 parameters at 3.35 TB/s: 0.590 ms), on an NVIDIA H100 80GB HBM3
# at a 700 W power limit
DECODE_OVERHEAD_S = 4.085e-3


class LatencyModel:
    """Calibrate (t0, t1) from roofline terms of a serving step."""

    @staticmethod
    def from_roofline(flops_per_item: float, bytes_per_step: float,
                      peak_flops: float = H100_BF16_FLOPS,
                      hbm_bw: float = H100_HBM_BYTES_PER_S,
                      overhead_s: float = DECODE_OVERHEAD_S) -> tuple:
        t0 = bytes_per_step / hbm_bw + overhead_s   # weight-streaming floor
        t1 = flops_per_item / peak_flops            # compute per request
        return t0, t1


@dataclass
class EnvState:
    pre_q: torch.Tensor        # (A,) requests waiting for pre-processing
    post_q: torch.Tensor       # (A,) requests waiting for post-processing
    drops: torch.Tensor        # (A,) drops in the last step
    cur_action: torch.Tensor   # (A, 3) long current (res, bs, mt)
    ema_lat: torch.Tensor      # (A,) weighted average local latency
    t: torch.Tensor            # (A,) int32 step counter


def env_init(cfg: FCPOConfig, n_agents: int, device="cuda") -> EnvState:
    dev = resolve_device(device)
    z = torch.zeros(n_agents, device=dev)
    return EnvState(pre_q=z, post_q=z.clone(), drops=z.clone(),
                    cur_action=torch.zeros(n_agents, 3, dtype=torch.long,
                                           device=dev),
                    ema_lat=z.clone(),
                    t=torch.zeros(n_agents, dtype=torch.int32, device=dev))


def observe_vector(cfg: FCPOConfig, *, rate, cur_action, drops, pre_q,
                   post_q, queue_cap, slo_s) -> torch.Tensor:
    """THE 8-dim iAgent state vector of §IV-B, (A, 8)."""
    ca = cur_action.to(torch.float32)
    return torch.stack([
        rate / 100.0,
        ca[:, 0] / max(cfg.n_res - 1, 1),
        ca[:, 1] / max(cfg.n_bs - 1, 1),
        ca[:, 2] / max(cfg.n_mt - 1, 1),
        drops.to(torch.float32) / 50.0,
        pre_q.to(torch.float32) / queue_cap,
        post_q.to(torch.float32) / queue_cap,
        slo_s.to(torch.float32) / 0.5,
    ], dim=-1)


def observe(cfg: FCPOConfig, ep: EnvParams, s: EnvState, rate) -> torch.Tensor:
    """The 8-dim state vector read off the fluid MDP state."""
    return observe_vector(cfg, rate=rate, cur_action=s.cur_action,
                          drops=s.drops, pre_q=s.pre_q, post_q=s.post_q,
                          queue_cap=ep.queue_cap, slo_s=ep.slo_s)


@functools.lru_cache(maxsize=8)
def action_values(cfg: FCPOConfig, device: torch.device):
    """The (res scale, batch size, threads) value tables on ``device``,
    built once instead of copied to the device every step."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (cfg.res_scales, cfg.bs_values, cfg.mt_values))


def env_step(cfg: FCPOConfig, ep: EnvParams, s: EnvState, action, rate):
    """One control interval. action: (A, 3) long; rate: (A,) arrivals.
    ``ep`` is float32; the state may be stored narrower (a state policy),
    and the new state comes back float32 for the caller to store.

    Returns (new_state, reward (A,), info dict of (A,) tensors)."""
    res_v, bs_v, mt_v = action_values(cfg, rate.device)
    res_scale = res_v[action[:, 0]]
    bs = bs_v[action[:, 1]]
    mt = mt_v[action[:, 2]]

    area = res_scale ** 2
    pack = 1.0 / area                      # frames packed per inference slot

    # --- pre-processing: threads scale throughput, contention bites back ---
    mt_eff = mt * torch.clamp_min(1.0 - ep.contention * (mt - 1.0), 0.3)
    rate_pre = ep.pre_rate * mt_eff / torch.clamp_min(area, 0.05)

    pre_in = s.pre_q + rate
    pre_done = torch.minimum(pre_in, rate_pre)
    pre_q = pre_in - pre_done
    drops_pre = torch.clamp_min(pre_q - ep.queue_cap, 0.0)
    pre_q = torch.minimum(pre_q, ep.queue_cap)

    # --- batched inference: t_batch = t0 + t1·bs·area ---
    t_batch = ep.t0 + ep.t1 * bs * area
    rate_inf = (bs * pack) / t_batch       # req/s capacity
    inf_done = torch.minimum(pre_done + 0.0, rate_inf)
    # unprocessed spill returns to the pre queue (bottleneck visibility)
    spill = pre_done - inf_done
    pre_q = torch.minimum(pre_q + spill, ep.queue_cap)

    # --- post-processing ---
    rate_post = ep.post_rate * mt_eff
    post_in = s.post_q + inf_done
    post_done = torch.minimum(post_in, rate_post)
    post_q = post_in - post_done
    drops_post = torch.clamp_min(post_q - ep.queue_cap, 0.0)
    post_q = torch.minimum(post_q, ep.queue_cap)

    drops = drops_pre + drops_post

    # --- latency estimate: queue wait (Little) + batch fill + service ---
    wait_pre = pre_q / torch.clamp_min(rate_pre, 1.0)
    wait_fill = 0.5 * bs * pack / torch.clamp_min(rate, 1.0)
    wait_post = post_q / torch.clamp_min(rate_post, 1.0)
    lat = ep.net_lat + wait_pre + wait_fill + t_batch + wait_post
    # a bf16 carry meets the literal rounded to bf16, and the product stays
    # float32 (the reference's compiled arithmetic; the identity on float32)
    ema_lat = weak(0.7, s.ema_lat) * s.ema_lat.float() + 0.3 * lat

    throughput = post_done
    slo_viol = torch.where(lat > ep.slo_s, throughput, 0.0)
    effective = throughput - slo_viol

    # --- reward (Eq. 1), squashed to (-1, 1) by tanh ---
    safe_rate = torch.clamp_min(rate, 1.0)
    r = 0.5 * (cfg.theta * throughput / safe_rate
               - cfg.sigma * ema_lat
               - cfg.phi * (bs + slo_viol) / safe_rate)
    r = torch.tanh(r)

    new_state = EnvState(pre_q=pre_q, post_q=post_q, drops=drops,
                         cur_action=action, ema_lat=ema_lat,
                         t=s.t + 1)
    info = {
        "throughput": throughput,
        "effective_throughput": effective,
        "latency": lat,
        "drops": drops,
        "accuracy_proxy": res_scale ** 0.3,
        "batch_latency": t_batch,
    }
    return new_state, r, info
