"""Baselines the paper compares against (§V-A4), on the same serving
environment as FCPO, so that the comparison is like for like.

Port of ``repro.core.baselines``:

* **BCEdge-like**: offline-trained RL, ONE bulky agent per *device* (it
  decides for all replicas hosted there from their mean state — the
  decision bottleneck the paper calls out), frozen at runtime, a large
  replay buffer (700 slots an episode) and a wider network
  (``hidden_scale=4``: 8→256→192) with one joint action head; batch size
  and concurrency limited to two configurations each, as in the paper's
  deployment.
* **OctopInf-like**: no local RL: every ``period`` intervals a global
  scheduler picks one static configuration per replica by grid search
  against the average rate of the last window.
* **Distream-like**: workload-adaptive placement but no runtime parameter
  optimization: bs=1, full resolution, one thread.

Each runs in the fluid MDP or the request-level twin (``env_backend``).
The runtime loops keep the per-interval fleet means on the device and
read them once, at the end (the reference reads one per interval). The
random draws the reference makes from its keys enter as inputs, as in the
fleet functions: BCEdge's device fleet, its profiling traces and its
action noise; without them they come from ``torch`` generators seeded by
``key``.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core import env as env_mod
from repro_torch.core.agent import ActionMask, sample_actions
from repro_torch.core.backends import get_backend
from repro_torch.core.fleet import fleet_episode, fleet_init
from repro_torch.data.workload import PROFILING, fleet_traces

# the per-episode history every baseline returns, in the reference's order
HISTORY_KEYS = ("reward", "throughput", "effective_throughput", "latency")


def bcedge_config() -> FCPOConfig:
    """Bulky single-joint-head offline agent (Table I row: no online
    learning, no knowledge fusion, 'Last'-checkpoint warm start)."""
    return FCPOConfig(
        single_head=True,
        hidden_scale=4,          # deeper/wider -> ~10x memory (Fig. 11)
        buffer_size=7000 // 10,  # per-episode slots; 7000-exp replay overall
        loss_gate=0.0,
        policy_mode="ppo",
        # paper §V-A4: concurrency and batch limited to two configurations
        n_mt=2,
    )


def bcedge_masks(cfg: FCPOConfig, n_devices: int, device="cuda"
                 ) -> ActionMask:
    """Full resolution only, batch sizes 4 and 16, every thread count."""
    dev = resolve_device(device)
    rows = lambda m: m.expand(n_devices, -1).clone()
    bs = torch.zeros(cfg.n_bs, dtype=torch.bool, device=dev)
    bs[[2, 4]] = True
    return ActionMask(
        res=rows(torch.arange(cfg.n_res, device=dev) == 0), bs=rows(bs),
        mt=torch.ones(n_devices, cfg.n_mt, dtype=torch.bool, device=dev))


def _replica_env(cfg: FCPOConfig, n_replicas: int, seed: int, backend, dev):
    """The replicas' device profiles, drawn from the reference's numpy
    stream (``default_rng(seed)``)."""
    speeds = np.random.default_rng(seed).choice([0.5, 0.75, 1.0, 2.0],
                                                n_replicas)
    ep = env_mod.default_env_params(speeds, cfg.slo_s, dev)
    backend.check_env_params(ep)
    return ep


def _record(hist, t, reward, info) -> None:
    """Row ``t`` of the device-side history: the fleet means of
    ``HISTORY_KEYS``."""
    hist[t] = torch.stack([reward.mean(), info["throughput"].mean(),
                           info["effective_throughput"].mean(),
                           info["latency"].mean()])


def _episode_means(cfg: FCPOConfig, hist: torch.Tensor
                   ) -> Dict[str, np.ndarray]:
    """The per-interval history, moved to the host in one transfer and
    averaged to episode granularity (float64, as the reference does)."""
    h = hist.cpu().numpy().astype(np.float64)
    n_eps = h.shape[0] // cfg.n_steps
    h = h[:n_eps * cfg.n_steps].reshape(n_eps, cfg.n_steps, -1).mean(1)
    return {k: h[:, i] for i, k in enumerate(HISTORY_KEYS)}


def run_bcedge(n_replicas: int, traces, key: int = 0,
               replicas_per_device: int = 4, offline_episodes: int = 120,
               seed: int = 0, env_backend=None, *, device="cuda",
               fleet=None, profiling=None, offline_gumbel=None,
               gumbel=None) -> Dict[str, np.ndarray]:
    """Offline-train one device agent on profiling traces, then run it
    frozen over ``traces`` ((n_replicas, T) requests per interval). Device
    agents act from the mean state of their replicas (a segment mean by
    ``index_add_``) and broadcast one action to all of them.
    ``env_backend``: the environment of both phases (fluid by default,
    ``"twin"``). ``seed``: the replicas' device mix.

    The reference's draws, as inputs: ``fleet``, the device fleet to
    start from (default ``fleet_init(bcedge_config(), n_dev, key,
    masks=bcedge_masks, speeds=1)``); ``profiling``, (n_dev,
    offline_episodes·n_steps) traces (default: ``PROFILING`` traces from a
    generator seeded by ``key + 1``); ``offline_gumbel``
    ((offline_episodes, n_dev, n_steps, 56)) and ``gumbel`` ((T, n_dev,
    56)), the action noise of the two phases (default: the fleet's
    generator). Returns {``HISTORY_KEYS``: (T // n_steps,) episode
    means}."""
    cfg = bcedge_config()
    dev = resolve_device(device)
    backend = get_backend(env_backend)
    n_dev = max(1, n_replicas // replicas_per_device)
    n = cfg.n_steps

    # --- offline phase: profiling traces (paper §V-B1: "profiling data is
    # obviously less diverse in workload patterns and cannot capture all
    # the conditions of devices"), uniform device speed ---
    if fleet is None:
        fleet = fleet_init(cfg, n_dev, key,
                           masks=bcedge_masks(cfg, n_dev, dev),
                           speeds=np.ones(n_dev), device=dev,
                           env_backend=backend)
    if profiling is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(key + 1)
        profiling = fleet_traces(gen, n_dev, offline_episodes * n,
                                 heterogeneity=0.0, device=dev, **PROFILING)
    profiling = torch.as_tensor(profiling, dtype=torch.float32, device=dev)
    for e in range(offline_episodes):
        fleet, _, _ = fleet_episode(
            cfg, fleet, profiling[:, e * n:(e + 1) * n], learn=True,
            backend=backend,
            gumbel=None if offline_gumbel is None else offline_gumbel[e])

    # --- runtime: frozen; the device agent drives all its replicas ---
    rep_env = _replica_env(cfg, n_replicas, seed, backend, dev)
    states = backend.init(cfg, n_replicas, dev)
    dev_of = torch.arange(n_replicas, device=dev) % n_dev
    hosted = torch.zeros(n_dev, device=dev).index_add_(
        0, dev_of, torch.ones(n_replicas, device=dev))
    params = {k: v.detach() for k, v in fleet.astate.policy.params().items()}
    rates = torch.as_tensor(traces, dtype=torch.float32, device=dev)
    noise = None if gumbel is None else \
        torch.as_tensor(gumbel, dtype=torch.float32, device=dev)
    hist = torch.zeros(rates.shape[1], len(HISTORY_KEYS), device=dev)
    with torch.no_grad():
        for t in range(rates.shape[1]):
            rate = rates[:, t]
            obs = backend.observe(cfg, rep_env, states, rate)
            # the device agent sees the MEAN state of its replicas
            dev_obs = torch.zeros(n_dev, obs.shape[-1], device=dev) \
                .index_add_(0, dev_of, obs) / torch.clamp_min(hosted, 1.0)[
                    :, None]
            actions, _, _ = sample_actions(
                cfg, params, dev_obs, fleet.masks,
                gumbel=None if noise is None else noise[t],
                generator=fleet.generator)
            states, r, info = backend.step(cfg, rep_env, states,
                                           actions[dev_of], rate)
            _record(hist, t, r, info)
    return _episode_means(cfg, hist)


def _host_env(ep: env_mod.EnvParams) -> env_mod.EnvParams:
    """The device profiles as numpy arrays (one transfer)."""
    return env_mod.EnvParams(*(getattr(ep, f.name).cpu().numpy()
                               for f in fields(ep)))


def _static_policy_run(cfg: FCPOConfig, n_replicas: int, traces, seed,
                       pick_action: Callable, env_backend=None,
                       device="cuda") -> Dict[str, np.ndarray]:
    """Run a non-RL policy: ``pick_action(traces (A, T) numpy, t, env
    params as numpy) -> (A, 3)``. The policy reads no environment state,
    so every interval's actions are picked on the host first and moved to
    the device in one transfer."""
    dev = resolve_device(device)
    backend = get_backend(env_backend)
    rep_env = _replica_env(cfg, n_replicas, seed, backend, dev)
    states = backend.init(cfg, n_replicas, dev)
    traces_np = np.asarray(traces.cpu() if torch.is_tensor(traces)
                           else traces, np.float32)
    host_env = _host_env(rep_env)
    t_total = traces_np.shape[1]
    actions = torch.as_tensor(
        np.stack([pick_action(traces_np, t, host_env)
                  for t in range(t_total)]), dtype=torch.long, device=dev)
    rates = torch.as_tensor(traces_np, device=dev)
    hist = torch.zeros(t_total, len(HISTORY_KEYS), device=dev)
    with torch.no_grad():
        for t in range(t_total):
            states, r, info = backend.step(cfg, rep_env, states, actions[t],
                                           rates[:, t])
            _record(hist, t, r, info)
    return _episode_means(cfg, hist)


def run_octopinf(n_replicas: int, traces, seed: int = 0, period: int = 300,
                 cfg: FCPOConfig = None, env_backend=None, *,
                 device="cuda") -> Dict[str, np.ndarray]:
    """Periodic global scheduling: grid-search the best static config for
    the trailing-window average rate, re-plan every ``period``
    intervals."""
    cfg = cfg or FCPOConfig()
    cache = {}

    def best_static(rate, ep_t0, ep_t1):
        key = (round(float(rate), 0), round(float(ep_t0), 4))
        if key in cache:
            return cache[key]
        best, best_r = (0, 2, 1), -np.inf
        for ir, rs in enumerate(cfg.res_scales):
            for ib, bs in enumerate(cfg.bs_values):
                for im, _mt in enumerate(cfg.mt_values):
                    area = rs ** 2
                    t_b = ep_t0 + ep_t1 * bs * area
                    thr = min(rate, bs / area / t_b)
                    lat = 0.015 + 0.5 * bs / area / max(rate, 1) + t_b
                    r = (cfg.theta * thr / max(rate, 1) - cfg.sigma * lat
                         - cfg.phi * bs / max(rate, 1))
                    if r > best_r:
                        best_r, best = r, (ir, ib, im)
        cache[key] = best
        return best

    def pick(traces_np, t, rep_env):
        w0 = (t // period) * period
        avg = traces_np[:, max(w0 - period, 0): w0 + 1].mean(1)
        return np.stack([
            best_static(avg[i], float(rep_env.t0[i]), float(rep_env.t1[i]))
            for i in range(len(avg))])

    return _static_policy_run(cfg, n_replicas, traces, seed, pick,
                              env_backend=env_backend, device=device)


def run_distream(n_replicas: int, traces, seed: int = 0,
                 cfg: FCPOConfig = None, env_backend=None, *,
                 device="cuda") -> Dict[str, np.ndarray]:
    """No runtime parameter optimization: bs=1, full res, 1 thread."""
    cfg = cfg or FCPOConfig()
    fixed = np.zeros((n_replicas, 3), np.int64)
    return _static_policy_run(cfg, n_replicas, traces, seed,
                              lambda tr, t, ep: fixed,
                              env_backend=env_backend, device=device)
