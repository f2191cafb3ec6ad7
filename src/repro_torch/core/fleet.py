"""Fleet driver: the FCPO loop over a fleet of iAgents.

Port of ``repro.core.fleet`` (the reference driver and its building
blocks). One ``Fleet`` holds stacked per-agent state (A on the leading
axis) and the per-pod base networks (P). Per episode ``fleet_episode``
runs the CRL inner loop for all agents; every ``fl_every`` episodes
``fl_round`` runs Eq. 7 selection -> Algorithm 1 aggregation -> Algorithm 2
head fine-tuning -> buffer resync; every ``hierarchical_period`` rounds
``pod_merge`` averages the pods' base networks.

Two drivers. ``train_fleet_reference`` is the Python-loop driver (one
device->host transfer per episode for its metrics). ``train_fleet_scan``
(and ``train_fleet``, which delegates to it) is the counterpart of the JAX
package's one jitted, donated ``lax.scan``: on the GPU the episode body,
the FL round and the pod merge are each captured once as a CUDA graph
(``core/graphs.py``) and replayed by the host in the order of the
host-known FL schedule — at most three graph launches per episode, one
transfer at the end of the run. Its carry is static: the fleet's own
tensors are the graphs' inputs and outputs, updated in place (what JAX's
donation does), and the per-episode inputs (rates, availability bits,
optional noise) are staged on the device once and picked by a device-side
episode counter. On the CPU the same bodies run eagerly in the same order;
the two drivers give the same numbers bit for bit.

Randomness: the fleet carries a ``torch.Generator`` (parameter init and
action noise). The drivers also take pre-drawn Gumbel action noise, the
seam the parity tests use to replay the JAX package's draws.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core import env as env_mod
from repro_torch.core import federated as fed
from repro_torch.core.agent import (ActionMask, AgentPolicy, agent_init,
                                    full_mask, params_from_numpy,
                                    params_to_numpy, tensors_from_numpy)
from repro_torch.core.backends import FLUID, TwinEnvState, get_backend
from repro_torch.core.buffer import (DiversityBuffer, buffer_diversity_mean,
                                     buffer_init, buffer_resync)
from repro_torch.core.crl import EPISODE_METRICS, AgentState, crl_episode
from repro_torch.core.graphs import GraphedBody, copy_into, full_float32
from repro_torch.core.ppo import Rollout, agent_opt_init, finetune_heads
from repro_torch.fl import transport as fl_transport
from repro_torch.fl.codec import codec_roundtrip, residuals_init
from repro_torch.fl.transport import DEFAULT_TRANSPORT, TransportConfig
from repro_torch.resilience.guards import finite_mask
from repro_torch.sim.state import SimState


@dataclass
class Fleet:
    """Stacked fleet state: agent-leading (A, ...) tensors, the (P, ...)
    pod base networks, and the fleet's generator."""
    astate: AgentState
    base: AgentPolicy                 # per-pod base networks, n = P
    env_params: env_mod.EnvParams
    masks: ActionMask
    group_ids: Dict[str, torch.Tensor]   # per head key: (A,) group ids
    group_counts: Dict[str, int]
    pod_ids: torch.Tensor             # (A,) long
    bandwidth: torch.Tensor           # (A,) Mbit/s
    speeds: torch.Tensor              # (A,)
    residuals: Dict[str, torch.Tensor]   # codec error feedback, (A, ...)
    generator: torch.Generator
    n_pods: int
    episode: int = 0

    def replace(self, **kw) -> "Fleet":
        return replace(self, **kw)


def _assemble(cfg, policy, opt, buffer, env_state, base, env_params, masks,
              speeds, bandwidth, residuals, generator, episode=0) -> Fleet:
    n_agents, n_pods = speeds.shape[0], next(base.parameters()).shape[0]
    dev = speeds.device
    group_ids, group_counts = fed.head_group_ids(masks, dev)
    return Fleet(
        astate=AgentState(policy, opt, buffer, env_state), base=base,
        env_params=env_params, masks=masks, group_ids=group_ids,
        group_counts=group_counts,
        pod_ids=torch.arange(n_agents, device=dev) % n_pods,
        bandwidth=bandwidth, speeds=speeds, residuals=residuals,
        generator=generator, n_pods=n_pods, episode=episode)


def fleet_init(cfg: FCPOConfig, n_agents: int, seed: int = 0, *,
               n_pods: int = 1, device="cuda", env_backend=None,
               slo_s: Optional[float] = None) -> Fleet:
    """A fresh fleet: random agents and pod base networks from ``seed``,
    the heterogeneous device mix and link bandwidths drawn from the same
    numpy streams as the reference (``default_rng(0)`` / ``(1)``).
    ``env_backend`` (``"fluid"``, the default, ``"twin"`` or a backend)
    builds ``astate.env_state``: pass the same backend to the drivers."""
    dev = resolve_device(device)
    backend = get_backend(env_backend)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    policy = agent_init(cfg, n_agents, gen, dev)
    base = agent_init(cfg, 1, gen, dev)
    pod_base = AgentPolicy(cfg, n_pods, dev)
    pod_base.assign({k: v.expand((n_pods,) + v.shape[1:])
                     for k, v in base.params().items()})
    speeds = torch.as_tensor(np.random.default_rng(0).choice(
        [0.5, 0.75, 1.0, 2.0], n_agents), dtype=torch.float32, device=dev)
    bandwidth = torch.as_tensor(np.random.default_rng(1).uniform(
        2.0, 40.0, n_agents), dtype=torch.float32, device=dev)
    # slo_s overrides cfg.slo_s, as the JAX fleet_init's slo_s does
    env_params = env_mod.default_env_params(
        speeds, cfg.slo_s if slo_s is None else slo_s, dev)
    backend.check_env_params(env_params)
    return _assemble(
        cfg, policy, agent_opt_init(policy.params()),
        buffer_init(cfg, n_agents, dev), backend.init(cfg, n_agents, dev),
        pod_base, env_params, full_mask(cfg, n_agents, dev), speeds,
        bandwidth, residuals_init(policy.params()), gen)


def _numpy_fields(obj):
    """A state dataclass as a dict of numpy arrays (nested for the twin's
    ``sim``)."""
    conv = lambda v: _numpy_fields(v) if is_dataclass(v) else v.cpu().numpy()
    return {f.name: conv(getattr(obj, f.name)) for f in fields(obj)}


def _from_fields(cls, tree, dev, longs=(), nested=None):
    """``cls`` from a dict of numpy arrays; ``longs`` name the fields made
    ``long``, ``nested`` maps a field holding a dict to its class."""
    nested = nested or {}

    def conv(name, v):
        if name in nested:
            return _from_fields(nested[name], v, dev)
        t = torch.tensor(np.asarray(v), device=dev)
        if name in longs:
            return t.long()
        return t.float() if t.is_floating_point() else t
    return cls(**{f.name: conv(f.name, tree[f.name]) for f in fields(cls)})


def _env_state_from_numpy(tree, dev):
    """The fluid ``EnvState``, or the twin's ``TwinEnvState`` where the tree
    holds a nested ``sim`` (its counters stay int32)."""
    if "sim" in tree:
        return _from_fields(TwinEnvState, tree, dev, longs=("cur_action",),
                            nested={"sim": SimState})
    return _from_fields(env_mod.EnvState, tree, dev, longs=("cur_action",))


def fleet_from_numpy(cfg: FCPOConfig, tree, device="cuda", seed: int = 0
                     ) -> Fleet:
    """A fleet built from the JAX fleet's state as nested dicts of numpy
    arrays (``jax.tree.map(np.asarray, ...)`` of each part): keys
    ``params``, ``opt`` (``m``/``v`` trees, ``t``), ``buffer``,
    ``env_state`` (the fluid or, with a nested ``sim``, the twin state),
    ``env_params`` (field dicts), ``base_params``,
    ``masks`` (``res``/``bs``/``mt``), ``speeds``, ``bandwidth``, and
    optionally ``residuals`` and ``episode``. ``seed`` seeds the fleet's
    generator. ``fleet_to_numpy`` is the reverse."""
    dev = resolve_device(device)
    policy = params_from_numpy(cfg, tree["params"], dev)
    base = params_from_numpy(cfg, tree["base_params"], dev)
    opt = {"m": tensors_from_numpy(tree["opt"]["m"], dev),
           "v": tensors_from_numpy(tree["opt"]["v"], dev),
           "t": torch.tensor(np.asarray(tree["opt"]["t"]),
                             dtype=torch.int32, device=dev)}
    residuals = (tensors_from_numpy(tree["residuals"], dev)
                 if "residuals" in tree
                 else residuals_init(policy.params()))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                                 device=dev)
    masks = ActionMask(*(torch.tensor(np.asarray(tree["masks"][k]),
                                      dtype=torch.bool, device=dev)
                         for k in ("res", "bs", "mt")))
    return _assemble(
        cfg, policy, opt,
        _from_fields(DiversityBuffer, tree["buffer"], dev, longs=("actions",)),
        _env_state_from_numpy(tree["env_state"], dev),
        base, _from_fields(env_mod.EnvParams, tree["env_params"], dev),
        masks, f32(tree["speeds"]), f32(tree["bandwidth"]), residuals, gen,
        episode=int(tree.get("episode", 0)))


def fleet_to_numpy(fleet: Fleet):
    """The nested-dict numpy form of ``fleet`` (the layout
    ``fleet_from_numpy`` reads)."""
    a = fleet.astate
    return {
        "params": params_to_numpy(a.policy.params()),
        "opt": {"m": params_to_numpy(a.opt["m"]),
                "v": params_to_numpy(a.opt["v"]),
                "t": a.opt["t"].cpu().numpy()},
        "buffer": _numpy_fields(a.buffer),
        "env_state": _numpy_fields(a.env_state),
        "env_params": _numpy_fields(fleet.env_params),
        "base_params": params_to_numpy(fleet.base.params()),
        "masks": _numpy_fields(fleet.masks),
        "speeds": fleet.speeds.cpu().numpy(),
        "bandwidth": fleet.bandwidth.cpu().numpy(),
        "residuals": params_to_numpy(fleet.residuals),
        "episode": fleet.episode,
    }


def fleet_episode(cfg: FCPOConfig, fleet: Fleet, rates: torch.Tensor,
                  learn: bool = True, gumbel=None, backend=FLUID):
    """One CRL episode for all agents. rates: (A, n_steps); gumbel:
    optional pre-drawn (A, n_steps, n_res+n_bs+n_mt) action noise;
    ``backend``: the environment, the one the fleet was built with.
    Returns (fleet, rollouts, per-agent metrics)."""
    astate, rollouts, metrics = crl_episode(
        cfg, fleet.env_params, fleet.astate, rates, fleet.masks, learn,
        backend=backend, gumbel=gumbel, generator=fleet.generator)
    return fleet.replace(astate=astate, episode=fleet.episode + 1), \
        rollouts, metrics


def fl_round(cfg: FCPOConfig, fleet: Fleet, rollouts, available=None,
             transport: Optional[TransportConfig] = None):
    """One synchronous federated round: uplink model -> Eq. 7 selection ->
    (lossy codec) -> Alg. 1 aggregation -> Alg. 2 head fine-tuning ->
    buffer moment resync.

    ``available`` ((A,) bool) masks out stragglers. With the float32 codec
    the server's reconstruction is the client params themselves and the
    codec is skipped; int8/topk encode ``params - base`` per leaf with error
    feedback (the K2 kernel on the GPU), and only selected contributors are
    seen through the wire. A contribution holding a NaN or Inf is dropped
    from aggregation (``fl_rejected``). Returns (fleet, sel (A,) bool,
    fl_metrics of 0-dim tensors)."""
    transport = DEFAULT_TRANSPORT if transport is None else transport
    policy, astate = fleet.astate.policy, fleet.astate
    params = {k: v.detach() for k, v in policy.params().items()}
    base = {k: v.detach() for k, v in fleet.base.params().items()}
    dev = fleet.pod_ids.device
    a = fleet.pod_ids.shape[0]
    if available is None:
        available = torch.ones(a, dtype=torch.bool, device=dev)

    # --- communication model: static payload sizes, per-agent links
    up_bytes = fl_transport.agent_payload_bytes(params.values(), transport)
    full_bytes = fl_transport.full_param_bytes(params.values())
    down_bytes = fl_transport.downlink_bytes(transport, a, fleet.n_pods,
                                             up_bytes, full_bytes)
    uplink_s = fl_transport.uplink_seconds(up_bytes, fleet.bandwidth)
    on_time = fl_transport.on_time_mask(uplink_s, transport.deadline_s)
    fresh_ok = available & on_time

    # --- Eq. 7 selection: a slow link drops out of selection
    stats = fed.ClientStats(
        mem_avail=torch.clamp(1.0 - astate.env_state.pre_q
                              / fleet.env_params.queue_cap, 0, 1),
        compute_avail=torch.clamp(fleet.speeds / 2.0, 0, 1),
        diversity=buffer_diversity_mean(astate.buffer),
        bandwidth=fleet.bandwidth, available=fresh_ok)
    sel = fed.select_clients(cfg, stats)
    with torch.no_grad():
        head_losses = fed.per_head_losses(cfg, params, rollouts, fleet.masks)

    # --- the server-side view of each client's parameters
    residuals = fleet.residuals
    if transport.plain:
        # a client NaN'd by its own training drops out of aggregation
        ok = finite_mask(params)
        recon, sel_agg = params, sel & ok
    else:
        base_g = {k: b[fleet.pod_ids] for k, b in base.items()}
        delta = {k: params[k] - base_g[k] for k in params}
        decoded, res_next = codec_roundtrip(delta, fleet.residuals, transport)
        # selection already required on-time; garbage on the wire is dropped
        ok = finite_mask(decoded)
        sel_agg = sel & ok
        # only selected contributors are seen through the wire; everyone
        # else enters aggregation with their TRUE params
        rows = lambda m, x: m.reshape((-1,) + (1,) * (x.dim() - 1))
        recon = {k: torch.where(rows(sel_agg, params[k]),
                                base_g[k] + decoded[k], params[k])
                 for k in params}
        # error feedback commits only for deltas that went over the wire
        residuals = {k: torch.where(rows(sel, res_next[k]), res_next[k],
                                    fleet.residuals[k]) for k in res_next}

    new_params, new_base = fed.aggregate(
        cfg, recon, base, sel_agg, head_losses, fleet.group_ids,
        fleet.group_counts, fleet.pod_ids, fleet.n_pods)
    # Algorithm 2: local action-head fine-tuning on local experiences
    new_params, opt = finetune_heads(cfg, new_params, astate.opt, rollouts,
                                     fleet.masks)
    policy.assign(new_params)
    fleet.base.assign(new_base)
    # FL-round cadence resyncs the buffers' streaming moments
    astate = AgentState(policy, opt, buffer_resync(astate.buffer),
                        astate.env_state)

    n_up = sel.sum().to(torch.float32)
    fl_metrics = {
        "fl_payload_bytes": n_up * up_bytes + down_bytes,
        "fl_uplink_s": torch.where(sel, uplink_s, 0.0).sum()
        / torch.clamp_min(n_up, 1.0),
        "fl_missed": (available & ~on_time).sum().to(torch.float32),
        "fl_rejected": (sel & ~ok).sum().to(torch.float32),
    }
    return fleet.replace(astate=astate, residuals=residuals), sel_agg, \
        fl_metrics


def pod_merge(cfg: FCPOConfig, fleet: Fleet) -> Fleet:
    """Hierarchical cross-pod exchange (cloud tier): the pods' base
    networks are averaged and redistributed (in place)."""
    base = {k: v.detach() for k, v in fleet.base.params().items()}
    fleet.base.assign(fed.merge_pods(base))
    return fleet


def train_fleet_reference(cfg: FCPOConfig, fleet: Fleet, traces, *,
                          learn: bool = True, federated: bool = True,
                          straggler_prob: float = 0.0, seed: int = 0,
                          env_backend=None,
                          transport: Optional[TransportConfig] = None,
                          gumbel=None):
    """The Python-loop driver: episodes over ``traces`` (A, total_steps),
    an FL round every ``fl_every`` episodes (stragglers from
    ``draw_availability(seed)``, the reference's stream), a pod merge every
    ``hierarchical_period`` rounds. ``gumbel``: optional pre-drawn action
    noise (n_episodes, A, n_steps, n_res+n_bs+n_mt). ``env_backend``:
    ``"fluid"`` (default) / ``"twin"`` / a backend, the one the fleet was
    built with. Returns (fleet, history) with one fleet-mean value per
    episode and metric."""
    backend = get_backend(env_backend)
    dev = fleet.pod_ids.device
    traces = traces.to(dev)
    a, total = traces.shape
    n_eps = total // cfg.n_steps
    schedule = fed.fl_schedule(cfg, n_eps, federated=federated, learn=learn)
    avail = fed.draw_availability(schedule, a, straggler_prob, seed)
    history: Dict[str, list] = {}
    rounds = 0
    for e in range(n_eps):
        rates = traces[:, e * cfg.n_steps:(e + 1) * cfg.n_steps]
        fleet, rollouts, metrics = fleet_episode(
            cfg, fleet, rates, learn=learn,
            gumbel=None if gumbel is None else gumbel[e], backend=backend)
        fl_metrics = fl_transport.fl_zero_metrics(dev)
        if schedule[e]:
            fleet, _, fl_metrics = fl_round(
                cfg, fleet, rollouts,
                torch.as_tensor(avail[e], device=dev), transport=transport)
            rounds += 1
            if rounds % cfg.hierarchical_period == 0 and fleet.n_pods > 1:
                fleet = pod_merge(cfg, fleet)
        names = [*metrics, *fl_metrics]
        vals = torch.stack([*(v.mean() for v in metrics.values()),
                            *fl_metrics.values()])
        for k, v in zip(names, vals.tolist()):   # one transfer per episode
            history.setdefault(k, []).append(v)
    return fleet, {k: np.asarray(v) for k, v in history.items()}


class FleetScan:
    """The graph driver of one run (``train_fleet_scan``): the arguments
    are ``train_fleet_scan``'s. ``run()`` trains ``fleet`` in place and
    returns (fleet, history); ``step()`` runs the next episode alone and
    ``history()`` fetches the history so far. ``capture_s`` is the wall
    time of the graphs' captures and ``graph_launches`` the host's graph
    launches (0 on the CPU)."""

    def __init__(self, cfg: FCPOConfig, fleet: Fleet, traces, *,
                 learn: bool = True, federated: bool = True,
                 straggler_prob: float = 0.0, seed: int = 0,
                 env_backend=None,
                 transport: Optional[TransportConfig] = None, gumbel=None):
        self.cfg, self.fleet, self.learn = cfg, fleet, learn
        self.backend = get_backend(env_backend)
        self.transport = DEFAULT_TRANSPORT if transport is None else transport
        dev = self.dev = fleet.pod_ids.device
        a, total = traces.shape
        n = cfg.n_steps
        self.n_eps = total // n
        self.schedule = fed.fl_schedule(cfg, self.n_eps, federated=federated,
                                        learn=learn)
        avail = fed.draw_availability(self.schedule, a, straggler_prob, seed)
        # the run's inputs, staged on the device once, episode-major
        self.rates = traces[:, :self.n_eps * n].to(dev, torch.float32) \
            .reshape(a, self.n_eps, n).transpose(0, 1).contiguous()
        self.avail = torch.as_tensor(avail, device=dev)
        self.gumbel = None if gumbel is None else \
            gumbel.to(dev, torch.float32).contiguous()
        self.counter = torch.zeros((), dtype=torch.long, device=dev)
        self.episodes = self.rounds = 0        # the host's copies
        f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        self.ep_hist = f32(self.n_eps, len(EPISODE_METRICS))
        self.fl_hist = f32(self.n_eps, len(fl_transport.FL_METRIC_KEYS))
        # the FL round reads the last episode's rollout from here
        self.rollout = Rollout(
            states=f32(a, n, cfg.state_dim),
            actions=torch.zeros(a, n, 3, dtype=torch.long, device=dev),
            logp_old=f32(a, n), rewards=f32(a, n), values_old=f32(a, n))
        noise = (fleet.generator,) if gumbel is None else ()
        self.graphs = (GraphedBody(self._episode, dev, noise),
                       GraphedBody(self._round, dev),
                       GraphedBody(self._merge, dev))

    def _episode(self):
        e = self.counter.view(1)
        out, rollout, metrics = fleet_episode(
            self.cfg, self.fleet, self.rates.index_select(0, e)[0],
            learn=self.learn, backend=self.backend,
            gumbel=(None if self.gumbel is None
                    else self.gumbel.index_select(0, e)[0]))
        if set(metrics) != set(EPISODE_METRICS):
            raise KeyError(f"episode metrics {sorted(metrics)} are not "
                           f"{sorted(EPISODE_METRICS)}")
        copy_into(self.fleet.astate, out.astate)
        copy_into(self.rollout, rollout)
        self.ep_hist.index_copy_(0, e, torch.stack(
            [metrics[k].mean() for k in EPISODE_METRICS])[None])
        self.fl_hist.index_copy_(0, e, torch.stack(
            list(fl_transport.fl_zero_metrics(self.dev).values()))[None])
        self.counter.add_(1)

    def _round(self):
        e = (self.counter - 1).view(1)
        out, _, flm = fl_round(self.cfg, self.fleet, self.rollout,
                               self.avail.index_select(0, e)[0],
                               transport=self.transport)
        copy_into(self.fleet.astate, out.astate)
        copy_into(self.fleet.residuals, out.residuals)
        self.fl_hist.index_copy_(0, e, torch.stack(
            [flm[k] for k in fl_transport.FL_METRIC_KEYS])[None])

    def _merge(self):
        pod_merge(self.cfg, self.fleet)

    @property
    def capture_s(self) -> float:
        return sum(g.capture_s for g in self.graphs)

    @property
    def graph_launches(self) -> int:
        return sum(g.replays for g in self.graphs)

    def step(self) -> None:
        """The next episode, then its FL round and pod merge where the
        schedule (known on the host) has them."""
        episode, fl, merge = self.graphs
        e = self.episodes
        episode()
        self.episodes += 1
        self.fleet.episode += 1
        if self.schedule[e]:
            fl()
            self.rounds += 1
            if (self.rounds % self.cfg.hierarchical_period == 0
                    and self.fleet.n_pods > 1):
                merge()

    def history(self) -> Dict[str, np.ndarray]:
        """The per-episode history of the episodes run so far, in one
        device->host transfer."""
        names = (*EPISODE_METRICS, *fl_transport.FL_METRIC_KEYS)
        hist = torch.cat([self.ep_hist, self.fl_hist], 1)[:self.episodes]
        hist = hist.cpu().numpy()
        return {k: hist[:, i] for i, k in enumerate(names)}

    def run(self):
        with full_float32():
            while self.episodes < self.n_eps:
                self.step()
        return self.fleet, self.history()


def train_fleet_scan(cfg: FCPOConfig, fleet: Fleet, traces, *,
                     learn: bool = True, federated: bool = True,
                     straggler_prob: float = 0.0, seed: int = 0,
                     env_backend=None,
                     transport: Optional[TransportConfig] = None,
                     gumbel=None):
    """The graph driver: episodes over ``traces`` (A, total_steps), an FL
    round every ``fl_every`` episodes (stragglers from
    ``draw_availability(seed)``), a pod merge every ``hierarchical_period``
    rounds — the JAX package's ``train_fleet_scan`` cadence. On the GPU the
    episode, the FL round and the pod merge are CUDA graphs, each captured
    right after its first (eager) step and replayed after that; a capture
    error raises. On the CPU the same bodies run eagerly. ``fleet`` is
    trained in place (its tensors are the graphs' static state) and
    returned, ``fleet.episode`` advanced by the run's episodes. ``gumbel``:
    optional pre-drawn action noise (n_episodes, A, n_steps,
    n_res+n_bs+n_mt); without it the noise comes from ``fleet.generator``
    in the reference driver's order. ``env_backend``: the backend the fleet
    was built with. Float32 products run without TF32 for the run. Returns
    (fleet, history) with one fleet-mean float32 value per episode and
    metric (FL metrics 0 on episodes without a round), fetched in one
    transfer."""
    return FleetScan(cfg, fleet, traces, learn=learn, federated=federated,
                     straggler_prob=straggler_prob, seed=seed,
                     env_backend=env_backend, transport=transport,
                     gumbel=gumbel).run()


def train_fleet(cfg: FCPOConfig, fleet: Fleet, traces, *, learn: bool = True,
                federated: bool = True, straggler_prob: float = 0.0,
                seed: int = 0, env_backend=None,
                transport: Optional[TransportConfig] = None, gumbel=None):
    """The default entry point: delegates to ``train_fleet_scan``, as the
    JAX package's ``train_fleet`` does."""
    return train_fleet_scan(cfg, fleet, traces, learn=learn,
                            federated=federated,
                            straggler_prob=straggler_prob, seed=seed,
                            env_backend=env_backend, transport=transport,
                            gumbel=gumbel)
