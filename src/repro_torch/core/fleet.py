"""Fleet driver: the FCPO loop over a fleet of iAgents.

Port of ``repro.core.fleet`` (the reference driver and its building
blocks). One ``Fleet`` holds stacked per-agent state (A on the leading
axis) and the per-pod base networks (P). Per episode ``fleet_episode``
runs the CRL inner loop for all agents; every ``fl_every`` episodes
``fl_round`` runs Eq. 7 selection -> Algorithm 1 aggregation -> Algorithm 2
head fine-tuning -> buffer resync; every ``hierarchical_period`` rounds
``pod_merge`` averages the pods' base networks. The transport and chaos
layers ride on top, as in the JAX package: asynchronous rounds park
deadline-missed uploads (``fleet.pending``), ``GuardConfig`` picks the
Algorithm 1 statistic, the delta clip and the non-finite rejection, and
``FaultConfig`` injects crashes (``fleet.crash_timer``), byzantine uploads
and pod partitions (``fleet.partition_timer``) from a fault plan drawn on
the host. The defaults run the plain round.

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
optional noise, the fault plan's bits) are staged on the device once and
picked by a device-side episode counter. On the CPU the same bodies run eagerly in the same order;
the two drivers give the same numbers bit for bit.

Randomness: the fleet carries a ``torch.Generator`` (parameter init and
action noise) and, once a run draws byzantine ``noise``, a second one
seeded by ``faults.seed`` (``fault_generator``), so that a run split into
calls draws what the uninterrupted run draws. The drivers also take both
as pre-drawn inputs (``gumbel``, ``byz_noise``), the seam the parity tests
use to replay the JAX package's draws. ``rng`` holds the JAX fleet's
per-agent threefry keys as opaque host data, so that a checkpoint passes
between the packages whole; the port never draws from them.

State dtypes: ``fleet_init(..., state_policy=...)`` / ``fleet_cast`` store
the state families at a ``core/dtypes.py`` policy; every path computes in
float32 and stores back at each leaf's dtype. Both drivers take
``episode_offset`` / ``total_episodes``, so that a run resumed from a
checkpoint (``training/checkpoint.py``) draws the uninterrupted run's
stragglers, faults and merge cadence.

Health (``fleet_init(..., health=...)``, the drivers' ``health=``): the
observatory's state (``repro_torch.health``) rides in the fleet and is
advanced inside the episode and FL-round bodies; its per-episode summaries
join the history. A ``metrics_sink`` (anything with ``.append(record)``)
gets one record per episode from either driver; the graph driver copies
each episode's history row to pinned host memory behind the replays and
writes the record once the copy has landed, so that the stream adds no
host sync per episode. Without health and sink both drivers run exactly
as before.

Tracing (the drivers' ``tracer=``, a ``repro_torch.obs.trace.Tracer``):
the reference driver takes host spans around its sampled episodes, rounds
and merges; the graph driver's bodies open span sites (``episode``,
``fl_round`` and ``fl_round``'s phases, ``pod_merge``), which on the card
are ``span_stamp`` nodes of its graphs reading the episode counter and
the sampling period from device memory, and on the CPU host spans. A
traced run computes the untraced run's numbers bit for bit; without a
tracer the bodies dispatch exactly the untraced ops.

Meshes (``fleet_init(..., mesh=...)``, the drivers' ``mesh=``): on a
``torch.distributed`` device mesh (``launch/mesh.py``) the fleet carries a
``Placement`` and each rank holds the agents ``agent_spec`` gives it and
the pods ``pod_spec`` gives it. Everything per agent stays local (the
episode, K1, K2, K3); the FL round's cross-agent steps go through the
collectives of ``distributed/sharding.py``: Eq. 7 ranks the all-gathered
utilities, Algorithm 1's segment sums are partial sums all-reduced over
the ranks, the robust statistics, medians and pod merge read gathered
rows, and the counters and episode means are world reductions. The inputs
(traces, availability and fault bits, pre-drawn noise) are the whole
fleet's and sliced by ``agent_batch_spec``; the fleet's generators draw
the whole fleet's noise on every rank and keep the rank's rows, so agent
i's draws do not depend on the world size. A rank's agents are split only
where A divides the mesh; otherwise every rank holds every agent and the
sums stay local. On a mesh the collectives run at every world size, one
included. On the card the graph driver captures them (NCCL); a gloo mesh
cannot be captured, and the graph driver refuses it there.
"""
from __future__ import annotations

from collections import deque
from contextlib import nullcontext
import copy
from dataclasses import dataclass, fields, is_dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core import dtypes as dtp
from repro_torch.core import env as env_mod
from repro_torch.core import federated as fed
from repro_torch.core.agent import (ActionMask, AgentPolicy, agent_init,
                                    full_mask, params_from_numpy,
                                    params_to_numpy, policy_cast,
                                    tensors_from_numpy)
from repro_torch.core.backends import FLUID, TwinEnvState, get_backend
from repro_torch.core.buffer import (DiversityBuffer, buffer_cast,
                                     buffer_diversity_mean, buffer_init,
                                     buffer_resync)
from repro_torch.core.crl import EPISODE_METRICS, AgentState, crl_episode
from repro_torch.core.graphs import GraphedBody, copy_into, full_float32
from repro_torch.core.ppo import Rollout, agent_opt_init, finetune_heads
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import (agent_allgather,
                                              agent_allreduce, agent_slice,
                                              pod_allgather, pod_slice)
from repro_torch.fl import staleness as fl_stale
from repro_torch.fl import transport as fl_transport
from repro_torch.fl.codec import codec_roundtrip, residuals_init
from repro_torch.fl.transport import DEFAULT_TRANSPORT, TransportConfig
from repro_torch.health import (HEALTH_METRIC_KEYS, HealthConfig,
                                HealthState, attribution_scores,
                                episode_summaries, health_init,
                                update_episode, update_round)
from repro_torch.health.drift import DriftState
from repro_torch.health.sketch import P2State
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience import faults as rfaults
from repro_torch.resilience.faults import FaultConfig
from repro_torch.resilience.guards import (DEFAULT_GUARDS, GuardConfig,
                                           clip_deltas, finite_mask)
from repro_torch.sim.state import SimState


@dataclass(frozen=True)
class Placement:
    """Where a meshed fleet lives: the ``mesh``, the whole fleet's
    ``n_agents`` / ``n_pods``, this rank's ``agents`` and ``pods`` ranges
    (from ``agent_spec`` on (A, ...) and ``pod_spec`` on (P, ...)), and
    the process groups of the collectives: ``agent_group`` holds each
    agent once (None where agents are replicated over the ranks),
    ``pod_group`` each pod once, ``world`` every rank. At one rank the
    world holds each agent and pod once, and is both groups."""
    mesh: Any
    n_agents: int
    n_pods: int
    agents: slice
    pods: slice
    agent_group: Any
    pod_group: Any
    world: Any
    rank: int
    world_size: int

    @property
    def agents_split(self) -> bool:
        """The ranks partition the agents (at one rank, trivially)."""
        return self.agent_group is not None


def _axes_group(mesh, axes):
    """The process group of this rank's ranks along ``axes`` (the other
    coordinates fixed), in the order of the shards along them."""
    sizes = shd.axis_sizes(mesh)
    if all(sizes[a] == 1 for a in sizes if a not in axes):
        return dist.group.WORLD
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh.permute([names.index(a) for a in names
                               if a not in axes]
                              + [names.index(a) for a in axes])
    rows = ranks.reshape(-1, ranks.shape[-len(axes):].numel()).tolist()
    group, _ = dist.new_subgroups_by_enumeration(rows)
    return group


def fleet_placement(mesh, n_agents: int, n_pods: int) -> Placement:
    """This rank's placement of a fleet of ``n_agents`` agents in
    ``n_pods`` pods on ``mesh`` (a ``DeviceMesh``; every rank calls it:
    groups over several axes are created collectively)."""
    sizes = shd.axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    world_size = dist.get_world_size()

    def part(n, spec):
        axes = shd.spec_axes(spec)
        if not axes:
            return slice(0, n), (dist.group.WORLD if world_size == 1
                                 else None)
        idx, k = 0, 1
        for a in axes:
            idx, k = idx * sizes[a] + coord[a], k * sizes[a]
        m = n // k
        return slice(idx * m, (idx + 1) * m), _axes_group(mesh, axes)
    agents, agent_group = part(n_agents, shd.agent_spec((n_agents,), mesh))
    pods, pod_group = part(n_pods, shd.pod_spec((n_pods,), mesh))
    return Placement(mesh, n_agents, n_pods, agents, pods, agent_group,
                     pod_group, dist.group.WORLD, dist.get_rank(),
                     world_size)


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
    pending: fl_stale.PendingDeltas      # parked async uploads
    crash_timer: torch.Tensor         # (A,) int32 episodes left down
    partition_timer: torch.Tensor     # (P,) int32 merges left partitioned
    generator: torch.Generator
    n_pods: int
    rng: np.ndarray                   # (A, 2) uint32 JAX keys, host, opaque
    episode: int = 0
    fault_generator: Optional[torch.Generator] = None   # byzantine noise
    health: Optional[HealthState] = None   # the observatory's state, (A, ...)
    placement: Optional[Placement] = None  # a meshed fleet's; None: whole

    def replace(self, **kw) -> "Fleet":
        return replace(self, **kw)


def _restacked(policy: AgentPolicy, params) -> AgentPolicy:
    """A copy of ``policy`` holding ``params`` (any leading size)."""
    new = copy.deepcopy(policy)
    for name, t in params.items():
        mod, leaf = name.rsplit(".", 1)
        old = getattr(new.get_submodule(mod), leaf)
        setattr(new.get_submodule(mod), leaf,
                torch.nn.Parameter(t, requires_grad=old.requires_grad))
    return new


def _map_fleet(fleet: Fleet, on_agents, on_pods, on_rng, **kw) -> Fleet:
    """``fleet`` with ``on_agents`` applied to every agent-leading tensor,
    ``on_pods`` to every pod-leading one and ``on_rng`` to the host keys
    (in one fixed order on every rank, as collectives need); ``kw``
    replaces fields."""
    a = fleet.astate
    agents = lambda t: dtp.tree_map(on_agents, t)
    astate = AgentState(
        _restacked(a.policy, agents({k: v.detach() for k, v in
                                     a.policy.params().items()})),
        agents(a.opt), agents(a.buffer), agents(a.env_state))
    base = _restacked(fleet.base, dtp.tree_map(on_pods, {
        k: v.detach() for k, v in fleet.base.params().items()}))
    return fleet.replace(
        astate=astate, base=base, env_params=agents(fleet.env_params),
        masks=agents(fleet.masks), group_ids=agents(fleet.group_ids),
        pod_ids=agents(fleet.pod_ids), bandwidth=agents(fleet.bandwidth),
        speeds=agents(fleet.speeds), residuals=agents(fleet.residuals),
        pending=agents(fleet.pending),
        crash_timer=agents(fleet.crash_timer),
        partition_timer=on_pods(fleet.partition_timer),
        health=None if fleet.health is None else agents(fleet.health),
        rng=on_rng(fleet.rng), **kw)


def fleet_shard(fleet: Fleet, place: Placement) -> Fleet:
    """This rank's slice of a whole fleet (the rows ``place`` gives it, as
    copies); the generators are the whole fleet's."""
    if fleet.placement is not None:
        raise ValueError("fleet_shard: the fleet is already placed")
    if int(fleet.pod_ids.shape[0]) != place.n_agents:
        raise ValueError(f"fleet_shard: a fleet of "
                         f"{int(fleet.pod_ids.shape[0])} agents, a placement "
                         f"of {place.n_agents}")
    return _map_fleet(fleet, lambda t: agent_slice(t, place).clone(),
                      lambda t: pod_slice(t, place).clone(),
                      lambda r: agent_slice(r, place).copy(), placement=place)


def fleet_gather(fleet: Fleet) -> Fleet:
    """The whole fleet of a meshed one, assembled on every rank from the
    ranks' slices (collectives: every rank calls it); a whole fleet is
    returned as it is."""
    place = fleet.placement
    if place is None:
        return fleet
    dev = fleet.pod_ids.device

    def rng(r):
        keys = agent_allgather(torch.as_tensor(r.astype(np.int64),
                                               device=dev), place)
        return keys.cpu().numpy().astype(np.uint32)
    return _map_fleet(fleet, lambda t: agent_allgather(t, place),
                      lambda t: pod_allgather(t, place), rng, placement=None)


def fleet_shardings(fleet: Fleet, mesh) -> Dict[str, Any]:
    """The specs of the fleet's leaves on ``mesh``, in ``fleet_to_numpy``'s
    layout: agent-stacked leaves by ``agent_spec``, the per-pod base
    networks and partition timer by ``pod_spec``, the episode counter
    replicated (the JAX package's ``fleet_shardings``). Leading sizes are
    the whole fleet's, whatever rows this rank holds."""
    place = fleet.placement
    n_a = int(fleet.pod_ids.shape[0]) if place is None else place.n_agents
    n_p = fleet.n_pods
    spec = lambda fn, n: lambda x: fn((n,) + tuple(np.shape(x)[1:]), mesh)
    agent, pod = spec(shd.agent_spec, n_a), spec(shd.pod_spec, n_p)

    def walk(node, fn):
        if isinstance(node, dict):
            return {k: walk(v, fn) for k, v in node.items()}
        return fn(node)
    tree = fleet_to_numpy(fleet)
    out = {k: walk(v, agent) for k, v in tree.items()
           if k not in ("base_params", "partition_timer", "episode")}
    out.update(base_params=walk(tree["base_params"], pod),
               partition_timer=pod(tree["partition_timer"]), episode=())
    return out


def _n_agents(fleet: Fleet) -> int:
    """The whole fleet's agent count (this rank's slice may hold fewer)."""
    return (int(fleet.pod_ids.shape[0]) if fleet.placement is None
            else fleet.placement.n_agents)


def agent_keys(seed: int, n_agents: int) -> np.ndarray:
    """Distinct (A, 2) uint32 keys from ``seed``: the ``rng`` leaf of a
    fleet born in the port."""
    return np.random.SeedSequence(seed).generate_state(
        2 * n_agents).reshape(n_agents, 2)


def _assemble(cfg, policy, opt, buffer, env_state, base, env_params, masks,
              speeds, bandwidth, residuals, generator, rng, episode=0,
              pending=None, crash_timer=None, partition_timer=None,
              health=None) -> Fleet:
    n_agents, n_pods = speeds.shape[0], next(base.parameters()).shape[0]
    dev = speeds.device
    group_ids, group_counts = fed.head_group_ids(masks, dev)
    zeros = lambda n: torch.zeros(n, dtype=torch.int32, device=dev)
    return Fleet(
        astate=AgentState(policy, opt, buffer, env_state), base=base,
        env_params=env_params, masks=masks, group_ids=group_ids,
        group_counts=group_counts,
        pod_ids=torch.arange(n_agents, device=dev) % n_pods,
        bandwidth=bandwidth, speeds=speeds, residuals=residuals,
        pending=(fl_stale.pending_init(policy.params()) if pending is None
                 else pending),
        crash_timer=zeros(n_agents) if crash_timer is None else crash_timer,
        partition_timer=(zeros(n_pods) if partition_timer is None
                         else partition_timer),
        generator=generator, n_pods=n_pods, rng=rng, episode=episode,
        health=health)


def fleet_init(cfg: FCPOConfig, n_agents: int, seed: int = 0, *,
               n_pods: int = 1, masks: Optional[ActionMask] = None,
               speeds=None, bandwidth=None, device="cuda", env_backend=None,
               slo_s: Optional[float] = None, state_policy=None,
               health: Optional[HealthConfig] = None, mesh=None) -> Fleet:
    """A fresh fleet: random agents and pod base networks from ``seed``,
    the heterogeneous device mix and link bandwidths drawn from the same
    numpy streams as the reference (``default_rng(0)`` / ``(1)``).
    ``masks`` ((A, n_*) bool per head; default all allowed), ``speeds``
    and ``bandwidth`` ((A,) each, any array) replace those defaults, as
    the reference's keywords do. ``env_backend`` (``"fluid"``, the
    default, ``"twin"`` or a backend) builds ``astate.env_state``: pass
    the same backend to the drivers.
    ``state_policy``: a ``core/dtypes.py`` policy name or ``StatePolicy``
    (``fleet_cast``); None keeps every float leaf float32. ``health``: a
    ``HealthConfig`` attaches the observatory's state (float32 under
    every policy); None keeps the fleet without it. ``mesh``: a
    ``torch.distributed`` device mesh; the whole fleet is built from the
    seed exactly as without it, and this rank keeps its slice
    (``fleet_placement``, ``fleet_shard``)."""
    dev = resolve_device(device)
    backend = get_backend(env_backend)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    policy = agent_init(cfg, n_agents, gen, dev)
    base = agent_init(cfg, 1, gen, dev)
    pod_base = AgentPolicy(cfg, n_pods, dev)
    pod_base.assign({k: v.expand((n_pods,) + v.shape[1:])
                     for k, v in base.params().items()})
    if speeds is None:      # heterogeneous device mix (Orin/NX/AGX/server)
        speeds = np.random.default_rng(0).choice([0.5, 0.75, 1.0, 2.0],
                                                 n_agents)
    if bandwidth is None:
        bandwidth = np.random.default_rng(1).uniform(2.0, 40.0, n_agents)
    speeds, bandwidth = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                         for x in (speeds, bandwidth))
    masks = full_mask(cfg, n_agents, dev) if masks is None else ActionMask(
        *(torch.as_tensor(m, dtype=torch.bool, device=dev)
          for m in (masks.res, masks.bs, masks.mt)))
    # slo_s overrides cfg.slo_s, as the JAX fleet_init's slo_s does
    env_params = env_mod.default_env_params(
        speeds, cfg.slo_s if slo_s is None else slo_s, dev)
    backend.check_env_params(env_params)
    fleet = _assemble(
        cfg, policy, agent_opt_init(policy.params()),
        buffer_init(cfg, n_agents, dev), backend.init(cfg, n_agents, dev),
        pod_base, env_params, masks, speeds,
        bandwidth, residuals_init(policy.params()), gen,
        agent_keys(seed, n_agents))
    fleet = _ensure_health(cfg, fleet, health)
    if state_policy is not None:
        fleet = fleet_cast(fleet, state_policy)
    if mesh is None:
        return fleet
    return fleet_shard(fleet, fleet_placement(mesh, n_agents, n_pods))


def fleet_cast(fleet: Fleet, state_policy) -> Fleet:
    """The fleet with its state families stored at ``state_policy`` (a
    name, a ``StatePolicy`` or None for float32): params and base networks
    (``model``), Adam moments (``opt``), the buffer payload (``buffer``),
    env state and params (``env``), residuals and parked deltas
    (``transport``); the health state stays float32, as in the reference.
    Leaves already at their dtype are kept as they are;
    casting a lean fleet to ``"float32"`` widens it (int8 slots
    dequantized). Build the drivers after casting: their graphs hold the
    fleet's tensors."""
    pol = dtp.get_policy(state_policy)
    a = fleet.astate
    model = dtp.torch_dtype(pol.model)
    opt = {"m": dtp.cast_floats(a.opt["m"], pol.opt),
           "v": dtp.cast_floats(a.opt["v"], pol.opt), "t": a.opt["t"]}
    astate = AgentState(policy_cast(a.policy, model), opt,
                        buffer_cast(a.buffer, pol.buffer),
                        dtp.cast_floats(a.env_state, pol.env))
    return fleet.replace(
        astate=astate, base=policy_cast(fleet.base, model),
        env_params=dtp.cast_floats(fleet.env_params, pol.env),
        residuals=dtp.cast_floats(fleet.residuals, pol.transport),
        pending=replace(fleet.pending, delta=dtp.cast_floats(
            fleet.pending.delta, pol.transport)))


def fleet_state_bytes(fleet: Fleet) -> Dict[str, float]:
    """Storage bytes of the fleet's state by family, plus ``total`` and
    ``per_agent`` (the JAX package's accounting, from shapes and dtypes),
    of the whole fleet: a meshed fleet's slices are equal, so its agent-
    and pod-leading leaves count times the ranks' share of them.
    The port keeps four index leaves int64 where the reference has int32:
    ``buffer.actions`` (buffer), ``env_state.cur_action`` (env),
    ``pod_ids`` and ``group_ids`` (misc)."""
    a = fleet.astate
    ka = _n_agents(fleet) // int(fleet.pod_ids.shape[0])
    kp = fleet.n_pods // int(fleet.partition_timer.shape[0])
    fam = {
        "model": ((a.policy.params(), ka), (fleet.base.params(), kp)),
        "opt": ((a.opt, ka),),
        "buffer": ((a.buffer, ka),),
        "env": (((a.env_state, fleet.env_params), ka),),
        "transport": (((fleet.residuals, fleet.pending), ka),),
        "health": (((), 1) if fleet.health is None else (fleet.health, ka),),
        "misc": (((fleet.masks, fleet.group_ids, fleet.pod_ids,
                   fleet.bandwidth, fleet.speeds, fleet.crash_timer), ka),
                 (fleet.partition_timer, kp)),
    }
    out = {k: float(sum(dtp.tree_bytes(t) * n for t, n in v))
           for k, v in fam.items()}
    out["misc"] += float(fleet.rng.nbytes * ka)
    out["total"] = float(sum(out.values()))
    out["per_agent"] = out["total"] / max(_n_agents(fleet), 1)
    return out


def fleet_device_bytes(fleet: Fleet) -> Dict[int, float]:
    """Bytes of the fleet's tensors by device: by device index for a whole
    fleet (the port runs it on one device, index 0 on the CPU), by rank for
    a meshed one (each rank's slice, all-gathered: every rank calls it).
    The carried keys are host data and not counted."""
    per: Dict[int, float] = {}

    def add(x):
        d = x.device.index or 0
        per[d] = per.get(d, 0.0) + float(x.numel() * x.element_size())
    a = fleet.astate
    dtp.tree_map(add, (a.policy.params(), a.opt, a.buffer, a.env_state,
                       fleet.base.params(),
                       *(getattr(fleet, f.name) for f in fields(fleet)
                         if f.name not in ("astate", "base", "placement"))))
    place = fleet.placement
    if place is None:
        return per
    mine = torch.tensor([sum(per.values())], dtype=torch.float64,
                        device=fleet.pod_ids.device)
    parts = [torch.empty_like(mine) for _ in range(place.world_size)]
    dist.all_gather(parts, mine, group=place.world)
    return {r: float(p.item()) for r, p in enumerate(parts)}


def _numpy_fields(obj):
    """A state dataclass as a dict of numpy arrays (nested for the twin's
    ``sim``; bf16 leaves as raw ``|V2``)."""
    conv = lambda v: _numpy_fields(v) if is_dataclass(v) else dtp.to_numpy(v)
    return {f.name: conv(getattr(obj, f.name)) for f in fields(obj)}


def _from_fields(cls, tree, dev, longs=(), nested=None):
    """``cls`` from a dict of numpy arrays, each leaf at its own dtype
    (``dtp.from_numpy``); ``longs`` name the fields made ``long``,
    ``nested`` maps a field holding a dict to its class."""
    nested = nested or {}

    def conv(name, v):
        if name in nested:
            return _from_fields(nested[name], v, dev)
        t = dtp.from_numpy(v, dev)
        return t.long() if name in longs else t
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
    optionally ``residuals``, ``pending`` (``delta`` tree, ``staleness``,
    ``has``), ``crash_timer``, ``partition_timer``, ``episode``, ``rng``
    (the (A, 2) uint32 keys, else made from ``seed``) and ``health`` (the
    ``HealthState``'s fields, P² and drift states nested). Every leaf
    keeps its dtype (bf16 from raw ``|V2`` or ``uint16`` arrays, int8 buffer
    slots); the index leaves become ``long``. ``seed`` seeds the fleet's
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
    i32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.int32,
                                 device=dev)
    masks = ActionMask(*(torch.tensor(np.asarray(tree["masks"][k]),
                                      dtype=torch.bool, device=dev)
                         for k in ("res", "bs", "mt")))
    pending = tree.get("pending")
    if pending is not None:
        pending = fl_stale.PendingDeltas(
            delta=tensors_from_numpy(pending["delta"], dev),
            staleness=i32(pending["staleness"]),
            has=torch.tensor(np.asarray(pending["has"]), dtype=torch.bool,
                             device=dev))
    timer = lambda k: i32(tree[k]) if k in tree else None
    health = tree.get("health")
    if health is not None:
        health = _from_fields(HealthState, health, dev, nested={
            "reward_p2": P2State, "drift_reward": DriftState,
            "drift_rate": DriftState})
    n_agents = masks.res.shape[0]
    rng = (np.array(tree["rng"], dtype=np.uint32) if "rng" in tree
           else agent_keys(seed, n_agents))
    return _assemble(
        cfg, policy, opt,
        _from_fields(DiversityBuffer, tree["buffer"], dev, longs=("actions",)),
        _env_state_from_numpy(tree["env_state"], dev),
        base, _from_fields(env_mod.EnvParams, tree["env_params"], dev),
        masks, f32(tree["speeds"]), f32(tree["bandwidth"]), residuals, gen,
        rng, episode=int(tree.get("episode", 0)), pending=pending,
        crash_timer=timer("crash_timer"),
        partition_timer=timer("partition_timer"), health=health)


def fleet_to_numpy(fleet: Fleet):
    """The nested-dict numpy form of ``fleet`` (the layout
    ``fleet_from_numpy`` reads; bf16 leaves as raw ``|V2``). The derived
    index leaves and the carried keys are ``training/checkpoint.py``'s to
    add."""
    a = fleet.astate
    np_ = dtp.to_numpy
    return {
        "params": params_to_numpy(a.policy.params()),
        "opt": {"m": params_to_numpy(a.opt["m"]),
                "v": params_to_numpy(a.opt["v"]),
                "t": np_(a.opt["t"])},
        "buffer": _numpy_fields(a.buffer),
        "env_state": _numpy_fields(a.env_state),
        "env_params": _numpy_fields(fleet.env_params),
        "base_params": params_to_numpy(fleet.base.params()),
        "masks": _numpy_fields(fleet.masks),
        "speeds": np_(fleet.speeds),
        "bandwidth": np_(fleet.bandwidth),
        "residuals": params_to_numpy(fleet.residuals),
        "pending": {"delta": params_to_numpy(fleet.pending.delta),
                    "staleness": np_(fleet.pending.staleness),
                    "has": np_(fleet.pending.has)},
        "crash_timer": np_(fleet.crash_timer),
        "partition_timer": np_(fleet.partition_timer),
        "episode": fleet.episode,
        **({} if fleet.health is None
           else {"health": _numpy_fields(fleet.health)}),
    }


def fleet_episode(cfg: FCPOConfig, fleet: Fleet, rates: torch.Tensor,
                  learn: bool = True, gumbel=None, backend=FLUID,
                  health: Optional[HealthConfig] = None):
    """One CRL episode for all agents. rates: (A, n_steps); gumbel:
    optional pre-drawn (A, n_steps, ``noise_width(cfg)``) action noise;
    ``backend``: the environment, the one the fleet was built with.
    ``health``: advance the fleet's health state through the episode's
    per-interval telemetry and add its summaries to the metrics
    (``HEALTH_METRIC_KEYS``). A meshed fleet draws the whole fleet's noise
    and keeps its rows (``sample_actions``). Returns (fleet, rollouts,
    per-agent metrics)."""
    if health is not None and fleet.health is None:
        raise ValueError("fleet_episode(health=...) needs a fleet with "
                         "health state (fleet_init(..., health=...))")
    astate, rollouts, metrics = crl_episode(
        cfg, fleet.env_params, fleet.astate, rates, fleet.masks, learn,
        backend=backend, gumbel=gumbel, generator=fleet.generator,
        place=fleet.placement,
        health=health is not None)
    hstate = fleet.health
    if health is not None:
        tele = metrics.pop("_health")
        hstate = update_episode(health, hstate, tele["reward"],
                                tele["miss"], tele["probs"], tele["rate"])
        metrics.update(episode_summaries(health, hstate))
    return fleet.replace(astate=astate, episode=fleet.episode + 1,
                         health=hstate), rollouts, metrics


def fl_round(cfg: FCPOConfig, fleet: Fleet, rollouts, available=None,
             transport: Optional[TransportConfig] = None,
             guards: Optional[GuardConfig] = None,
             faults: Optional[FaultConfig] = None, byzantine=None,
             byz_noise=None, generator=None,
             health: Optional[HealthConfig] = None, trace=None):
    """One federated round: uplink model -> Eq. 7 selection -> (lossy codec)
    -> Alg. 1 aggregation -> Alg. 2 head fine-tuning -> buffer moment
    resync.

    ``available`` ((A,) bool) masks out stragglers. With the float32 codec
    in synchronous rounds the server's reconstruction is the client params
    themselves and the codec is skipped; otherwise clients encode ``params
    - base`` per leaf with error feedback (the K2 kernel on the GPU), and
    only selected contributors are seen through the wire. ``transport``
    with ``async_rounds``: a selected client that misses the deadline parks
    its decoded delta in ``fleet.pending``, and parked deltas join later
    rounds discounted. ``guards`` picks the Algorithm 1 statistic, the
    per-leaf delta clip and the non-finite rejection (``fl_rejected``).
    ``faults`` with ``byzantine`` ((A,) bool) corrupts those agents'
    decoded deltas after the codec; the ``noise`` mode reads ``byz_noise``
    ({name: leaf-shaped noise}) or draws from ``generator``. ``health``
    scores every aggregated client's delta (``attribution_scores``: on
    the wire contributions before the clip, or, on the plain path, on
    ``params - base`` read on the side, which leaves the plain numerics
    alone) into the fleet's suspicion EMA, a rejected contribution at
    suspicion 1; with ``guards.susp_threshold`` > 0 the previous round's
    EMA also gates Eq. 7 selection. ``trace``: span sites
    (``repro_torch.obs.trace``) of the round's phases ``fl/uplink``,
    ``fl/encode`` (where the codec runs; the K2 wrapper's
    ``kernel/delta_codec`` inside it), ``fl/aggregate`` and
    ``fl/finetune``; None records nothing. Returns
    (fleet, sel (A,) bool aggregation mask, fl_metrics of 0-dim tensors,
    ``FL_METRIC_KEYS``)."""
    transport = DEFAULT_TRANSPORT if transport is None else transport
    guards = DEFAULT_GUARDS if guards is None else guards
    if health is not None and fleet.health is None:
        raise ValueError("fl_round(health=...) needs a fleet with health "
                         "state (fleet_init(..., health=...))")
    byz_on = faults is not None and faults.byzantine_active
    policy, astate = fleet.astate.policy, fleet.astate
    place = fleet.placement
    params = {k: v.detach() for k, v in policy.params().items()}
    # the whole (P, ...) base networks: every rank's agents span every pod
    base = {k: pod_allgather(v.detach(), place)
            for k, v in fleet.base.params().items()}
    dev = fleet.pod_ids.device
    a = fleet.pod_ids.shape[0]
    count = lambda m: agent_allreduce(m.sum().to(torch.float32), place)
    zero = lambda: torch.zeros((), device=dev)
    if available is None:
        available = torch.ones(a, dtype=torch.bool, device=dev)
    if byz_on and byzantine is None:
        byzantine = torch.zeros(a, dtype=torch.bool, device=dev)
    pending, rejected = fleet.pending, None
    # parked uploads are validated before anything reads them (selection
    # included): a poisoned parked delta must not make its owner selectable
    if guards.reject_nonfinite and transport.async_rounds:
        pending, rejected = fl_stale.validate_pending(pending, place)

    # --- communication model: static payload sizes, per-agent links
    with obs_trace.span_of(trace, "fl/uplink"):
        up_bytes = fl_transport.agent_payload_bytes(params.values(),
                                                    transport)
        full_bytes = fl_transport.full_param_bytes(params.values())
        down_bytes = fl_transport.downlink_bytes(
            transport, _n_agents(fleet), fleet.n_pods, up_bytes, full_bytes)
        uplink_s = fl_transport.uplink_seconds(up_bytes, fleet.bandwidth)
        on_time = fl_transport.on_time_mask(uplink_s, transport.deadline_s)
        fresh_ok = available & on_time

    # --- Eq. 7 selection. Sync rounds: a slow link drops out. Async rounds:
    # slow but available clients stay selectable (they park), and so do
    # parked deltas whose owner is offline now.
    stats = fed.ClientStats(
        mem_avail=torch.clamp(1.0 - astate.env_state.pre_q.float()
                              / fleet.env_params.queue_cap.float(), 0, 1),
        compute_avail=torch.clamp(fleet.speeds / 2.0, 0, 1),
        diversity=buffer_diversity_mean(astate.buffer),
        bandwidth=fleet.bandwidth,
        available=(available | pending.has if transport.async_rounds
                   else fresh_ok))
    # clients the previous round scored suspect lose their slot to the next
    # candidate
    sel = fed.select_clients(
        cfg, stats, suspicion=None if health is None else fleet.health.susp,
        susp_threshold=guards.susp_threshold, place=place)
    with torch.no_grad():
        head_losses = fed.per_head_losses(cfg, params, rollouts, fleet.masks)

    # --- the server-side view of each client's parameters
    residuals, transmitted, stale_used, clipped = fleet.residuals, sel, \
        None, None
    # lossless, nothing parked, corrupted or clipped: base + delta == params
    plain = transport.plain and not byz_on and guards.clip_factor <= 0
    if plain:
        recon = contrib = params
        sel_agg = sel
    if not plain or health is not None:
        # deltas are formed in float32 against float32 base networks,
        # whatever the stored dtypes
        base_g = {k: b[fleet.pod_ids].float() for k, b in base.items()}
    if not plain:
        with obs_trace.span_of(trace, "fl/encode"):
            delta = {k: params[k].float() - base_g[k] for k in params}
            with obs_trace.bind(trace):     # K2's kernel/delta_codec span
                decoded, res_next = codec_roundtrip(delta, fleet.residuals,
                                                    transport)
            if byz_on:
                # corrupted in transit, after the client committed its
                # error feedback: the server sees garbage, the client
                # stays consistent
                decoded = rfaults.corrupt_deltas(faults, decoded, byzantine,
                                                 noise=byz_noise,
                                                 generator=generator,
                                                 place=place)
            if transport.async_rounds:
                w_stale = fl_stale.stale_weights(pending,
                                                 transport.staleness_decay)
                contrib = fl_stale.merge_contributions(decoded, pending,
                                                       fresh_ok, w_stale)
                sel_agg = sel & (fresh_ok | pending.has)
                parked = sel & available & ~on_time
                consumed = sel & pending.has & ~fresh_ok
                fresh_sent = sel & fresh_ok
                transmitted = fresh_sent | parked
                pending = fl_stale.update_pending(pending, decoded, parked,
                                                  consumed, fresh_sent)
                stale_used = count(consumed)
            else:
                contrib, sel_agg = decoded, sel  # selection needed on-time
    health_rej = None            # rejected contributions: suspicion 1
    if guards.reject_nonfinite:
        # a client NaN'd by its own training, or garbage on the wire, is
        # dropped from aggregation
        ok = finite_mask(contrib)
        health_rej = sel_agg & ~ok
        n_bad = count(health_rej)
        rejected = n_bad if rejected is None else rejected + n_bad
        sel_agg = sel_agg & ok
    if health is not None:
        # scored before the clip, which would erase the magnitude evidence;
        # on the plain path the deltas against the downlinked base exist
        # only to be scored
        scored = contrib if not plain else \
            {k: params[k].float() - base_g[k] for k in params}
        susp_new = attribution_scores(scored, sel_agg, place)["susp"]
    if not plain:
        if guards.clip_factor > 0:
            contrib, clipped = clip_deltas(contrib, sel_agg,
                                           guards.clip_factor, place)
        # only selected contributors are seen through the wire; everyone
        # else enters aggregation with their TRUE params
        rows = lambda m, x: m.reshape((-1,) + (1,) * (x.dim() - 1))
        recon = {k: torch.where(rows(sel_agg, params[k]),
                                base_g[k] + contrib[k], params[k])
                 for k in params}
        # error feedback commits only for deltas that went (or, parked,
        # will go) over the wire; stored at the residuals' dtype
        residuals = {k: torch.where(rows(transmitted, r),
                                    res_next[k].to(r.dtype), r)
                     for k, r in fleet.residuals.items()}

    # Algorithm 1 in float32; the new params and base networks are stored
    # at their dtypes (identities under float32)
    with obs_trace.span_of(trace, "fl/aggregate"):
        new_params, new_base = fed.aggregate(
            cfg, dtp.tree_f32(recon), dtp.tree_f32(base), sel_agg,
            head_losses, fleet.group_ids, fleet.group_counts, fleet.pod_ids,
            fleet.n_pods, method=guards.agg, trim_frac=guards.trim_frac,
            place=place)
        new_params = dtp.tree_cast_like(new_params, params)
        new_base = dtp.tree_cast_like({k: pod_slice(v, place)
                                       for k, v in new_base.items()}, base)
    # Algorithm 2: local action-head fine-tuning on local experiences
    with obs_trace.span_of(trace, "fl/finetune"):
        new_params, opt = finetune_heads(cfg, new_params, astate.opt,
                                         rollouts, fleet.masks)
    policy.assign(new_params)
    fleet.base.assign(new_base)
    # FL-round cadence resyncs the buffers' streaming moments
    astate = AgentState(policy, opt, buffer_resync(astate.buffer),
                        astate.env_state)

    n_up = count(transmitted)
    fl_metrics = {
        "fl_payload_bytes": n_up * up_bytes + down_bytes,
        "fl_uplink_s": agent_allgather(torch.where(transmitted, uplink_s,
                                                   0.0), place).sum()
        / torch.clamp_min(n_up, 1.0),
        "fl_missed": count(available & ~on_time),
        "fl_stale_used": zero() if stale_used is None else stale_used,
        "fl_rejected": zero() if rejected is None else rejected,
        "fl_clipped": zero() if clipped is None else clipped,
    }
    new_health = fleet.health
    if health is not None:
        scored_sel = sel_agg
        if health_rej is not None:   # garbage shipped: maximal evidence
            susp_new = torch.where(health_rej, 1.0, susp_new)
            scored_sel = sel_agg | health_rej
        new_health = update_round(health, fleet.health, susp_new, scored_sel)
    return fleet.replace(astate=astate, residuals=residuals,
                         pending=pending, health=new_health), sel_agg, \
        fl_metrics


def pod_merge(cfg: FCPOConfig, fleet: Fleet, partition=None,
              faults: Optional[FaultConfig] = None) -> Fleet:
    """Hierarchical cross-pod exchange (cloud tier): the pods' base
    networks are averaged and redistributed (in place). With partition
    faults, ``partition`` ((P,) bool) holds this merge's fresh draws: a
    newly partitioned pod stays off the cloud tier for
    ``faults.partition_merges`` merges, then rejoins. A meshed fleet
    gathers the base networks (and the timers), mixes the whole, and keeps
    its pods; ``partition`` holds every pod's draw."""
    place = fleet.placement
    local = lambda tree: {k: pod_slice(v, place) for k, v in tree.items()}
    base = {k: pod_allgather(v.detach(), place)
            for k, v in fleet.base.params().items()}
    if faults is None or not faults.partition_active or partition is None:
        fleet.base.assign(local(fed.merge_pods(base)))
        return fleet
    timer = torch.clamp_min(pod_allgather(fleet.partition_timer, place) - 1,
                            0)
    timer = torch.where(partition, faults.partition_merges, timer)
    fleet.base.assign(local(fed.merge_pods(base, timer == 0)))
    return fleet.replace(partition_timer=pod_slice(timer, place))


def _normalize_chaos(faults, guards):
    """An inactive fault config is None; a None guard config the
    default."""
    if faults is not None and not faults.active:
        faults = None
    return faults, DEFAULT_GUARDS if guards is None else guards


def _ensure_health(cfg: FCPOConfig, fleet: Fleet,
                   health: Optional[HealthConfig]) -> Fleet:
    """Fresh health state for a fleet without it (one restored from a
    checkpoint taken without health) when ``health`` is given, attached in
    place; a fleet that carries state keeps it."""
    if health is not None and fleet.health is None:
        fleet.health = health_init(health, int(fleet.pod_ids.shape[0]),
                                   cfg.n_res + cfg.n_bs + cfg.n_mt,
                                   fleet.pod_ids.device)
    return fleet


def _split_health(metrics):
    """(the episode metrics, the health summaries) of ``fleet_episode``'s
    metrics, each in its own order."""
    return ({k: v for k, v in metrics.items() if k not in HEALTH_METRIC_KEYS},
            {k: metrics[k] for k in HEALTH_METRIC_KEYS if k in metrics})


def _episode_means(metrics, ran, place=None):
    """Per-episode fleet values: the mean, or, with crashes, the mean over
    the agents that ran (a frozen agent's episode did not happen). A
    meshed fleet's (A_local,) values are all-gathered in one collective
    first, so that every rank reduces the whole fleet's values in the
    meshless order."""
    if place is not None and metrics:
        cols = list(metrics.values()) + ([] if ran is None else [ran])
        whole = agent_allgather(torch.stack([c.to(torch.float32)
                                             for c in cols], 1), place)
        rows = whole.t().contiguous()    # each metric's values contiguous
        metrics = dict(zip(metrics, rows.unbind(0)))
        ran = None if ran is None else rows[-1] > 0
    if ran is None:
        return [v.mean() for v in metrics.values()]
    w = ran.to(torch.float32)
    d = torch.clamp_min(w.sum(), 1.0)
    return [(v * w).sum() / d for v in metrics.values()]


def _fault_generator(fleet: Fleet, faults, byz_noise):
    """The generator of the byzantine ``noise`` mode when no noise is
    given, else None. It lives in the fleet (``fleet.fault_generator``,
    seeded by ``faults.seed`` on first use), so a run split into driver
    calls continues its draws where the last call stopped."""
    if (faults is None or not faults.byzantine_active
            or faults.byzantine_mode != "noise" or byz_noise is not None):
        return None
    if fleet.fault_generator is None:
        gen = torch.Generator(device=fleet.pod_ids.device)
        gen.manual_seed(faults.seed)
        fleet.fault_generator = gen
    return fleet.fault_generator


def _run_plan(cfg: FCPOConfig, fleet: Fleet, n_eps: int, learn, federated,
              straggler_prob, seed, faults, episode_offset, total_episodes):
    """The host-side plan of a driver call over the absolute episodes
    ``[episode_offset, episode_offset + n_eps)`` of a run of
    ``total_episodes``: the FL schedule, availability bits and fault plan
    drawn over the whole run and sliced to the call, and the FL rounds run
    before it (the merge cadence's counter)."""
    total = (episode_offset + n_eps if total_episodes is None
             else total_episodes)
    if total < episode_offset + n_eps:
        raise ValueError(f"total_episodes={total} < episode_offset="
                         f"{episode_offset} + {n_eps} trace episodes")
    a = _n_agents(fleet)
    schedule = fed.fl_schedule(cfg, total, federated=federated, learn=learn)
    avail = fed.draw_availability(schedule, a, straggler_prob, seed)
    plan = rfaults.draw_fault_plan(schedule, a, fleet.n_pods, faults)
    sl = slice(episode_offset, episode_offset + n_eps)
    # drawn for the whole fleet, each rank keeps its agents' bits (the pod
    # merge reads every pod's)
    place = fleet.placement
    return (schedule[sl], agent_slice(avail[sl], place, 1),
            rfaults.FaultPlan(agent_slice(plan.crash[sl], place, 1),
                              agent_slice(plan.byzantine[sl], place, 1),
                              plan.partition[sl]),
            int(schedule[:episode_offset].sum()))


def _placed(fleet: Fleet, mesh) -> Fleet:
    """``fleet`` on ``mesh``: a whole fleet is placed there (this rank's
    slice); a meshed fleet must already be on it."""
    if mesh is None:
        return fleet
    if fleet.placement is None:
        return fleet_shard(fleet, fleet_placement(mesh, _n_agents(fleet),
                                                  fleet.n_pods))
    if fleet.placement.mesh is not mesh:
        raise ValueError("the fleet is placed on another mesh than the "
                         "driver's mesh=")
    return fleet


def train_fleet_reference(cfg: FCPOConfig, fleet: Fleet, traces, *,
                          learn: bool = True, federated: bool = True,
                          straggler_prob: float = 0.0, seed: int = 0,
                          env_backend=None,
                          transport: Optional[TransportConfig] = None,
                          guards: Optional[GuardConfig] = None,
                          faults: Optional[FaultConfig] = None,
                          gumbel=None, byz_noise=None,
                          episode_offset: int = 0,
                          total_episodes: Optional[int] = None,
                          metrics_sink=None,
                          health: Optional[HealthConfig] = None,
                          tracer=None, mesh=None):
    """The Python-loop driver: episodes over ``traces`` (A, total_steps),
    an FL round every ``fl_every`` episodes (stragglers from
    ``draw_availability(seed)``, the reference's stream), a pod merge every
    ``hierarchical_period`` rounds. ``guards`` / ``faults``: the chaos
    layer (``draw_fault_plan`` from ``faults.seed``, the reference's plan):
    a crashed agent's episode and round are undone and it sits out the
    round, partitioned pods skip merges. ``episode_offset`` /
    ``total_episodes``: ``traces`` holds the absolute episodes from
    ``episode_offset`` of a run of ``total_episodes`` (default: this
    call's end), so that the schedule, the straggler and fault draws and
    the merge cadence are the uninterrupted run's. ``gumbel``: optional
    pre-drawn action noise (n_episodes, A, n_steps,
    ``agent.noise_width(cfg)``);
    ``byz_noise``: optional byzantine noise, {name: (n_episodes, A, ...)},
    both over this call's episodes. ``env_backend``: ``"fluid"`` (default)
    / ``"twin"`` / a backend, the one the fleet was built with.
    ``health``: a ``HealthConfig``; the fleet's health state (fresh if it
    has none) is advanced every episode and round, and its summaries join
    the history. ``metrics_sink``: gets ``{"episode": absolute episode,
    **the episode's history values}`` as each episode ends. ``tracer``: a
    ``repro_torch.obs.trace.Tracer``; host spans ``episode``, ``fl_round``
    and ``pod_merge`` on every ``tracer.span_sample_every``-th absolute
    episode, each ending when the card has finished its work. ``mesh``: a
    device mesh (``launch/mesh.py``): a whole ``fleet`` is placed on it
    (``fleet_shard``), a meshed one must be on it; the inputs (``traces``,
    ``gumbel``, ``byz_noise``) are the whole fleet's, each rank keeps its
    agents', and the sink is written by rank 0. A meshed fleet runs on its
    own placement. Returns (fleet, history) with one fleet-mean value per
    episode and metric (with crashes, the mean over the agents that
    ran)."""
    backend = get_backend(env_backend)
    faults, guards = _normalize_chaos(faults, guards)
    fleet = _ensure_health(cfg, _placed(fleet, mesh), health)
    place = fleet.placement
    dev = fleet.pod_ids.device
    traces = agent_slice(traces, place).to(dev)
    gumbel = None if gumbel is None else agent_slice(gumbel, place, 1)
    byz_noise = None if byz_noise is None else \
        {k: agent_slice(v, place, 1) for k, v in byz_noise.items()}
    if place is not None and place.rank != 0:
        metrics_sink = None
    n_eps = traces.shape[1] // cfg.n_steps
    schedule, avail, plan, rounds = _run_plan(
        cfg, fleet, n_eps, learn, federated, straggler_prob, seed, faults,
        episode_offset, total_episodes)
    crash_on = faults is not None and faults.crash_active
    byz_on = faults is not None and faults.byzantine_active
    fault_gen = _fault_generator(fleet, faults, byz_noise)
    bits = lambda x: torch.as_tensor(x, device=dev)
    history: Dict[str, list] = {}

    def hspan(name, e):     # a sampled host span, no-op without a tracer
        if tracer is None or not tracer.sampled(episode_offset + e):
            return nullcontext()
        return obs_trace.host_span(tracer, name, dev)

    for e in range(n_eps):
        rates = traces[:, e * cfg.n_steps:(e + 1) * cfg.n_steps]
        prev = rfaults.snapshot_astate(fleet.astate) if crash_on else None
        with hspan("episode", e):
            fleet, rollouts, metrics = fleet_episode(
                cfg, fleet, rates, learn=learn,
                gumbel=None if gumbel is None else gumbel[e],
                backend=backend, health=health)
        ran = None
        if crash_on:
            fleet, ran, down = rfaults.apply_crashes(faults, prev, fleet,
                                                     bits(plan.crash[e]),
                                                     place)
        fl_metrics = fl_transport.fl_zero_metrics(dev)
        if schedule[e]:
            av = bits(avail[e])
            if crash_on:
                av = av & ~down
                pre_round = rfaults.snapshot_astate(fleet.astate)
            with hspan("fl_round", e):
                fleet, _, fl_metrics = fl_round(
                    cfg, fleet, rollouts, av, transport=transport,
                    guards=guards, faults=faults,
                    byzantine=bits(plan.byzantine[e]) if byz_on else None,
                    byz_noise=(None if byz_noise is None else
                               {k: v[e] for k, v in byz_noise.items()}),
                    generator=fault_gen, health=health)
            if crash_on:
                # a down agent is offline: it does not receive the round's
                # model (it rejoins later by the step-① warm start)
                fleet = fleet.replace(astate=rfaults.freeze_astate(
                    down, pre_round, fleet.astate))
            rounds += 1
            if rounds % cfg.hierarchical_period == 0 and fleet.n_pods > 1:
                with hspan("pod_merge", e):
                    fleet = pod_merge(cfg, fleet, bits(plan.partition[e]),
                                      faults)
        ep_m, health_m = _split_health(metrics)
        names = [*ep_m, *fl_metrics, *health_m]
        vals = torch.stack([*_episode_means(ep_m, ran, place),
                            *fl_metrics.values(),
                            *_episode_means(health_m, ran, place)]).tolist()
        for k, v in zip(names, vals):            # one transfer per episode
            history.setdefault(k, []).append(v)
        if metrics_sink is not None:
            metrics_sink.append({"episode": episode_offset + e,
                                 **dict(zip(names, vals))})
    return fleet, {k: np.asarray(v) for k, v in history.items()}


# episodes the graph driver's stream may hold in flight (``SinkTap``)
SINK_DEPTH = 64

# the graph driver's span sites, (name, Chrome category)
FLEET_SITES = (("episode", "phase"), ("fl_round", "phase"),
               ("fl/uplink", "phase"), ("fl/encode", "phase"),
               ("kernel/delta_codec", "kernel"), ("fl/aggregate", "phase"),
               ("fl/finetune", "phase"), ("pod_merge", "phase"))


class SinkTap:
    """The graph driver's stream: after each episode, its rows of the
    device-side history (``rows``, each (n_eps, width)) are copied to a
    ring of pinned host buffers behind the replays, with a CUDA event
    after them; a record goes to ``sink`` once its event has completed
    (checked at each ``push``), in episode order, each exactly once.
    ``drain()`` waits for and writes every record still in flight. On the
    CPU each record is written at its ``push``. A full ring (the host
    ``SINK_DEPTH`` episodes ahead of the device) waits for its oldest
    copy; ``waits`` counts those waits."""

    def __init__(self, sink, names, rows, device, offset: int):
        self.sink, self.names, self.rows = sink, tuple(names), rows
        self.offset, self.depth, self.waits = offset, SINK_DEPTH, 0
        self.cuda = torch.device(device).type == "cuda"
        self.queue = deque()          # (episode, slot) in flight, in order
        if self.cuda:
            self.ring = [torch.empty((self.depth, r.shape[1]),
                                     dtype=r.dtype, pin_memory=True)
                         for r in rows]
            self.events = [torch.cuda.Event() for _ in range(self.depth)]

    def push(self, e: int) -> None:
        """Episode ``e`` (of this run) has been issued: stream its rows."""
        if not self.cuda:
            self._write(e, [r[e] for r in self.rows])
            return
        if len(self.queue) == self.depth:
            self.events[self.queue[0][1]].synchronize()
            self.waits += 1
        self.poll()
        slot = e % self.depth
        for buf, r in zip(self.ring, self.rows):
            buf[slot].copy_(r[e], non_blocking=True)
        self.events[slot].record()
        self.queue.append((e, slot))

    def poll(self) -> None:
        while self.queue and self.events[self.queue[0][1]].query():
            self._pop()

    def drain(self) -> None:
        while self.queue:
            self.events[self.queue[0][1]].synchronize()
            self._pop()

    def _pop(self) -> None:
        e, slot = self.queue.popleft()
        self._write(e, [buf[slot] for buf in self.ring])

    def _write(self, e: int, rows) -> None:
        vals = torch.cat(rows).tolist()
        self.sink.append({"episode": self.offset + e,
                          **dict(zip(self.names, vals))})


class FleetScan:
    """The graph driver of one run (``train_fleet_scan``): the arguments
    are ``train_fleet_scan``'s. ``run()`` trains ``fleet`` in place and
    returns (fleet, history); ``step()`` runs the next episode alone,
    ``history()`` fetches the history so far and ``drain()`` writes every
    streamed record still in flight and collects the tracer's device
    stamps; ``close()`` releases the graphs (``run()`` does at its end).
    ``capture_s`` is the wall time of the graphs' captures and
    ``graph_launches`` the host's graph launches (0 on the CPU);
    ``warmed`` lists the sizes of a meshed fleet's process groups, each
    warmed by one collective before any capture."""

    def __init__(self, cfg: FCPOConfig, fleet: Fleet, traces, *,
                 learn: bool = True, federated: bool = True,
                 straggler_prob: float = 0.0, seed: int = 0,
                 env_backend=None,
                 transport: Optional[TransportConfig] = None,
                 guards: Optional[GuardConfig] = None,
                 faults: Optional[FaultConfig] = None, gumbel=None,
                 byz_noise=None, episode_offset: int = 0,
                 total_episodes: Optional[int] = None, metrics_sink=None,
                 health: Optional[HealthConfig] = None, tracer=None,
                 mesh=None):
        fleet = _placed(fleet, mesh)
        self.cfg, self.fleet, self.learn = cfg, fleet, learn
        self.health, self.tracer = health, tracer
        self.offset = episode_offset
        _ensure_health(cfg, fleet, health)
        self.backend = get_backend(env_backend)
        self.transport = DEFAULT_TRANSPORT if transport is None else transport
        self.faults, self.guards = _normalize_chaos(faults, guards)
        faults = self.faults
        dev = self.dev = fleet.pod_ids.device
        place = self.place = fleet.placement
        if (place is not None and dev.type == "cuda"
                and dist.get_backend(place.world) != "nccl"):
            raise ValueError(
                f"the graph driver captures the mesh's collectives in CUDA "
                f"graphs, which a {dist.get_backend(place.world)} process "
                f"group cannot be: use an NCCL mesh on the card, or "
                f"train_fleet_reference")
        # every group's communicator exists before the first capture
        self.warmed = [] if place is None else shd.warm_groups(place, dev)
        traces = agent_slice(traces, place)
        a, total = traces.shape
        n = cfg.n_steps
        self.n_eps = total // n
        self.schedule, avail, plan, self.rounds = _run_plan(
            cfg, fleet, self.n_eps, learn, federated, straggler_prob, seed,
            faults, episode_offset, total_episodes)
        if place is not None and place.rank != 0:
            metrics_sink = None          # rank 0 writes the stream
        # the run's inputs, staged on the device once, episode-major
        self.rates = traces[:, :self.n_eps * n].to(dev, torch.float32) \
            .reshape(a, self.n_eps, n).transpose(0, 1).contiguous()
        self.avail = torch.as_tensor(avail, device=dev)
        self.gumbel = None if gumbel is None else \
            agent_slice(gumbel, place, 1).to(dev, torch.float32).contiguous()
        self.crash_on = faults is not None and faults.crash_active
        self.byz_on = faults is not None and faults.byzantine_active
        self.part_on = faults is not None and faults.partition_active
        self.plan = rfaults.FaultPlan(*(torch.as_tensor(x, device=dev)
                                        for x in plan))
        self.byz_noise = None if byz_noise is None else \
            {k: agent_slice(v, place, 1).to(dev, torch.float32).contiguous()
             for k, v in byz_noise.items()}
        self.fault_gen = _fault_generator(fleet, faults, byz_noise)
        self.counter = torch.zeros((), dtype=torch.long, device=dev)
        self.episodes = 0     # the host's copies (rounds: of the whole run)
        f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        self.ep_hist = f32(self.n_eps, len(EPISODE_METRICS))
        self.fl_hist = f32(self.n_eps, len(fl_transport.FL_METRIC_KEYS))
        self.names = (*EPISODE_METRICS, *fl_transport.FL_METRIC_KEYS)
        self.rows = [self.ep_hist, self.fl_hist]
        if health is not None:
            self.h_hist = f32(self.n_eps, len(HEALTH_METRIC_KEYS))
            self.names += HEALTH_METRIC_KEYS
            self.rows.append(self.h_hist)
        self.tap = None if metrics_sink is None else SinkTap(
            metrics_sink, self.names, self.rows, dev, episode_offset)
        # the spans' device stamps: rows of sampled episodes of this run
        self.stamps = None if tracer is None or dev.type != "cuda" else \
            tracer.attach(dev, self.n_eps, FLEET_SITES, base=episode_offset)
        # the FL round reads the last episode's rollout from here
        self.rollout = Rollout(
            states=f32(a, n, cfg.state_dim),
            actions=torch.zeros(a, n, 3, dtype=torch.long, device=dev),
            logp_old=f32(a, n), rewards=f32(a, n), values_old=f32(a, n))
        if self.crash_on:
            # static copies of the agent state before the episode and the
            # round, and the agents down for the round
            self.prev = rfaults.snapshot_astate(fleet.astate)
            self.pre_round = rfaults.snapshot_astate(fleet.astate)
            self.down = torch.zeros(a, dtype=torch.bool, device=dev)
        noise = (fleet.generator,) if gumbel is None else ()
        self.graphs = (GraphedBody(self._episode, dev, noise),
                       GraphedBody(self._round, dev,
                                   () if self.fault_gen is None
                                   else (self.fault_gen,)),
                       GraphedBody(self._merge, dev))

    def _sites(self, after: bool = False):
        """The span sites of the current episode's bodies (``after``: the
        round and the merge, which run after the episode counter moved
        on): device stamps at the episode counter on the card, host spans
        of the host's own count on the CPU; None without a tracer."""
        if self.tracer is None:
            return None
        if self.stamps is not None:
            return obs_trace.DeviceSites(self.stamps, self.counter,
                                         self.offset - int(after))
        e = self.offset + self.episodes - int(after)
        return obs_trace.HostSites(self.tracer, self.tracer.sampled(e))

    def _episode(self):
        e = self.counter.view(1)
        with obs_trace.span_of(self._sites(), "episode"):
            if self.crash_on:
                rfaults.snapshot_astate(self.fleet.astate, into=self.prev)
            out, rollout, metrics = fleet_episode(
                self.cfg, self.fleet, self.rates.index_select(0, e)[0],
                learn=self.learn, backend=self.backend,
                gumbel=(None if self.gumbel is None
                        else self.gumbel.index_select(0, e)[0]),
                health=self.health)
            metrics, health_m = _split_health(metrics)
            if set(metrics) != set(EPISODE_METRICS):
                raise KeyError(f"episode metrics {sorted(metrics)} are not "
                               f"{sorted(EPISODE_METRICS)}")
            ran = None
            if self.crash_on:
                out, ran, down = rfaults.apply_crashes(
                    self.faults, self.prev, out,
                    self.plan.crash.index_select(0, e)[0], self.place)
                self.fleet.crash_timer.copy_(out.crash_timer)
                self.down.copy_(down)
            copy_into(self.fleet.astate, out.astate)
            copy_into(self.rollout, rollout)
            self.ep_hist.index_copy_(0, e, torch.stack(_episode_means(
                {k: metrics[k] for k in EPISODE_METRICS}, ran,
                self.place))[None])
            if self.health is not None:
                copy_into(self.fleet.health, out.health)
                self.h_hist.index_copy_(0, e, torch.stack(_episode_means(
                    health_m, ran, self.place))[None])
            self.fl_hist.index_copy_(0, e, torch.stack(
                list(fl_transport.fl_zero_metrics(self.dev).values()))[None])
        self.counter.add_(1)

    def _round(self):
        e = (self.counter - 1).view(1)
        pick = lambda x: x.index_select(0, e)[0]
        sites = self._sites(after=True)
        with obs_trace.span_of(sites, "fl_round"):
            av = pick(self.avail)
            if self.crash_on:
                av = av & ~self.down
                rfaults.snapshot_astate(self.fleet.astate,
                                        into=self.pre_round)
            out, _, flm = fl_round(
                self.cfg, self.fleet, self.rollout, av,
                transport=self.transport, guards=self.guards,
                faults=self.faults,
                byzantine=pick(self.plan.byzantine) if self.byz_on else None,
                byz_noise=(None if self.byz_noise is None else
                           {k: pick(v) for k, v in self.byz_noise.items()}),
                generator=self.fault_gen, health=self.health, trace=sites)
            if self.crash_on:
                out = out.replace(astate=rfaults.freeze_astate(
                    self.down, self.pre_round, out.astate))
            copy_into(self.fleet.astate, out.astate)
            copy_into(self.fleet.residuals, out.residuals)
            copy_into(self.fleet.pending, out.pending)
            copy_into(self.fleet.health, out.health)
            self.fl_hist.index_copy_(0, e, torch.stack(
                [flm[k] for k in fl_transport.FL_METRIC_KEYS])[None])

    def _merge(self):
        with obs_trace.span_of(self._sites(after=True), "pod_merge"):
            if not self.part_on:
                pod_merge(self.cfg, self.fleet)
                return
            e = (self.counter - 1).view(1)
            out = pod_merge(self.cfg, self.fleet,
                            self.plan.partition.index_select(0, e)[0],
                            self.faults)
            self.fleet.partition_timer.copy_(out.partition_timer)

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
        if self.tap is not None:
            self.tap.push(e)

    def drain(self) -> None:
        """Write every streamed record still in flight, and collect the
        tracer's stamps (one transfer each)."""
        if self.tap is not None:
            self.tap.drain()
        if self.tracer is not None:
            self.tracer.drain()

    def history(self) -> Dict[str, np.ndarray]:
        """The per-episode history of the episodes run so far, in one
        device->host transfer."""
        hist = torch.cat(self.rows, 1)[:self.episodes].cpu().numpy()
        return {k: hist[:, i] for i, k in enumerate(self.names)}

    def close(self) -> None:
        """Release the captured graphs (``GraphedBody.release``): a meshed
        run's graphs hold its NCCL communicators, whose destruction waits
        for them. The history, counts and fleet stay readable."""
        for g in self.graphs:
            g.release()

    def run(self):
        try:
            with full_float32():
                while self.episodes < self.n_eps:
                    self.step()
        finally:
            self.drain()
            self.close()
        return self.fleet, self.history()


def train_fleet_scan(cfg: FCPOConfig, fleet: Fleet, traces, *,
                     learn: bool = True, federated: bool = True,
                     straggler_prob: float = 0.0, seed: int = 0,
                     env_backend=None,
                     transport: Optional[TransportConfig] = None,
                     guards: Optional[GuardConfig] = None,
                     faults: Optional[FaultConfig] = None,
                     gumbel=None, byz_noise=None, episode_offset: int = 0,
                     total_episodes: Optional[int] = None,
                     metrics_sink=None,
                     health: Optional[HealthConfig] = None, tracer=None,
                     mesh=None):
    """The graph driver: episodes over ``traces`` (A, total_steps), an FL
    round every ``fl_every`` episodes (stragglers from
    ``draw_availability(seed)``), a pod merge every ``hierarchical_period``
    rounds — the JAX package's ``train_fleet_scan`` cadence. On the GPU the
    episode, the FL round and the pod merge are CUDA graphs, each captured
    right after its first (eager) step and replayed after that; a capture
    error raises. On the CPU the same bodies run eagerly. ``fleet`` is
    trained in place (its tensors are the graphs' static state) and
    returned, ``fleet.episode`` advanced by the run's episodes. ``guards``
    / ``faults``: the chaos layer, as in ``train_fleet_reference``; the
    fault plan's bits are staged on the device with the other inputs, and
    the agent state before an episode and a round is copied into static
    tensors only when crashes are on. ``gumbel``: optional pre-drawn action
    noise (n_episodes, A, n_steps, ``agent.noise_width(cfg)``); without it
    the noise comes from ``fleet.generator`` in the reference driver's
    order.
    ``byz_noise``: optional byzantine noise, {name: (n_episodes, A, ...)}.
    ``episode_offset`` / ``total_episodes``: as in
    ``train_fleet_reference`` (a resumed run's absolute episodes).
    ``env_backend``: the backend the fleet was built with. ``health``: the
    health observatory in the episode and FL-round graphs (the fleet's
    state, fresh if it has none, is part of their static state; the
    summaries join the history). ``metrics_sink``: one record per episode,
    streamed behind the replays (``SinkTap``), all written before the call
    returns. ``tracer``: a ``repro_torch.obs.trace.Tracer``: spans
    ``episode``, ``fl_round`` (with its phases ``fl/uplink``,
    ``fl/encode``, ``kernel/delta_codec``, ``fl/aggregate``,
    ``fl/finetune``) and ``pod_merge`` on every
    ``tracer.span_sample_every``-th absolute episode: on the card a
    ``span_stamp`` node at each end inside the graphs (the episode and
    the period read from device memory), on the CPU host spans; drained
    before the call returns. Without it the bodies dispatch what they
    dispatch untraced. ``mesh``: as in ``train_fleet_reference``; on the
    card the graphs capture the mesh's NCCL collectives, and a gloo mesh
    there raises (it cannot be captured). Float32 products
    run without TF32 for the run. Returns (fleet, history) with one
    fleet-mean float32 value per episode and metric (FL metrics 0 on
    episodes without a round), fetched in one transfer."""
    return FleetScan(cfg, fleet, traces, learn=learn, federated=federated,
                     straggler_prob=straggler_prob, seed=seed,
                     env_backend=env_backend, transport=transport,
                     guards=guards, faults=faults, gumbel=gumbel,
                     byz_noise=byz_noise, episode_offset=episode_offset,
                     total_episodes=total_episodes, metrics_sink=metrics_sink,
                     health=health, tracer=tracer, mesh=mesh).run()


def train_fleet(cfg: FCPOConfig, fleet: Fleet, traces, *, learn: bool = True,
                federated: bool = True, straggler_prob: float = 0.0,
                seed: int = 0, env_backend=None,
                transport: Optional[TransportConfig] = None,
                guards: Optional[GuardConfig] = None,
                faults: Optional[FaultConfig] = None, gumbel=None,
                byz_noise=None, episode_offset: int = 0,
                total_episodes: Optional[int] = None, metrics_sink=None,
                health: Optional[HealthConfig] = None, tracer=None,
                mesh=None):
    """The default entry point: delegates to ``train_fleet_scan``, as the
    JAX package's ``train_fleet`` does."""
    return train_fleet_scan(cfg, fleet, traces, learn=learn,
                            federated=federated,
                            straggler_prob=straggler_prob, seed=seed,
                            env_backend=env_backend, transport=transport,
                            guards=guards, faults=faults, gumbel=gumbel,
                            byz_noise=byz_noise,
                            episode_offset=episode_offset,
                            total_episodes=total_episodes,
                            metrics_sink=metrics_sink, health=health,
                            tracer=tracer, mesh=mesh)
