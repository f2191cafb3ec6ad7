"""Deterministic fault injection for the fleet drivers.

Port of ``repro.resilience.faults``. Three fault families:

* **Agent crashes** — an agent goes down for ``crash_recovery`` episodes:
  its whole agent state is frozen (params and optimizer zeroed at the
  crash), it leaves episode training and Eq. 7 selection, and on expiry it
  rejoins by the paper's step-① warm start: params <- its pod's base
  network, optimizer zeroed.
* **Byzantine clients** — a client's *decoded* delta is corrupted after
  the codec (sign flip, scaled noise or NaN), on the server's side of the
  wire, so it composes with every codec and with error feedback.
* **Pod partitions** — a partitioned pod skips the cross-pod merge for
  ``partition_merges`` merge events, then rejoins.

``draw_fault_plan`` draws every fault bit on the host from one
``numpy.random.default_rng(seed)`` in the JAX package's order, so the plan
is the JAX package's bit for bit. The ``noise`` mode is the exception the
port cannot reproduce (JAX draws it with threefry): ``corrupt_deltas``
takes pre-drawn noise, or draws from a ``torch.Generator`` seeded by
``faults.seed``.

The port's policy is updated in place, so the driver keeps the agent
state from before an episode (or a round) as an ``AgentSnapshot``; the
functions below select per agent between it and the new state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.crl import AgentState
from repro_torch.core.dtypes import tree_map
from repro_torch.core.graphs import copy_into
from repro_torch.distributed.sharding import agent_slice, pod_allgather

BYZANTINE_MODES = ("sign_flip", "noise", "nan")


@dataclass(frozen=True)
class FaultConfig:
    """The fault model: per-draw Bernoulli rates; ``seed`` seeds the plan
    (and the port's byzantine noise). See ``repro.resilience.faults``."""
    crash_prob: float = 0.0
    crash_recovery: int = 2
    crash_zero_params: bool = True
    byzantine_frac: float = 0.0
    byzantine_mode: str = "sign_flip"
    byzantine_scale: float = 10.0
    partition_prob: float = 0.0
    partition_merges: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.byzantine_mode not in BYZANTINE_MODES:
            raise ValueError(f"unknown byzantine_mode "
                             f"{self.byzantine_mode!r}; expected one of "
                             f"{BYZANTINE_MODES}")
        for name in ("crash_prob", "byzantine_frac", "partition_prob"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.crash_recovery < 1:
            raise ValueError("crash_recovery must be >= 1")
        if self.partition_merges < 1:
            raise ValueError("partition_merges must be >= 1")

    @property
    def crash_active(self) -> bool:
        return self.crash_prob > 0.0

    @property
    def byzantine_active(self) -> bool:
        return self.byzantine_frac > 0.0

    @property
    def partition_active(self) -> bool:
        return self.partition_prob > 0.0

    @property
    def active(self) -> bool:
        return (self.crash_active or self.byzantine_active
                or self.partition_active)


NO_FAULTS = FaultConfig()


class FaultPlan(NamedTuple):
    """Host-side pre-drawn fault bits, one row per episode."""
    crash: np.ndarray      # (n_eps, A) bool — crash fires after episode e
    byzantine: np.ndarray  # (n_eps, A) bool — corrupt upload in round e
    partition: np.ndarray  # (n_eps, P) bool — pod drops at a merge in ep e


def draw_fault_plan(schedule, n_agents: int, n_pods: int,
                    faults: Optional[FaultConfig]) -> FaultPlan:
    """The whole run's fault bits from ``faults.seed``: per episode the
    crash bits (every episode when crashes are on), then the byzantine and
    partition bits (FL episodes only)."""
    n = len(schedule)
    crash = np.zeros((n, n_agents), bool)
    byz = np.zeros((n, n_agents), bool)
    part = np.zeros((n, n_pods), bool)
    if faults is not None and faults.active:
        rng = np.random.default_rng(faults.seed)
        for e in range(n):
            if faults.crash_active:
                crash[e] = rng.random(n_agents) < faults.crash_prob
            if schedule[e]:
                if faults.byzantine_active:
                    byz[e] = rng.random(n_agents) < faults.byzantine_frac
                if faults.partition_active:
                    part[e] = rng.random(n_pods) < faults.partition_prob
    return FaultPlan(crash, byz, part)


@dataclass
class AgentSnapshot:
    """The agent state at one moment: params (the policy's, detached),
    optimizer, buffer and environment state."""
    params: Dict[str, torch.Tensor]
    opt: Any
    buffer: Any
    env_state: Any


def _rows(m, leaf):
    return m.reshape((-1,) + (1,) * (leaf.dim() - 1))


def snapshot_astate(astate: AgentState, into: Optional[AgentSnapshot] = None
                    ) -> AgentSnapshot:
    """A copy of ``astate``: new tensors, or copied into the tensors of
    ``into`` (a driver's static snapshot)."""
    now = AgentSnapshot({k: v.detach() for k, v in
                         astate.policy.params().items()},
                        astate.opt, astate.buffer, astate.env_state)
    if into is None:
        return tree_map(torch.clone, now)
    copy_into(into, now)
    return into


def _where(m, old, new):
    return tree_map(lambda o, n: torch.where(_rows(m, n), o, n), old, new)


def _zero_where(m, tree):
    return tree_map(lambda o: torch.where(_rows(m, o), 0, o), tree)


def freeze_astate(down, old: AgentSnapshot, new: AgentState) -> AgentState:
    """A down agent keeps its whole state from ``old`` (its episode or
    round still ran; the results are discarded here). The policy is
    updated in place."""
    params = {k: v.detach() for k, v in new.policy.params().items()}
    new.policy.assign(_where(down, old.params, params))
    return AgentState(new.policy, _where(down, old.opt, new.opt),
                      _where(down, old.buffer, new.buffer),
                      _where(down, old.env_state, new.env_state))


def apply_crashes(faults: FaultConfig, prev: AgentSnapshot, fleet,
                  crash_now, place=None):
    """The crash state machine past one episode (run after the episode):
    agents down at its start get their state from ``prev`` back; timers
    age, and an agent whose window ends rejoins warm-started from its pod's
    base network with a zeroed optimizer; fresh ``crash_now`` draws take
    an agent down for ``crash_recovery`` episodes (params and optimizer
    zeroed when ``crash_zero_params``). Returns ``(fleet, ran, down)``:
    ``ran`` marks the agents whose episode counts in the metrics, ``down``
    those that sit out the FL round that may follow. ``place``: a meshed
    fleet's placement; the warm start reads the all-gathered base
    networks."""
    timer = fleet.crash_timer
    was_down = timer > 0
    astate = freeze_astate(was_down, prev, fleet.astate)

    timer = torch.clamp_min(timer - 1, 0)
    rejoin = was_down & (timer == 0)
    base = {k: pod_allgather(v.detach(), place)
            for k, v in fleet.base.params().items()}
    params = {k: torch.where(_rows(rejoin, v), base[k][fleet.pod_ids],
                             v.detach())
              for k, v in astate.policy.params().items()}
    opt = _zero_where(rejoin, astate.opt)
    new_crash = crash_now & (timer == 0)
    if faults.crash_zero_params:
        params = _zero_where(new_crash, params)
        opt = _zero_where(new_crash, opt)
    timer = torch.where(new_crash, faults.crash_recovery, timer)
    astate.policy.assign(params)
    astate = AgentState(astate.policy, opt, astate.buffer, astate.env_state)
    return fleet.replace(astate=astate, crash_timer=timer), ~was_down, \
        timer > 0


def corrupt_deltas(faults: FaultConfig, decoded: Dict[str, torch.Tensor],
                   byzantine, noise: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None, place=None):
    """Corrupt the decoded deltas of the agents in ``byzantine`` (the
    server's side of the wire). The ``noise`` mode adds
    ``byzantine_scale`` times ``noise[name]`` (pre-drawn, the shape of each
    leaf) or, without it, standard normal draws from ``generator`` (every
    leaf, every agent, in the dict's order; under a meshed fleet's
    placement ``place`` every agent of the whole fleet, this rank's rows
    kept)."""
    mode, scale = faults.byzantine_mode, faults.byzantine_scale
    out = {}
    for k, d in decoded.items():
        if mode == "sign_flip":
            bad = -scale * d
        elif mode == "noise":
            rows = d.shape[:1] if place is None else (place.n_agents,)
            z = noise[k] if noise is not None else agent_slice(torch.randn(
                rows + d.shape[1:], generator=generator, device=d.device),
                place)
            bad = d + scale * z
        else:  # nan — a poisoned upload
            bad = torch.full_like(d, torch.nan)
        out[k] = torch.where(_rows(byzantine, d), bad, d)
    return out
