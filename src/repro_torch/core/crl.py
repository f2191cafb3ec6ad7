"""Continual RL driver (§IV-C): episode rollout + gated online update.

Port of ``repro.core.crl`` over the stacked fleet. ``run_episode`` steps
``n_steps`` control intervals for all agents at once (observe -> sample
cascaded actions -> env step; a Python loop takes the place of
``lax.scan``), then ingests the episode's candidates into the diversity
buffers with ONE ``buffer_insert_batch`` call (one K1 launch on the GPU).
``crl_episode`` adds the gated online update.

``run_episode_reference`` is the seed episode loop kept as the
equivalence oracle: the same steps with a recompute-oracle buffer insert
(``buffer_insert_reference``) inside the loop, one candidate per step.

The policy module is updated in place (``AgentPolicy.assign``); the other
state is returned as new tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core import env as env_mod
from repro_torch.core.dtypes import tree_cast_like, tree_f32
from repro_torch.core.agent import ActionMask, AgentPolicy, sample_actions
from repro_torch.core.backends import FLUID
from repro_torch.core.buffer import (DiversityBuffer, buffer_insert_batch,
                                     buffer_insert_reference)
from repro_torch.core.ppo import Rollout, agent_update

INFO_METRICS = ("throughput", "effective_throughput", "latency", "drops",
                "accuracy_proxy")
# the (A,) metrics ``crl_episode`` returns, learning or not
EPISODE_METRICS = ("reward", *INFO_METRICS, "loss", "l_p", "l_v", "l_pen",
                   "gated", "update_rejected")


@dataclass
class AgentState:
    policy: AgentPolicy
    opt: Any                 # {"m": {...}, "v": {...}, "t": (A,) int32}
    buffer: DiversityBuffer
    env_state: Any           # the backend's state: EnvState or TwinEnvState


def _steps(cfg, ep, astate: AgentState, rates, mask, backend, gumbel,
           generator, buffer=None, place=None):
    """The episode's control steps for every agent: observe -> sample ->
    env step. Returns (the per-step outputs stacked to (A, T, ...), the
    final env state, and ``buffer`` with each step's candidates inserted
    through the recompute oracle, or None without one)."""
    params = astate.policy.params()
    est = astate.env_state
    # env params are read in float32 once an episode; the stepped env state
    # is stored back at the carry's dtypes (identities under float32)
    ep = tree_f32(ep)
    ys = {k: [] for k in ("obs", "actions", "logp", "rewards", "values",
                          "probs", *INFO_METRICS)}
    for t in range(rates.shape[1]):
        rate = rates[:, t]
        obs = backend.observe(cfg, ep, est, rate)
        actions, logp, out = sample_actions(
            cfg, params, obs, mask,
            gumbel=None if gumbel is None else gumbel[:, t],
            generator=generator, place=place)
        est2, reward, info = backend.step(cfg, ep, est, actions, rate)
        est = tree_cast_like(est2, est)
        probs = torch.cat([out["res"].exp(), out["bs"].exp(),
                           out["mt"].exp()], dim=-1)
        if buffer is not None:
            buffer = buffer_insert_reference(cfg, buffer, obs, actions, logp,
                                             reward, out["value"], probs)
        for k, v in (("obs", obs), ("actions", actions), ("logp", logp),
                     ("rewards", reward), ("values", out["value"]),
                     ("probs", probs)):
            ys[k].append(v)
        for k in INFO_METRICS:
            ys[k].append(info[k])
    return {k: torch.stack(v, dim=1) for k, v in ys.items()}, est, buffer


def _outputs(ys):
    """(the rollout, the (A,) episode metrics) of ``_steps``' outputs."""
    rollout = Rollout(states=ys["obs"], actions=ys["actions"],
                      logp_old=ys["logp"], rewards=ys["rewards"],
                      values_old=ys["values"])
    metrics = {"reward": ys["rewards"].mean(-1),
               **{k: ys[k].mean(-1) for k in INFO_METRICS}}
    return rollout, metrics


def run_episode(cfg: FCPOConfig, ep: env_mod.EnvParams, astate: AgentState,
                rates: torch.Tensor, mask: ActionMask, backend=FLUID,
                gumbel=None, generator=None, health: bool = False,
                place=None
                ) -> Tuple[AgentState, Rollout, Dict[str, torch.Tensor]]:
    """Collect one episode for every agent (rates: (A, n_steps) arrivals
    per interval). ``gumbel`` ((A, n_steps, ``noise_width(cfg)``)) is
    pre-drawn action noise; without it the noise comes from
    ``generator`` (``place``: a meshed fleet's placement, as
    ``sample_actions`` takes it).
    ``health`` adds a ``"_health"`` entry of raw per-interval telemetry
    for the health observatory ((A, T) reward, SLO-miss rate and arrival
    rate, (A, T, K) action marginals); every other output is unchanged."""
    with torch.no_grad():
        ys, est, _ = _steps(cfg, ep, astate, rates, mask, backend, gumbel,
                            generator, place=place)
        buffer = buffer_insert_batch(cfg, astate.buffer, ys["obs"],
                                     ys["actions"], ys["logp"],
                                     ys["rewards"], ys["values"],
                                     ys["probs"])
    rollout, metrics = _outputs(ys)
    if health:
        thr = ys["throughput"]
        miss = (thr - ys["effective_throughput"]) / torch.clamp_min(thr, 1e-9)
        metrics["_health"] = {"reward": ys["rewards"], "miss": miss,
                              "probs": ys["probs"], "rate": rates}
    new_state = AgentState(astate.policy, astate.opt, buffer, est)
    return new_state, rollout, metrics


def run_episode_reference(cfg: FCPOConfig, ep: env_mod.EnvParams,
                          astate: AgentState, rates: torch.Tensor,
                          mask: ActionMask, backend=FLUID, gumbel=None,
                          generator=None
                          ) -> Tuple[AgentState, Rollout,
                                     Dict[str, torch.Tensor]]:
    """The seed episode loop, ``run_episode``'s equivalence oracle: the
    same steps, each step's candidates inserted by
    ``buffer_insert_reference`` inside the loop (the covariance rebuilt
    and solved per candidate). Arguments and outputs as
    ``run_episode``'s, without health."""
    with torch.no_grad():
        ys, est, buffer = _steps(cfg, ep, astate, rates, mask, backend,
                                 gumbel, generator, buffer=astate.buffer)
    rollout, metrics = _outputs(ys)
    return AgentState(astate.policy, astate.opt, buffer, est), rollout, \
        metrics


def crl_episode(cfg: FCPOConfig, ep: env_mod.EnvParams, astate: AgentState,
                rates: torch.Tensor, mask: ActionMask, learn: bool = True,
                backend=FLUID, gumbel=None, generator=None,
                health: bool = False, place=None
                ) -> Tuple[AgentState, Rollout, Dict[str, torch.Tensor]]:
    """Episode + gated online update (the CRL inner loop). Metrics are
    (A,) tensors (``health``: plus ``run_episode``'s telemetry)."""
    astate, rollout, metrics = run_episode(cfg, ep, astate, rates, mask,
                                           backend=backend, gumbel=gumbel,
                                           generator=generator,
                                           health=health, place=place)
    a = rates.shape[0]
    if learn:
        params, opt, lm = agent_update(cfg, astate.policy.params(),
                                       astate.opt, rollout, mask)
        astate.policy.assign(params)
        astate = AgentState(astate.policy, opt, astate.buffer,
                            astate.env_state)
        metrics.update(lm)
    else:
        zero = torch.zeros(a, device=rates.device)
        metrics.update(loss=zero, l_p=zero, l_v=zero, l_pen=zero,
                       gated=torch.ones_like(zero), update_rejected=zero)
    return astate, rollout, metrics
