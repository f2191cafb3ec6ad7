"""Environment backends — the fluid MDP behind the backend interface.

Port of ``repro.core.backends``: an ``EnvBackend`` is the environment
contract of the CRL loop (``init`` / ``observe`` / ``step`` over the whole
fleet's (A,)-batched state). Only ``FluidBackend`` is ported; the
request-level twin is a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core import env as env_mod


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


FLUID = FluidBackend()
