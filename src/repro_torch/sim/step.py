"""Interval advance: the twin's data plane for one K-microtick interval.

Port of ``repro.sim.step``. ``sim_interval`` advances the whole fleet one
control interval through ``kernels.queue_advance``: one K3 launch for
CUDA tensors, its plain version (``queue_advance_ref``) for CPU tensors.
The recorded advance is K3's recording instantiation on the card (the JAX
package records on its jnp path only; the port's card has one data plane,
K3). The single-agent entry points take one agent's unbatched state:
``sim_interval_ref`` is the plain version on any device (the oracle),
``sim_interval_agent`` the same advance through K3 at A=1 on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.queue_advance import queue_advance
from repro_torch.kernels.ref import queue_advance_ref
from repro_torch.sim.state import SimState


def _one_agent(advance, state: SimState, arrivals, caps) -> SimState:
    out = advance(*(x[None] for x in state.tensors()), arrivals[None],
                  caps[None])
    return SimState(*(x[0] for x in out))


def sim_interval_ref(state: SimState, arrivals: torch.Tensor,
                     caps: torch.Tensor) -> SimState:
    """Advance ONE agent k_ticks microticks through the plain version, on
    whatever device its tensors lie. state: one agent's tensors ((R,),
    (SIM_NCOUNTERS,), (2,), (), (H,)); arrivals: (K,) int32; caps:
    (SIM_NCAPS,) float32 (one action decode held for the interval)."""
    return _one_agent(queue_advance_ref, state, arrivals, caps)


def sim_interval_agent(state: SimState, arrivals: torch.Tensor,
                       caps: torch.Tensor) -> SimState:
    """``sim_interval_ref``'s advance through ``kernels.queue_advance``:
    one K3 launch at A=1 for CUDA tensors, the plain version for CPU
    tensors."""
    return _one_agent(queue_advance, state, arrivals, caps)


def sim_interval(state: SimState, arrivals: torch.Tensor,
                 caps: torch.Tensor) -> SimState:
    """Fleet-batched advance: state tensors (A, ...), arrivals (A, K) int32,
    caps (A, SIM_NCAPS) float32 (one action decode held for the
    interval). Returns the new state; ``state`` is left as it was."""
    return SimState(*queue_advance(*state.tensors(), arrivals, caps))


def sim_interval_recorded(state: SimState, arrivals: torch.Tensor,
                          caps: torch.Tensor):
    """``sim_interval`` that also returns the counters after every
    microtick, (A, K, SIM_NCOUNTERS) int32 — the request-attribution tap
    (``repro_torch.obs.requests`` rebuilds per-request stage stamps from
    these monotone series). The state it returns is ``sim_interval``'s bit
    for bit. Fleet-batched: the reference's single-agent function under
    ``vmap``."""
    *out, ticks = queue_advance(*state.tensors(), arrivals, caps,
                                record=True)
    return SimState(*out), ticks
