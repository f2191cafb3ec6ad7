"""Interval advance: the twin's data plane for one K-microtick interval.

Port of ``repro.sim.step.sim_interval``. One call advances the whole fleet
one control interval through ``kernels.queue_advance``: one K3 launch for
CUDA tensors, its plain version (``queue_advance_ref``) for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.queue_advance import queue_advance
from repro_torch.sim.state import SimState


def sim_interval(state: SimState, arrivals: torch.Tensor,
                 caps: torch.Tensor) -> SimState:
    """Fleet-batched advance: state tensors (A, ...), arrivals (A, K) int32,
    caps (A, SIM_NCAPS) float32 (one action decode held for the
    interval). Returns the new state; ``state`` is left as it was."""
    return SimState(*queue_advance(*state.tensors(), arrivals, caps))
