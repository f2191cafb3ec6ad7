"""FL communication model: payload accounting, uplink times, round deadlines.

Port of ``repro.fl.transport``. Per-leaf encoded sizes for the three
codecs — float32 (4 B/param), int8 (1 B/param + one float32 scale per
tensor), top-k (8 B per kept coordinate) — set a client's upload time
``payload_bits / bandwidth``; with a round deadline a slow link misses the
round, or, in asynchronous rounds, parks its delta for a later round
(``repro_torch.fl.staleness``). The float32 downlink is a per-agent unicast
of full parameters; the compressed codecs broadcast one encoded base delta
per pod.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable

import torch

from repro_torch.kernels.ref import DELTA_CODECS

CODECS = DELTA_CODECS


@dataclass(frozen=True)
class TransportConfig:
    """codec: on-wire delta encoding (``float32`` is lossless). topk_frac:
    fraction of coordinates the top-k codec keeps per tensor. deadline_s:
    round deadline in seconds; <= 0 disables it. async_rounds: a selected
    client that misses the deadline parks its decoded delta and joins a
    later round discounted by ``staleness_decay ** staleness``."""
    codec: str = "float32"
    topk_frac: float = 0.05
    deadline_s: float = 0.0
    async_rounds: bool = False
    staleness_decay: float = 0.5

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(f"unknown codec {self.codec!r}; expected one "
                             f"of {CODECS}")
        if not (0.0 < self.topk_frac <= 1.0):
            raise ValueError("topk_frac must be in (0, 1]")

    @property
    def plain(self) -> bool:
        """Lossless codec and nothing parked: the server's ``base +
        decode(encode(params - base))`` is identically ``params``, so the
        codec is skipped."""
        return self.codec == "float32" and not self.async_rounds


DEFAULT_TRANSPORT = TransportConfig()


def topk_k(size: int, frac: float) -> int:
    """Per-tensor top-k budget: ceil(frac * size), at least 1."""
    return max(1, int(math.ceil(frac * size)))


def leaf_payload_bytes(size: int, codec: str, topk_frac: float) -> float:
    if codec == "float32":
        return 4.0 * size
    if codec == "int8":
        return float(size) + 4.0          # int8 values + one float32 scale
    if codec == "topk":
        return 8.0 * topk_k(size, topk_frac)   # float32 value + int32 index
    raise ValueError(f"unknown codec {codec!r}")


def _leaf_sizes(params: Iterable[torch.Tensor]):
    """Per-agent sizes of stacked (A, ...) leaves."""
    return [math.prod(p.shape[1:]) for p in params]


def agent_payload_bytes(params: Iterable[torch.Tensor],
                        transport: TransportConfig) -> float:
    """Encoded uplink bytes for ONE agent's delta (stacked leaves)."""
    return sum(leaf_payload_bytes(s, transport.codec, transport.topk_frac)
               for s in _leaf_sizes(params))


def full_param_bytes(params: Iterable[torch.Tensor]) -> float:
    """Raw float32 size of one agent's parameters."""
    return 4.0 * sum(_leaf_sizes(params))


def downlink_bytes(transport: TransportConfig, n_agents: int, n_pods: int,
                   up_bytes: float, full_bytes: float) -> float:
    """Server->client bytes per round: per-agent unicast of full params
    (float32) or one encoded base-delta broadcast per pod."""
    if transport.codec == "float32":
        return n_agents * full_bytes
    return n_pods * up_bytes


def uplink_seconds(payload_bytes: float, bandwidth_mbps) -> torch.Tensor:
    """(A,) upload time of one encoded delta over each agent's link."""
    return payload_bytes * 8.0 / (torch.clamp_min(bandwidth_mbps, 1e-6) * 1e6)


def on_time_mask(uplink_s, deadline_s: float) -> torch.Tensor:
    """(A,) bool: the upload fits inside the round deadline."""
    if deadline_s <= 0:
        return torch.ones(uplink_s.shape, dtype=torch.bool,
                          device=uplink_s.device)
    return uplink_s <= deadline_s


FL_METRIC_KEYS = ("fl_payload_bytes", "fl_uplink_s", "fl_missed",
                  "fl_stale_used", "fl_rejected", "fl_clipped")


def fl_zero_metrics(device) -> Dict[str, torch.Tensor]:
    """The all-zeros FL metrics of an episode without a round (the same
    keys as ``fl_round`` returns, so histories stay rectangular)."""
    return {k: torch.zeros((), device=device) for k in FL_METRIC_KEYS}

