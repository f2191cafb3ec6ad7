"""Request queue + SLO (deadline) accounting for the serving data plane.

A straight copy of ``repro.serving.slo`` (host Python, no arrays). Mirrors
the paper's metrics: *throughput* (results/s), *effective throughput*
(results that met their end-to-end SLO), queue drops from bounded queues,
and per-request end-to-end latency.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple


@dataclass
class Request:
    rid: int
    arrival_t: float
    size: int = 1           # objects in the frame (paper: objects analyzed)
    done_t: Optional[float] = None

    def latency(self) -> Optional[float]:
        return None if self.done_t is None else self.done_t - self.arrival_t


@dataclass
class BoundedQueue:
    """Bounded FIFO; arrivals beyond capacity are dropped (paper: queue drops,
    part of the iAgent state vector)."""
    capacity: int = 64
    q: Deque[Request] = field(default_factory=deque)
    drops: int = 0

    def push(self, r: Request) -> bool:
        if len(self.q) >= self.capacity:
            self.drops += 1
            return False
        self.q.append(r)
        return True

    def pop_batch(self, n: int) -> List[Request]:
        out = []
        while self.q and len(out) < n:
            out.append(self.q.popleft())
        return out

    def __len__(self):
        return len(self.q)


@dataclass
class SLOTracker:
    slo_s: float = 0.25  # paper: 250 ms end-to-end
    completed: List[Tuple[float, float, int]] = field(default_factory=list)
    # (done_t, latency, size)

    def complete(self, reqs: List[Request], now: float):
        for r in reqs:
            r.done_t = now
            self.completed.append((now, r.latency(), r.size))

    def window(self, now: float, horizon: float = 1.0):
        """(throughput, effective_throughput, mean_latency) over the last
        ``horizon`` seconds."""
        recent = [(t, l, s) for (t, l, s) in self.completed if now - t <= horizon]
        if not recent:
            return 0.0, 0.0, 0.0
        thr = sum(s for _, _, s in recent) / horizon
        eff = sum(s for _, l, s in recent if l <= self.slo_s) / horizon
        lat = sum(l for _, l, _ in recent) / len(recent)
        return thr, eff, lat
