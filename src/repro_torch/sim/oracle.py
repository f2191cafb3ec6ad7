"""Host-side discrete-event oracle for the tensorized twin.

Port of ``repro.sim.oracle``. Mirrors ``kernels.ref.sim_microtick``
request for request with the plain Python data-plane classes of
``serving/slo.py`` (``BoundedQueue`` / ``Request`` / ``SLOTracker``): the
reference the twin is held against, and the host-loop baseline a twin
benchmark times. All times are in MICROTICKS (the tracker's ``slo_s`` is
the deadline in ticks), so with integer-representable service capacities
the two agree exactly: same completions, drops and effective throughput.
Host Python and numpy only, no tensors.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.kernels.ref import (CAP_BATCH, CAP_POST, CAP_PRE, CAP_QCAP,
                                     CAP_SLO, CAP_TBATCH)
from repro_torch.serving.slo import BoundedQueue, Request, SLOTracker
from repro_torch.sim.state import SimParams


def simulate_python_agent(arrivals: np.ndarray, caps: np.ndarray,
                          sp: SimParams) -> Dict[str, float]:
    """One agent through the Python data plane. arrivals: (T, K) int
    per-tick arrival counts; caps: (T, SIM_NCAPS) float (one action decode
    per control interval; queue_cap and slo must be constant — they are
    device properties, not actions). Returns the same request totals the
    twin accumulates."""
    arrivals = np.asarray(arrivals)
    caps = np.asarray(caps, np.float64)
    qcap = int(caps[0, CAP_QCAP])
    slo_ticks = int(caps[0, CAP_SLO])

    pre = BoundedQueue(capacity=qcap)
    ready: List[Request] = []       # batch-formation queue
    in_service: List[Request] = []  # the one in-flight inference batch
    post: List[Request] = []
    tracker = SLOTracker(slo_s=slo_ticks)
    busy, done_at = False, 0
    pre_credit = post_credit = 0.0
    rid, m = 0, 0

    for t in range(arrivals.shape[0]):
        c_pre, c_post = caps[t, CAP_PRE], caps[t, CAP_POST]
        batch_slots = int(caps[t, CAP_BATCH])
        t_batch = int(caps[t, CAP_TBATCH])
        for j in range(arrivals.shape[1]):
            # (1) inference completion -> post queue
            if busy and m >= done_at:
                post.extend(in_service)
                in_service, busy = [], False
            # (2) post-processing completes the n oldest
            post_credit = min(post_credit + c_post, c_post + 1.0)
            n = min(int(post_credit), len(post))
            if n:
                tracker.complete(post[:n], now=m + 1)
                post = post[n:]
            post_credit -= n
            # (3) batch launch, backpressured by post room
            if not busy:
                room = qcap - (len(post) + len(in_service))
                nl = min(len(ready), batch_slots, room)
                if nl > 0:
                    in_service, ready = ready[:nl], ready[nl:]
                    busy, done_at = True, m + t_batch
            # (4) pre-processing, backpressured by batch-formation room
            pre_credit = min(pre_credit + c_pre, c_pre + 1.0)
            n = min(int(pre_credit), len(pre), max(qcap - len(ready), 0))
            ready.extend(pre.pop_batch(n))
            pre_credit -= n
            # (5) admission; BoundedQueue counts the drops
            for _ in range(int(arrivals[t, j])):
                pre.push(Request(rid, arrival_t=m))
                rid += 1
            m += 1

    eff = sum(1 for _, lat, _ in tracker.completed if lat <= slo_ticks)
    return {
        "arrived": rid,
        "dropped": pre.drops,
        "completed": len(tracker.completed),
        "effective": eff,
        "lat_sum": float(sum(lat for _, lat, _ in tracker.completed)),
        "in_flight": len(pre.q) + len(ready) + len(in_service) + len(post),
        "effective_throughput": eff / max(m * sp.dt, 1e-9),
    }


def simulate_python_fleet(arrivals: np.ndarray, caps: np.ndarray,
                          sp: SimParams) -> List[Dict[str, float]]:
    """A agents one after another through the Python oracle (the baseline
    cost model: host-side per-agent loops). arrivals: (A, T, K); caps:
    (A, T, SIM_NCAPS)."""
    return [simulate_python_agent(arrivals[i], caps[i], sp)
            for i in range(arrivals.shape[0])]
